"""Multi-host (DCN) execution helpers.

The reference is strictly single-host (SURVEY.md §2c: "no NCCL/MPI/Gloo");
the framework's scale-out axis spans N >= 2 hosts: the
``stream``/``time`` mesh of parallel/scanner_sharded.py laid out across
processes, with JAX inserting network collectives between hosts and NVLink
(NCCL) collectives within a host.

These helpers wrap the three multi-process chores:
  - ``initialize``: jax.distributed.initialize with explicit coordinator
    (idempotent guard for tests);
  - ``global_mesh``: a Mesh over ALL processes' devices (jax.devices() is
    global after initialize);
  - ``make_global_array`` / ``globalize_pytree``: build globally-sharded
    jax.Arrays from per-host NumPy data (each process materializes only its
    addressable shards) — the multi-host input path for IQ blocks and the
    carried-state pytree.

Verified by tests/test_multihost.py: a real 2-process CPU run over
localhost DCN, sharded == unsharded.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_initialized = False


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """jax.distributed.initialize with an idempotence guard."""
    global _initialized
    if _initialized:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True


def global_mesh(n_stream: int, n_time: int,
                axis_names=("stream", "time")) -> Mesh:
    """Mesh over the global device list (call after initialize()).

    Layout convention: the time axis varies fastest, so one stream's
    time-shards land on consecutive devices (intra-host where possible)
    and distinct streams map across hosts (DCN-friendly data parallelism) —
    the SURVEY §2c plan.
    """
    devices = np.asarray(jax.devices())
    assert devices.size >= n_stream * n_time, (
        f"need {n_stream * n_time} devices, have {devices.size}")
    return Mesh(devices[: n_stream * n_time].reshape(n_stream, n_time),
                axis_names)


def make_global_array(mesh: Mesh, spec: P, host_data: np.ndarray):
    """Globally-sharded jax.Array from (replicated) per-host NumPy data.

    Every process passes the SAME logical array; each materializes only the
    shards it addresses.  For big per-host-distinct inputs, slice
    ``host_data`` per process before calling.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_data.shape, sharding, lambda idx: host_data[idx])


def globalize_pytree(mesh: Mesh, specs, tree):
    """Map make_global_array over a pytree of (spec, host-array) pairs."""
    return jax.tree.map(
        lambda s, leaf: make_global_array(mesh, s, np.asarray(leaf)),
        specs, tree)
