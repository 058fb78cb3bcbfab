"""Dispatch fusion: run S block steps in ONE jitted call via lax.scan.

Every chain in the framework is a pure block step
``(state, x, *args) -> (state', out)`` (CLAUDE.md conventions).  At
small block sizes the per-dispatch host/runtime cost can dominate a
step, so streaming drivers may fuse S consecutive blocks into one
dispatch.
The scan carries the state pytree, keeping the FSM and every filter history
sequential across blocks — every integer/boolean decision is exactly equal
to S single steps, floats to f32 rounding (the scan body compiles with
different fusion/FMA choices than the standalone step, ~1 ulp;
tests/test_multistep.py).  This is the device-side answer to the
reference's per-chunk loop overhead (src/sdr_pmr446.c:788-790): the
compiler pipelines the S iterations on device instead of the host paying
per-block round trips.
"""

from __future__ import annotations

import jax


def _flatten_leading(v: jax.Array) -> jax.Array:
    """[S, K, ...] -> [S*K, ...]: megastep outputs in single-step layout."""
    return v.reshape((v.shape[0] * v.shape[1],) + v.shape[2:])


def fused_steps(step_impl, donate: bool = True):
    """Wrap a block step into a jitted S-blocks-per-dispatch megastep.

    ``step_impl(state, x, *args) -> (state', out)`` becomes
    ``fused(state, xs[S, ...], *args) -> (state', out_flat)`` where every
    output leaf is flattened from [S, k, ...] to [S*k, ...] — the
    concatenation, in order, of the S per-step outputs.  ``*args`` are
    broadcast to every step (runtime params).
    """

    def impl(state, xs, *args):
        def body(st, x):
            return step_impl(st, x, *args)

        state, outs = jax.lax.scan(body, state, xs)
        return state, jax.tree.map(_flatten_leading, outs)

    return jax.jit(impl, donate_argnums=(0,) if donate else ())


def _flatten_stream_major(v: jax.Array) -> jax.Array:
    """[S_steps, n_streams, K, ...] -> [n_streams, S_steps*K, ...]."""
    return jax.numpy.moveaxis(v, 0, 1).reshape(
        (v.shape[1], v.shape[0] * v.shape[2]) + v.shape[3:])


def fused_sharded_steps(step_fn, donate: bool = True):
    """Megastep for shard_mapped chains: lax.scan over the sharded step.

    ``step_fn(state, x, *args)`` is the (already shard_mapped, un-jitted)
    per-block step over [n_streams, ...] inputs; the fused version takes
    xs [S, n_streams, ...] and returns outputs reordered stream-major to
    [n_streams, S*K, ...] — per stream, the in-order concatenation of the
    S per-step outputs.
    """

    def impl(state, xs, *args):
        def body(st, x):
            return step_fn(st, x, *args)

        state, outs = jax.lax.scan(body, state, xs)
        return state, jax.tree.map(_flatten_stream_major, outs)

    return jax.jit(impl, donate_argnums=(0,) if donate else ())
