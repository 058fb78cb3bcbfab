"""Scaling-efficiency benchmark for the time-sharded scanner.

Runs the (1 x T) time-sharded chain (halo exchange over ppermute) on
T = 1..N devices and reports samples/s and parallel efficiency vs the
1-device run.  Each timed region ends in ``block_until_ready``.

With --platform cpu the same measurement runs on a virtual 8-device CPU
mesh (a rehearsal of the sharding, not a device number).

Prints one JSON line per device count, with the JAX device record and
the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None, choices=[None, "cpu"],
                   nargs="?")
    p.add_argument("--devices", type=int, nargs="*", default=None)
    p.add_argument("--subchunks-per-step", type=int, default=40)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args()

    if args.platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()

    import jax
    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    from sdr_pmr446_tpu.utils.device import card_identity, device_record
    enable_compile_cache()
    dev = device_record()
    if dev["platform"] != "gpu" and args.platform != "cpu":
        print(f"bench_scaling: no GPU found (JAX reports {dev}); use "
              f"--platform cpu for a rehearsal", file=sys.stderr)
        return 2
    card = card_identity()
    import jax.numpy as jnp
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import synth
    from sdr_pmr446_tpu.parallel.scanner_sharded import (ShardedScannerChain,
                                                         make_mesh)
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params

    n_avail = len(jax.devices())
    counts = args.devices or [d for d in (1, 2, 4, 8) if d <= n_avail]
    k = args.subchunks_per_step
    params = make_runtime_params(C.ScannerArgs())

    base = None
    for d in counts:
        mesh = make_mesh(1, d)
        chain = ShardedScannerChain(mesh, C.BlockConfig(k))
        state = chain.init_state(1)
        n = chain.block.input_len
        iq = jnp.asarray(
            synth.make_scanner_iq(n, channel=5, ctcss_code=12)[None],
            jnp.complex64)
        state, out = chain.step(state, iq, params)   # compile
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state, out = chain.step(state, iq, params)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        msps = n * args.iters / dt / 1e6
        if base is None:
            base = msps
        eff = msps / (base * d)
        print(json.dumps({
            "devices": d,
            "k": k,
            "Msamples_per_sec": msps,
            "scaling_efficiency": eff,
            "vs_realtime": msps / 1.024,
            "device": dev,
            "card": card,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
