"""ms-per-block latency of the scanner chain at small K.

The reference is a real-time app: one 97.66 ms chunk (100352 samples,
src/sdr_pmr446.c:30) per loop iteration.  bench.py measures throughput
at K=40; this tool records the LATENCY operating point — milliseconds per
dispatched block at K=1/4/8, each block dispatched and waited for
(``block_until_ready``) on its own — and the real-time margin (block
duration / latency).  All K run in this one process, on distinct input
blocks; any failure exits non-zero.

    python tools/latency_bench.py [--ks 1,4,8] [--steps 40] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

#: reference real-time block cadence: 100352 samples at 1.024 Msps
BLOCK_MS = 100352 / 1.024e6 * 1e3                    # 98.0 ms per K=1


def measure_k(k: int, steps: int, input_format: str = "cu8") -> dict:
    """Median and tail ms per block over `steps` blocks at K=k."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import synth
    from sdr_pmr446_tpu.ops import decode
    from sdr_pmr446_tpu.scanner.chain import (ScannerChain,
                                              make_runtime_params)

    chain = ScannerChain(C.BlockConfig(k), input_format=input_format)
    params = make_runtime_params(C.ScannerArgs())
    n = chain.block.input_len
    n_rot = min(steps, 8)
    cap = 0.8 * synth.make_scanner_iq(n_rot * n, channel=5, ctcss_code=12)
    iqs = [jnp.asarray(decode.pack_iq(cap[i * n:(i + 1) * n], input_format))
           for i in range(n_rot)]

    state = chain.init_state()
    t0 = time.perf_counter()
    state, out = chain.step(state, iqs[0], params)
    jax.block_until_ready((state, out))
    compile_s = time.perf_counter() - t0
    for i in range(1, 4):                            # warmup
        state, out = chain.step(state, iqs[i % n_rot], params)
    jax.block_until_ready((state, out))

    ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        state, out = chain.step(state, iqs[i % n_rot], params)
        jax.block_until_ready((state, out))
        ms.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(ms)
    return {"k": k, "input_format": input_format, "steps": steps,
            "median_ms_per_block": med, "max_ms_per_block": float(np.max(ms)),
            "block_ms": k * BLOCK_MS, "realtime_margin": k * BLOCK_MS / med,
            "compile_s": compile_s}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ks", default="1,4,8")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--json", action="store_true",
                   help="print one JSON line with all rows")
    args = p.parse_args()

    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    from sdr_pmr446_tpu.utils.device import card_identity, device_record
    enable_compile_cache()
    dev = device_record()
    card = card_identity()
    rows = [dict(measure_k(int(v), args.steps), device=dev, card=card)
            for v in args.ks.split(",")]
    if args.json:
        print(json.dumps(rows))
        return 0
    print(f"# {dev} | {card}")
    print(f"{'K':>3} {'block ms':>9} {'median ms/blk':>14} "
          f"{'max ms/blk':>11} {'margin':>8}")
    for r in rows:
        print(f"{r['k']:>3} {r['block_ms']:>9.1f} "
              f"{r['median_ms_per_block']:>14.3f} "
              f"{r['max_ms_per_block']:>11.3f} "
              f"{r['realtime_margin']:>7.0f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
