"""Benchmark: input Msamples/s of one receiver chain on one GPU.

    python bench.py [--config scanner|waterfall|single|dsd|batch8]
                    [--subchunks-per-step K] [--input-format cu8]

Prints ONE JSON line: the median input rate over ``--repeats`` timed
regions (each region's rate is listed too), the real-time multiple over
the reference's 1.024 Msps input, the compile time, the JAX device record
and the card's name and power limit (``nvidia-smi``).

Configs (every chain is fed the rtl_tcp/RTL-SDR cu8 wire by default and
decodes it on device):
  scanner    16-ch PFB + NBFM + squelch/CTCSS + audio chain, K=40
  waterfall  scanner with the -w 80 spectrogram tap, K=40
  single     single-channel NBFM monitor chain, K=20
  dsd        dsd_in wideband-FM front end to 48 kHz s16, K=20
  batch8     the scanner over 8 independent streams on one device, K=10

Method: inputs are resident on the device and the chain state is
donated — the steady-state streaming regime.  Every timed step gets a
different input block (``--rot`` realizations rotated, larger together
than the card's L2 cache), and each timed region ends in
``block_until_ready``, so it covers the device work, not the enqueue.

Exits non-zero when JAX finds no GPU.  The one exception is an explicit
``JAX_PLATFORMS=cpu`` rehearsal, whose line then says ``"platform":
"cpu"``; such a number is a CPU number, never a device metric.
"""

import argparse
import json
import os
import statistics
import sys
import time

#: per-config default sub-chunks per step
DEFAULT_K = {"scanner": 40, "waterfall": 40, "single": 20, "dsd": 20,
             "batch8": 10}
BATCH_STREAMS = 8


def _stage(sigs, fmt):
    """Host signals [..., T] -> device step inputs in ``fmt``."""
    import numpy as np
    import jax.numpy as jnp
    from sdr_pmr446_tpu.ops import decode
    if fmt == "cf32":
        return jnp.asarray(sigs, jnp.complex64)
    flat = np.reshape(sigs, (-1, np.shape(sigs)[-1]))
    words = np.stack([decode.pack_iq(s, fmt) for s in flat])
    return jnp.asarray(words.reshape(np.shape(sigs)[:-1] + (-1,)))


def _realizations(n_rot, n, streams, channel, ctcss_code):
    """n_rot distinct blocks of n samples (x streams), cut from one
    synthesized capture so every block is a different stretch of signal
    and noise.  Returns [n_rot, (streams,) n] complex."""
    import numpy as np
    from sdr_pmr446_tpu.io import synth
    per = []
    for s in range(max(streams, 1)):
        cap = synth.make_scanner_iq(n_rot * n, channel=channel + s,
                                    ctcss_code=ctcss_code, seed=s)
        per.append(0.8 * cap.reshape(n_rot, n))
    blocks = np.stack(per, axis=1)          # [n_rot, streams, n]
    return blocks if streams else blocks[:, 0]


def build(config, k, fmt, n_rot):
    """-> (step, state, variants, input samples per step)."""
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params
    params = make_runtime_params(C.ScannerArgs())
    if config in ("scanner", "waterfall"):
        from sdr_pmr446_tpu.scanner.chain import ScannerChain
        chain = ScannerChain(C.BlockConfig(k),
                             waterfall=80 if config == "waterfall" else 0,
                             input_format=fmt)
        n = chain.input_len
        blocks = _realizations(n_rot, n, 0, 5, 12)
        variants = [(_stage(b, fmt), params) for b in blocks]
        return chain.step, chain.init_state(), variants, n
    if config == "batch8":
        from sdr_pmr446_tpu.parallel.scanner_sharded import (
            ShardedScannerChain, make_mesh)
        chain = ShardedScannerChain(make_mesh(1, 1), C.BlockConfig(k),
                                    input_format=fmt)
        n = chain.block.input_len
        blocks = _realizations(n_rot, n, BATCH_STREAMS, 2, 3)
        variants = [(_stage(b, fmt), params) for b in blocks]
        return (chain.step, chain.init_state(BATCH_STREAMS), variants,
                n * BATCH_STREAMS)
    if config == "single":
        from sdr_pmr446_tpu.scanner.single import SingleChannelChain
        chain = SingleChannelChain(channel=5, subchunks_per_step=k,
                                   input_format=fmt)
        blocks = _realizations(n_rot, chain.input_len, 0, 5, 12)
    else:
        from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain
        chain = DsdInChain(subchunks_per_step=k, input_format=fmt)
        blocks = _realizations(n_rot, chain.input_len, 0, 8, None)
    variants = [(_stage(b, fmt),) for b in blocks]
    return chain.step, chain.init_state(), variants, chain.input_len


def measure(step, state, variants, warmup, iters, repeats):
    """-> (compile_s, [seconds per timed region of `iters` steps])."""
    import jax
    t0 = time.perf_counter()
    state, out = step(state, *variants[0])
    jax.block_until_ready((state, out))
    compile_s = time.perf_counter() - t0
    j = 1
    for _ in range(warmup):
        state, out = step(state, *variants[j % len(variants)])
        j += 1
    jax.block_until_ready((state, out))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            state, out = step(state, *variants[j % len(variants)])
            j += 1
        jax.block_until_ready((state, out))
        times.append(time.perf_counter() - t0)
    return compile_s, times


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="scanner", choices=sorted(DEFAULT_K))
    p.add_argument("--subchunks-per-step", type=int, default=0,
                   help="0 = the config's default K")
    p.add_argument("--input-format", default="cu8",
                   choices=["cf32", "cf32w", "cs16", "cu8", "cs8"])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--rot", type=int, default=8,
                   help="distinct input blocks rotated across steps")
    args = p.parse_args(argv)

    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    from sdr_pmr446_tpu.utils.device import card_identity, device_record
    enable_compile_cache()
    dev = device_record()
    if dev["platform"] != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(f"bench: no GPU found (JAX reports {dev}); set "
              f"JAX_PLATFORMS=cpu for an explicit CPU rehearsal",
              file=sys.stderr)
        return 2

    from sdr_pmr446_tpu import config as C
    k = args.subchunks_per_step or DEFAULT_K[args.config]
    step, state, variants, n = build(args.config, k, args.input_format,
                                     args.rot)
    compile_s, times = measure(step, state, variants, args.warmup,
                               args.iters, args.repeats)
    rates = [n * args.iters / t / 1e6 for t in times]
    msps = statistics.median(rates)
    print(json.dumps({
        "metric": f"{args.config} chain input throughput, "
                  f"{args.input_format} wire, K={k}",
        "value": msps,
        "unit": "Msamples/s",
        "rates": rates,
        "vs_realtime": msps / (C.SDR_SAMPLERATE / 1e6),
        "compile_s": compile_s,
        "config": args.config, "k": k, "input_format": args.input_format,
        "device": dev,
        "card": card_identity(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
