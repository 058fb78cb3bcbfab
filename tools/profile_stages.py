"""Per-stage device time of the scanner chain, from one jax.profiler trace.

Each stage of ``ScannerChain._step_impl`` runs as its own jitted function
(named ``stage_<name>``, so its XLA module is ``jit_stage_<name>``) on the
stage's real inputs at the real geometry, ``--calls`` times inside one
profiler trace, together with the whole step (``jit_stage_full_step``).
The trace is reduced by module: the device time per call of each stage,
and the heaviest kernels of each stage with the HLO op they implement —
which tells whether a convolution went to cuDNN or to XLA's own kernels.

A stage run alone pays its own launch and cannot fuse with its
neighbours, so the stage sum exceeds the full step; read the stages as
shares, and the full step as the number.

    python tools/profile_stages.py [--subchunks-per-step 40] [--calls 10]
        [--out chiprun_out/profile_stages] [--json]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)


def build_stages(k: int, waterfall: int, input_format: str):
    """-> list of (name, jitted fn, args): the chain's stages in order,
    each fed the previous stage's real output."""
    import jax
    import jax.numpy as jnp
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import synth
    from sdr_pmr446_tpu.ops import decode, fir, fm, iir
    from sdr_pmr446_tpu.ops import rssi as rssi_op, spectrogram
    from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params
    from sdr_pmr446_tpu.scanner.fsm import FsmCarry, fsm_ctcss_scan_v3

    chain = ScannerChain(C.BlockConfig(k), waterfall=waterfall,
                         input_format=input_format)
    params = make_runtime_params(C.ScannerArgs())
    st = chain.init_state()
    n = chain.block.input_len
    ns = C.SUBCHUNK_AUDIO
    sig = 0.8 * synth.make_scanner_iq(n, channel=5, ctcss_code=12)
    iq = jnp.asarray(decode.pack_iq(sig, input_format))

    def stage_decode_dc(iq, dc_x, dc_y):
        x = decode.decode_complex(iq, input_format)
        return iir.dc_blocker_apply((dc_x, dc_y), x, C.DC_BLOCK_ALPHA)[1]

    def stage_resampler(hist, x):
        return chain.resampler.apply(hist, x)[1]

    def stage_pfb(hist, parity, band):
        return chain.pfb.apply((hist, parity), band)[1]

    def stage_demod_rssi(prev, chan):
        return fm.fm_demod(prev, chan)[1], rssi_op.subchunk_rssi(chan, k)

    def stage_audio_fir(st, demod, gain):
        _, hp = fir.fir_apply(st.hp_hist, demod, chain.hp_taps)
        _, dl = fir.delay_apply(st.delay_hist, demod)
        _, lp = iir.dc_blocker_apply((st.lp_dc_x, st.lp_dc_y), dl - hp,
                                     C.DC_BLOCK_ALPHA)
        _, audio = fir.fir_apply(st.deemph_hist, hp * gain,
                                 chain.deemph_taps)
        return audio, lp

    def stage_fsm(st, rssi_db, lp, params):
        carry = FsmCarry(st.fsm_state, st.active_chan, st.rssi, st.ct_count,
                         st.ct_carry, st.ct_detected, st.ct_max_idx,
                         st.ct_freq)
        return fsm_ctcss_scan_v3(
            carry, rssi_db, None, params.channel_mask, params.squelch_level,
            params.lock_max, lp_cm=lp.reshape(C.NUM_CHANNELS, k, ns))

    def stage_waterfall(hist, band):
        return spectrogram.asgram_rows(hist, band, k, waterfall)[1]

    def stage_full_step(st, iq, params):
        return chain._step_impl(st, iq, params)

    stages = []

    def add(fn, *args):
        j = jax.jit(fn)
        stages.append((fn.__name__[len("stage_"):], j, args))
        return j(*args)

    x = add(stage_decode_dc, iq, st.dc_x, st.dc_y)
    band = add(stage_resampler, st.resamp_hist, x)
    chan = add(stage_pfb, st.pfb_hist, st.frame_parity, band)
    demod, rssi_db = add(stage_demod_rssi, st.demod_prev, chan)
    _, lp = add(stage_audio_fir, st, demod, params.audio_gain)
    add(stage_fsm, st, rssi_db, lp, params)
    if waterfall:
        add(stage_waterfall, st.wf_hist, band)
    add(stage_full_step, st, iq, params)
    jax.block_until_ready([s[1](*s[2]) for s in stages])
    return stages


def reduce_trace(path: str) -> dict:
    """xplane.pb -> {module: {"total_ns", "kernels": {(name, hlo_op): ns}}}
    over the events of the device planes (``/device:*``); on a CPU run,
    over the host's XLA op events instead."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in pd.planes if p.name.startswith("/host:CPU")]
    mods: dict = collections.defaultdict(
        lambda: {"total_ns": 0.0, "kernels": collections.Counter()})
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                mod = stats.get("hlo_module")
                if not mod:
                    continue
                m = mods[str(mod)]
                m["total_ns"] += ev.duration_ns
                m["kernels"][(ev.name, str(stats.get("hlo_op", "")))] += \
                    ev.duration_ns
    return dict(mods)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--subchunks-per-step", type=int, default=40)
    p.add_argument("--waterfall", type=int, default=80)
    p.add_argument("--input-format", default="cu8")
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--top", type=int, default=4,
                   help="heaviest kernels listed per stage")
    p.add_argument("--out", default=os.path.join(_REPO_ROOT, "chiprun_out",
                                                 "profile_stages"))
    p.add_argument("--json", action="store_true")
    args = p.parse_args()

    import jax
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    from sdr_pmr446_tpu.utils.device import card_identity, device_record
    enable_compile_cache()
    dev = device_record()
    stages = build_stages(args.subchunks_per_step, args.waterfall,
                          args.input_format)
    with jax.profiler.trace(args.out):
        for name, fn, a in stages:
            with jax.profiler.TraceAnnotation(f"stage {name}"):
                for _ in range(args.calls):
                    out = fn(*a)
                jax.block_until_ready(out)
    files = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    mods = reduce_trace(files[-1])
    rows = []
    for name, _, _ in stages:
        m = mods.get(f"jit_stage_{name}", {"total_ns": 0.0,
                                           "kernels": collections.Counter()})
        top = [{"kernel": kn, "hlo_op": op,
                "ms_per_call": ns / args.calls / 1e6}
               for (kn, op), ns in m["kernels"].most_common(args.top)]
        rows.append({"stage": name,
                     "ms_per_call": m["total_ns"] / args.calls / 1e6,
                     "top_kernels": top})
    result = {"k": args.subchunks_per_step, "waterfall": args.waterfall,
              "input_format": args.input_format, "calls": args.calls,
              "device": dev, "card": card_identity(), "stages": rows,
              "trace": files[-1]}
    if args.json:
        print(json.dumps(result))
        return 0
    print(f"# {dev} | {result['card']} | K={args.subchunks_per_step} "
          f"{args.input_format} w={args.waterfall}")
    for r in rows:
        print(f"{r['stage']:>12}: {r['ms_per_call']:9.3f} ms/call")
        for t in r["top_kernels"]:
            print(f"{'':>14}{t['ms_per_call']:9.3f}  {t['kernel']}  "
                  f"[{t['hlo_op']}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
