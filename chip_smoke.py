"""End-to-end smoke run of the receiver chains on one GPU.

    python chip_smoke.py               # every one-card phase
    python chip_smoke.py --four-gpus   # only the four-card scan_batch phase
    python chip_smoke.py --compile-only  # compile each chain at its real
                                         # geometry, print its memory
                                         # analysis, one oracle comparison

Drives the apps through their ``main()`` entry points, in this one
process, at the sizes a monitoring user runs: a synthetic 60 s cu8
capture at 1.024 Msps that follows a traffic script (channels with
different CTCSS codes, one without, an overlap that makes the scanner
change channel, noise-only gaps between them), the reference's
real-time K=1 cadence, the reference README's waterfall widths, the
dsd_in front end, the segment recorder, the single-channel monitor and
scan_batch over 8 captures with a kill and resume.  Each phase checks its
output against the repository's own references (the traffic script, the
float64 oracles in ``oracle/chain.py``, solo and uninterrupted runs) and
prints the measured value beside its limit; any failure exits non-zero.

Every phase is a function of its capture length and K, so the CPU tests
rehearse each one at a tiny size; only ``main()`` insists on the GPU.
The last stdout line is ``{"ok": true, "device": {...}}``.  Wall times and
input rates are informational: compile time is counted separately, and a
phase's wall also holds capture synthesis, file IO and the oracle runs.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import re
import shutil
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from sdr_pmr446_tpu import config as C  # noqa: E402
from sdr_pmr446_tpu.io import iq as iq_io, synth, wav  # noqa: E402

#: scratch for captures and outputs (hundreds of MB; removed at the end)
WORK = os.path.join(_ROOT, ".chip_smoke_work")
FS = C.SDR_SAMPLERATE
NOISE = 0.02                   # dithers the cu8 quantizer (2.5 LSB rms)

#: capture lengths are whole sub-chunks (100352 samples, 98 ms) and whole
#: blocks of every K they are run at, so no run pads a tail
SUB = C.SUBCHUNK_IN
#: traffic script for a SCRIPT_SUBS-sub-chunk (58.8 s) capture: (first
#: sub-chunk, end sub-chunk, channel, CTCSS code or None, amplitude).
#: Channel 14 runs weak and channel 6 joins it stronger, so lock mode
#: "max" changes channel; the gaps are noise only.
SCRIPT = [(0, 80, 3, 5, 1.0), (120, 200, 9, None, 1.0),
          (240, 380, 14, 20, 0.3), (300, 380, 6, 33, 1.0),
          (420, 500, 11, 12, 1.0)]
SCRIPT_SUBS = 600

EVENT_PREFIXES = ("Tuned to", "Detuned from", "Changed active",
                  "Acquired CTCSS", "CTCSS code change", "Lost CTCSS")


# ------------------------------------------------------------- utilities
def report(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(phase: str, what: str, ok: bool, measured="", limit="") -> None:
    """Print one comparison with its measured value and limit; a failed
    comparison ends the run."""
    lim = f" (limit {limit})" if limit != "" else ""
    report(phase, f"{what}: {measured}{lim} -> {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {phase}: {what} failed")


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2),
                                                       1e-30)))


def scaled_script(n_sub: int):
    """SCRIPT stretched onto an n_sub-sub-chunk capture."""
    return [(a * n_sub // SCRIPT_SUBS, b * n_sub // SCRIPT_SUBS, ch, code,
             amp) for a, b, ch, code, amp in SCRIPT]


def script_capture(n_sub: int, seed: int = 0, script=None):
    """n_sub sub-chunks of ``script`` (default: SCRIPT stretched to n_sub)
    over a noise floor that dithers the cu8 quantizer, as complex128.
    Segments are phase-continuous (synth start_sample = global index)."""
    script = script if script is not None else scaled_script(n_sub)
    n = n_sub * SUB
    rng = np.random.default_rng(seed)
    iq = NOISE * (rng.standard_normal(n) + 1j * rng.standard_normal(n)) \
        / np.sqrt(2)
    for i, (a, b, ch, code, amp) in enumerate(script):
        s0, s1 = a * SUB, min(b * SUB, n)
        if s0 >= s1:
            continue
        iq[s0:s1] += synth.make_scanner_iq(
            s1 - s0, channel=ch, ctcss_code=code, amplitude=amp,
            noise_db=-200.0, seed=seed * 100 + i, start_sample=s0)
    return 0.8 * iq


def _code_line(code):
    f = np.float32(C.CTCSS_FREQS[code - 1])
    return f"Acquired CTCSS code: {code} (frequency: {f:3.2f}Hz)"


def expected_events(script) -> list:
    """The script's events in script_view() form: under lock mode "max"
    the strongest transmitter on the air is the active channel."""
    edges = sorted({t for a, b, *_ in script for t in (a, b)})
    out, cur = [], None
    for t0 in edges:
        live = [s for s in script if s[0] <= t0 < s[1]]
        nxt = max(live, key=lambda s: s[4]) if live else None
        if (nxt and nxt[2]) == (cur and cur[2]):
            continue
        if nxt is None:
            out.append(f"Detuned from channel {cur[2]}")
        else:
            out.append(f"Tuned to channel {nxt[2]}" if cur is None else
                       f"Changed active channel from {cur[2]} to {nxt[2]}")
            if nxt[3] and nxt[3] != (cur and cur[3]):
                out.append(_code_line(nxt[3]))
        cur = nxt
    return out


def script_view(lines) -> list:
    """The scanner's reference-format event log reduced to what a traffic
    script determines.  Under lock mode "max" the reference changes to the
    strongest channel BEFORE testing the squelch, so the first noise-only
    sub-chunk after a transmission logs "Changed active channel from A to
    N" + "Detuned from channel N" for whichever noise channel N is
    loudest (src/sdr_pmr446.c's order; oracle/chain.py does the same):
    that pair reads as "Detuned from channel A".  A CTCSS hand-over may
    log "CTCSS code change: X" or "Lost CTCSS code" then "Acquired CTCSS
    code: X", depending on where the detector window falls: both read as
    the acquisition of X, and "Lost" lines are dropped."""
    out = []
    for ln in strip_rssi(lines):
        if ln == "Lost CTCSS code":
            continue
        ln = ln.replace("CTCSS code change:", "Acquired CTCSS code:")
        m = re.fullmatch(r"Detuned from channel (\d+)", ln)
        prev = re.fullmatch(r"Changed active channel from (\d+) to (\d+)",
                            out[-1]) if out else None
        if m and prev and prev[2] == m[1]:
            out[-1] = f"Detuned from channel {prev[1]}"
            continue
        out.append(ln)
    return out


def strip_rssi(lines):
    return [re.sub(r" \(RSSI: [^)]*\)", "", ln) for ln in lines]


def write_cu8(path: str, iq) -> None:
    iq_io.write_iq(path, iq, "cu8")


class _EventLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        m = record.getMessage()
        if m.startswith(EVENT_PREFIXES):
            self.lines.append(m)


def run_scanner_app(argv):
    """apps/sdr_pmr446 main() -> (rc, event lines, stdout text)."""
    from sdr_pmr446_tpu.apps import sdr_pmr446 as app
    h = _EventLog()
    lg = logging.getLogger("sdr_pmr446")
    level = lg.level
    lg.setLevel(logging.INFO)       # the event lines are INFO records
    lg.addHandler(h)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = app.main(argv)
    finally:
        lg.removeHandler(h)
        lg.setLevel(level)
    return rc, h.lines, buf.getvalue()


def _secs(n_sub: int) -> str:
    return f"{n_sub} sub-chunks = {n_sub * SUB / FS:.2f} s"


# ------------------------------------------------------------------ phases
def phase_native() -> dict:
    """Build the native host engine (make -C native) and load it."""
    from sdr_pmr446_tpu.io import native
    ok = native.build_native()
    check("native", "make -C native; io.native.have_native()",
          ok and native.have_native(), native.have_native(), True)
    return {}


def phase_scanner(n_sub=SCRIPT_SUBS, k=40, k_rt=1, n_prefix=120,
                  n_oracle=30, work=WORK) -> dict:
    """Scanner app on the scripted capture: events == script; K=k_rt and
    K=k agree over the prefix; audio vs the float64 oracle."""
    from sdr_pmr446_tpu.oracle.chain import ScannerOracle
    ph = "scanner"
    iq = script_capture(n_sub)
    cap = os.path.join(work, "scan.cu8")
    write_cu8(cap, iq)
    pre = os.path.join(work, "scan_prefix.cu8")
    write_cu8(pre, iq[:n_prefix * SUB])
    out = os.path.join(work, "scan.wav")
    rc, ev, _ = run_scanner_app(["--input", cap, "--output", out,
                                 "--device-decode", "-p", "max",
                                 "--subchunks-per-step", str(k)])
    check(ph, f"app rc ({_secs(n_sub)} cu8, K={k})", rc == 0, rc, 0)
    report(ph, "events: " + " | ".join(ev))
    want = expected_events(scaled_script(n_sub))
    got = script_view(ev)
    check(ph, "event log == traffic script", got == want,
          f"{len(ev)} lines, script view {got}", f"the script's {want}")

    runs = {}
    for kk in (k_rt, k):
        o = os.path.join(work, f"prefix_k{kk}.wav")
        rc, ev_k, _ = run_scanner_app(["--input", pre, "--output", o,
                                       "--device-decode", "-p", "max",
                                       "--subchunks-per-step", str(kk)])
        check(ph, f"app rc (prefix {_secs(n_prefix)}, K={kk})", rc == 0,
              rc, 0)
        runs[kk] = ev_k
    rs = [[float(x) for x in re.findall(r"RSSI: ([-0-9.]+)dB", "".join(r))]
          for r in (runs[k_rt], runs[k])]
    d_rssi = max([abs(a - b) for a, b in zip(*rs)] or [0.0])
    same = strip_rssi(runs[k_rt]) == strip_rssi(runs[k])
    check(ph, f"K={k_rt} events == K={k} events over the prefix",
          same and d_rssi <= 0.011,
          f"{len(runs[k_rt])} vs {len(runs[k])} lines, equal={same}, max "
          f"RSSI diff {d_rssi:.3f} dB", "equal, RSSI within 0.01 dB")

    ora = ScannerOracle(C.ScannerArgs(lock_mode="max"))
    ora.process(iq_io.read_iq(cap, "cu8")[:n_oracle * SUB].astype(
        np.complex128))
    ref = np.stack(ora.audio)
    audio, _ = wav.read_wav(out)
    got_a = audio[:ref.size].reshape(ref.shape)
    s = snr_db(ref[2:], got_a[2:])
    check(ph, f"audio vs ScannerOracle over {_secs(n_oracle)} (fp32 "
          f"dots, not TF32)", s > 40.0, f"SNR {s:.1f} dB", "> 40 dB")
    return {"samples": (n_sub + 2 * n_prefix) * SUB}


def phase_waterfall(n_sub=120, k=40, widths=(80, 120), rows=16,
                    work=WORK) -> dict:
    """-w 80 / -w 120 through the app; rows vs the asgram oracle."""
    from sdr_pmr446_tpu.oracle.chain import (AsgramStream,
                                             PolyResamplerStream,
                                             dc_blocker_stream)
    from sdr_pmr446_tpu.ops import decode
    from sdr_pmr446_tpu.runtime.driver import ScannerDriver
    from sdr_pmr446_tpu.taps import design as D
    ph = "waterfall"
    cap = os.path.join(work, "wf.cu8")
    write_cu8(cap, script_capture(
        n_sub, script=scaled_script(SCRIPT_SUBS * n_sub // 120)))
    rows = min(rows, k)
    band = PolyResamplerStream(D.resampler_taps(), C.RESAMP_L,
                               C.RESAMP_M).process(dc_blocker_stream().process(
                                   iq_io.read_iq(cap, "cu8")[:rows * SUB]
                                   .astype(np.complex128)))
    for w in widths:
        rc, _, text = run_scanner_app(["--input", cap, "--output",
                                       os.path.join(work, f"wf{w}.wav"),
                                       "--device-decode", "-p", "max",
                                       "--subchunks-per-step", str(k),
                                       "-w", str(w)])
        lines = [ln for ln in text.replace("\r", "\n").splitlines()
                 if ln.startswith(" > ")]
        check(ph, f"-w {w} app rc and rows", rc == 0 and
              len(lines) == n_sub, f"rc={rc}, {len(lines)} rows",
              f"rc=0, {n_sub} rows")
        drv = ScannerDriver(C.ScannerArgs(waterfall=w, lock_mode="max"),
                            subchunks_per_step=k, input_format="cu8")
        wire = decode.pack_bytes(np.fromfile(cap, np.uint8,
                                             count=2 * k * SUB), "cu8")
        got = drv.run([wire]).waterfall
        asg = AsgramStream(w)
        err = 0.0
        for r in range(rows):
            asg.write(band[r * C.SUBCHUNK_RESAMP:(r + 1) * C.SUBCHUNK_RESAMP])
            err = max(err, float(np.max(np.abs(got[r] - asg.execute()))))
        check(ph, f"-w {w} rows vs asgram oracle ({rows} rows)",
              err <= 1e-2, f"max |diff| {err:.2e} dB", "1e-2 dB")
    return {"samples": len(widths) * n_sub * SUB}


def _fm_capture(n: int):
    t = np.arange(n) / FS
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    return 0.8 * np.exp(1j * 2 * np.pi * (2000.0 * np.cumsum(msg)
                                          + 300.0 * np.arange(n)) / FS)


def phase_dsd(n_sub=300, k=10, work=WORK) -> dict:
    """dsd_in app (cf32 host decode, cu8 device decode) vs DsdInOracle at
    the bound of tests/test_dsd_in.py::test_matches_scipy_oracle."""
    from sdr_pmr446_tpu.apps import dsd_in as app
    from sdr_pmr446_tpu.oracle.chain import DsdInOracle
    ph = "dsd_in"
    iq = _fm_capture(n_sub * SUB)
    for fmt, extra in (("cf32", []), ("cu8", ["--device-decode"])):
        cap = os.path.join(work, f"dsd.{fmt}")
        iq_io.write_iq(cap, iq, fmt)
        out = os.path.join(work, f"dsd_{fmt}.raw")
        rc = app.main(["--input", cap, "--output", out,
                       "--subchunks-per-step", str(k)] + extra)
        pcm = np.fromfile(out, dtype="<i2") if rc == 0 else np.zeros(0)
        check(ph, f"{fmt} {' '.join(extra)} rc, PCM samples",
              rc == 0 and len(pcm) == len(iq) * 3 // 64,
              f"rc={rc}, {len(pcm)}", f"rc=0, {len(iq) * 3 // 64}")
        ref = DsdInOracle().process(iq_io.read_iq(cap, fmt))
        s = snr_db(ref, pcm)
        check(ph, f"{fmt} {' '.join(extra)} PCM vs DsdInOracle",
              s > 50.0, f"SNR {s:.1f} dB", "> 50 dB")
    return {"samples": 2 * len(iq)}


def phase_single(n_sub=80, k=10, work=WORK) -> dict:
    """Single-channel monitor on the script's first transmission (cu8
    wire decoded on device).  There is no float64 single-channel oracle:
    the reference is the 1 kHz test tone, at the single-chain gate of
    tests/test_misc.py."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.ops import decode
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    ph = "single"
    script = scaled_script(SCRIPT_SUBS * n_sub // 80)
    ch = script[0][2]
    chain = SingleChannelChain(channel=ch, subchunks_per_step=k,
                               input_format="cu8")
    wire = decode.pack_iq(script_capture(n_sub, script=script), "cu8")
    st = chain.init_state()
    parts = []
    wl = chain.step_arg_len
    for i in range(n_sub // k):
        st, a = chain.step(st, jnp.asarray(wire[i * wl:(i + 1) * wl]))
        parts.append(np.asarray(a))
    s = synth.tone_snr_db(np.concatenate(parts)[4000:], 1000.0)
    check(ph, f"channel {ch} 1 kHz tone SNR over {_secs(n_sub)}", s > 35.0,
          f"{s:.1f} dB", "> 35 dB")
    return {"samples": n_sub * SUB}


def phase_record(n_sub=120, k=10, work=WORK) -> dict:
    """apps/record on the script's prefix: one WAV per tuned segment."""
    from sdr_pmr446_tpu.apps import record
    ph = "record"
    span = SCRIPT_SUBS * n_sub // 120
    cap = os.path.join(work, "rec.cu8")
    write_cu8(cap, script_capture(n_sub, script=scaled_script(span)))
    outd = os.path.join(work, "rec")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = record.main(["--input", cap, "--outdir", outd,
                          "--subchunks-per-step", str(k)])
    wavs = sorted(f for f in os.listdir(outd) if f.endswith(".wav")) \
        if os.path.isdir(outd) else []
    got = (len(wav.read_wav(os.path.join(outd, wavs[0]))[0])
           // C.SUBCHUNK_AUDIO) if wavs else 0
    a, b = scaled_script(span)[0][:2]
    check(ph, "rc, segment WAVs, first segment sub-chunks", rc == 0 and
          len(wavs) == 1 and abs(got - (b - a)) <= 2,
          f"rc={rc}, {len(wavs)} WAV, {got}", f"rc=0, 1 WAV, {b - a} +- 2")
    return {"samples": n_sub * SUB}


BATCH_PLAN = [(2, 7), (4, None), (5, 12), (7, 21), (8, 3), (10, 30),
              (13, 38), (16, 1)]


def batch_captures(n_caps: int, n_sub: int, work: str):
    """n_caps cu8 captures: a transmission for the first 60 % (channel /
    code from BATCH_PLAN), then noise."""
    paths = []
    for i in range(n_caps):
        ch, code = BATCH_PLAN[i % len(BATCH_PLAN)]
        iq = script_capture(n_sub, seed=10 + i,
                            script=[(0, 6 * n_sub // 10, ch, code, 1.0)])
        p = os.path.join(work, f"b{i}.cu8")
        write_cu8(p, iq)
        paths.append(p)
    return paths


def _read_out(d, stem):
    return (open(os.path.join(d, f"{stem}.wav"), "rb").read(),
            open(os.path.join(d, f"{stem}.events.log")).read())


def phase_batch(n_caps=8, n_sub=120, k=40, work=WORK) -> dict:
    """scan_batch over n_caps captures on one card: each capture's events
    == its solo scan; a --stop-after stop + --resume (npz checkpoint) is
    byte-identical to the uninterrupted run."""
    from sdr_pmr446_tpu.apps import scan_batch
    ph = "scan_batch"
    caps = batch_captures(n_caps, n_sub, work)
    base = ["--subchunks-per-step", str(k), "--device-decode", "-p", "max"]
    full = os.path.join(work, "batch_full")
    rc = scan_batch.main(caps + base + ["--out-dir", full])
    check(ph, f"{n_caps} captures x {_secs(n_sub)} rc", rc == 0, rc, 0)
    n_ok = 0
    for i, cp in enumerate(caps):
        solo = os.path.join(work, f"batch_solo{i}")
        rc = scan_batch.main([cp] + base + ["--out-dir", solo])
        ev_b, ev_s = _read_out(full, f"b{i}")[1], _read_out(solo, f"b{i}")[1]
        ch, code = BATCH_PLAN[i % len(BATCH_PLAN)]
        n_ok += (rc == 0 and ev_b == ev_s
                 and f"Tuned to channel {ch} " in ev_b
                 and (code is None or f"CTCSS code: {code} " in ev_b))
    check(ph, "per-capture events == solo scan (and the planned tune/code)",
          n_ok == n_caps, f"{n_ok}/{n_caps}", f"{n_caps}/{n_caps}")
    ck = os.path.join(work, "batch.ck.npz")
    part = os.path.join(work, "batch_part")
    res = os.path.join(work, "batch_resumed")
    rc1 = scan_batch.main(caps + base + ["--out-dir", part, "--checkpoint",
                                         ck, "--stop-after", "1"])
    rc2 = scan_batch.main(caps + base + ["--out-dir", res, "--checkpoint",
                                         ck, "--resume"])
    same = all(_read_out(res, f"b{i}") == _read_out(full, f"b{i}")
               for i in range(n_caps))
    check(ph, "stop + resume outputs byte-identical to uninterrupted",
          rc1 == 0 and rc2 == 0 and same, f"rc={rc1},{rc2} same={same}",
          "rc=0,0 same=True")
    return {"samples": 3 * n_caps * n_sub * SUB}


def phase_four_gpus(n_caps=4, n_sub=120, k=40, work=WORK) -> dict:
    """scan_batch on four cards: the default all-devices-as-streams mesh
    (4,1) and time sharding (1,4) vs the one-card (1,1) run: events
    equal, audio within tests/test_sharding.py's 1e-4."""
    from sdr_pmr446_tpu.apps import scan_batch
    ph = "four_gpus"
    caps = batch_captures(n_caps, n_sub, work)
    base = caps + ["--subchunks-per-step", str(k), "--device-decode",
                   "-p", "max"]
    outs = {}
    for name, mesh in (("one_card", ["--mesh", "1,1"]), ("streams", []),
                       ("time", ["--mesh", "1,4"])):
        d = os.path.join(work, f"mesh_{name}")
        rc = scan_batch.main(base + mesh + ["--out-dir", d])
        check(ph, f"mesh {' '.join(mesh) or 'default (4,1)'} rc", rc == 0,
              rc, 0)
        outs[name] = d
    for name in ("streams", "time"):
        ev_ok, err = True, 0.0
        for i in range(n_caps):
            a, _ = wav.read_wav(os.path.join(outs[name], f"b{i}.wav"))
            r, _ = wav.read_wav(os.path.join(outs["one_card"], f"b{i}.wav"))
            ev_ok &= (_read_out(outs[name], f"b{i}")[1]
                      == _read_out(outs["one_card"], f"b{i}")[1])
            err = max(err, float(np.max(np.abs(a - r))) if len(a) == len(r)
                      else np.inf)
        check(ph, f"{name} mesh vs one card: events, audio", ev_ok and
              err <= 1e-4, f"events equal={ev_ok}, max |diff| {err:.2e}",
              "equal, 1e-4")
    return {"samples": 3 * n_caps * n_sub * SUB}


def compile_only() -> None:
    """First call on a new card: compile each chain at its real geometry,
    print XLA's memory analysis, compare once with the oracle."""
    import jax
    import jax.numpy as jnp
    from sdr_pmr446_tpu.ops import decode
    from sdr_pmr446_tpu.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params
    from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    params = make_runtime_params(C.ScannerArgs(lock_mode="max"))

    def arg(chain_len, fmt, lead=()):
        n = decode.packed_len(chain_len, fmt) if fmt != "cf32" else chain_len
        return jax.ShapeDtypeStruct(lead + (n,), jnp.float32 if fmt != "cf32"
                                    else jnp.complex64)

    def show(name, fn, *args):
        t0 = time.perf_counter()
        comp = jax.jit(fn).lower(*args).compile()
        report("compile", f"{name}: {time.perf_counter() - t0:.1f} s, "
               f"{comp.memory_analysis()}")

    for k, w in ((40, 0), (1, 0), (40, 80), (40, 120)):
        ch = ScannerChain(C.BlockConfig(k), waterfall=w, input_format="cu8")
        show(f"scanner K={k} w={w} cu8", ch._step_impl, ch.init_state(),
             arg(ch.input_len, "cu8"), params)
    for fmt in ("cf32", "cu8"):
        ch = DsdInChain(10, input_format=fmt)
        show(f"dsd_in K=10 {fmt}", ch._step_impl, ch.init_state(),
             arg(ch.input_len, fmt))
    ch = SingleChannelChain(3, 10, input_format="cu8")
    show("single K=10 cu8", ch._step_impl, ch.init_state(),
         arg(ch.input_len, "cu8"))
    sh = ShardedScannerChain(make_mesh(1, 1), C.BlockConfig(40),
                             input_format="cu8")
    st8 = sh.init_state(8)
    comp = sh._step.lower(st8, arg(sh.block.input_len, "cu8", (8,)),
                          params).compile()
    report("compile", f"scan_batch 8 streams K=40 cu8: "
           f"{comp.memory_analysis()}")
    # one oracle comparison: 3 s of the script through the chain
    from sdr_pmr446_tpu.oracle.chain import ScannerOracle
    iq = script_capture(30, script=scaled_script(SCRIPT_SUBS))
    ch = ScannerChain(C.BlockConfig(10), input_format="cu8")
    wire = decode.pack_iq(iq, "cu8")
    host = decode.decode_complex(jnp.asarray(wire), "cu8")
    st, audio = ch.init_state(), []
    wl = ch.step_arg_len
    for i in range(3):
        st, o = ch.step(st, jnp.asarray(wire[i * wl:(i + 1) * wl]), params)
        audio.append(np.asarray(o.audio)[np.asarray(o.audio_valid)])
    ora = ScannerOracle(C.ScannerArgs(lock_mode="max"))
    ora.process(np.asarray(host).astype(np.complex128))
    s = snr_db(np.stack(ora.audio)[2:], np.concatenate(audio)[2:])
    check("compile", "3 s audio vs ScannerOracle", s > 40.0,
          f"SNR {s:.1f} dB", "> 40 dB")


PHASES = [("native", phase_native), ("scanner", phase_scanner),
          ("waterfall", phase_waterfall), ("dsd_in", phase_dsd),
          ("single", phase_single), ("record", phase_record),
          ("scan_batch", phase_batch)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-gpus", action="store_true",
                   help="run only the four-card scan_batch phase")
    p.add_argument("--compile-only", action="store_true",
                   help="compile every chain at its real geometry, print "
                        "memory analysis, one oracle comparison")
    args = p.parse_args(argv)

    import jax
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    from sdr_pmr446_tpu.utils.device import card_identity, device_record
    dev = device_record()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: needs a GPU; JAX reports {dev}", file=sys.stderr)
        return 2
    want = 4 if args.four_gpus else 1
    if dev["count"] < want:
        print(f"chip_smoke: needs {want} GPUs; JAX reports {dev}",
              file=sys.stderr)
        return 2
    report("device", f"{card_identity()} | jax {jax.__version__} | {dev} | "
           f"compile cache {enable_compile_cache()}")

    compile_s = [0.0]

    def on_event(event, secs, **_):
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += secs
    jax.monitoring.register_event_duration_secs_listener(on_event)

    os.makedirs(WORK, exist_ok=True)
    try:
        if args.compile_only:
            compile_only()
            phases = []
        elif args.four_gpus:
            phases = [("four_gpus", phase_four_gpus)]
        else:
            phases = PHASES
        for name, fn in phases:
            c0, t0 = compile_s[0], time.perf_counter()
            info = fn()
            wall = time.perf_counter() - t0
            comp = compile_s[0] - c0
            rate = (info.get("samples", 0) / max(wall - comp, 1e-9) / 1e6
                    if info.get("samples") else 0.0)
            report(name, f"compile_s {comp:.1f} | wall_s {wall:.1f} | "
                   f"{rate:.1f} input Msamples/s over wall minus compile "
                   f"(informational: the phase's wall also holds capture "
                   f"synthesis, file IO and the oracle runs)")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
