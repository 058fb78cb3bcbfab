"""Driver, IO, waterfall-UI and CLI-app tests."""

import os
import sys
import tempfile

import numpy as np

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.io import synth, wav
from sdr_pmr446_tpu.runtime.driver import ScannerDriver
from sdr_pmr446_tpu.ui import waterfall as wf_ui


def _demo_iq(seconds=2.0, **kw):
    n = int(seconds * C.SDR_SAMPLERATE)
    n -= n % (5 * C.SUBCHUNK_IN)
    return synth.make_scanner_iq(n, channel=5, ctcss_code=12, **kw)


def test_driver_events_reference_format():
    iq = _demo_iq()
    drv = ScannerDriver(subchunks_per_step=5)
    res = drv.run(iq_io.block_stream(iq, drv.block_len))
    assert any(e.startswith("Tuned to channel 5") for e in res.events)
    assert any(e.startswith("Acquired CTCSS code: 12") for e in res.events)
    assert len(res.audio) > 0
    assert res.active_trace[-1] == 4


def test_driver_waterfall_rows():
    iq = _demo_iq()
    args = C.ScannerArgs(waterfall=64)
    drv = ScannerDriver(args, subchunks_per_step=5)
    res = drv.run(iq_io.block_stream(iq, drv.block_len))
    assert res.waterfall is not None
    assert res.waterfall.shape[1] == 64
    line = wf_ui.render_waterfall_line(res.waterfall[-1],
                                       float(res.rel_rssi[-1]))
    assert line.startswith(" > ") and "max SNR:" in line
    # channel 5 is at -50 kHz = bin width*? — peak should be left of center
    pk = int(np.argmax(res.waterfall[-1]))
    assert pk < 32


def test_footer_rendering():
    full = (1 << C.MAX_CHANNELS) - 1
    f = wf_ui.render_footer(64, full, -1, False, 0, 0.0)
    assert "446.100 MHz" in f and "01" in f and "16" in f
    masked = C.parse_channel_mask("3")
    f2 = wf_ui.render_footer(64, masked, 4, True, 12, 94.8)
    assert "--" in f2 and "^^" in f2
    assert "[CTCSS:  12 (94.80Hz)]" in f2 and "[5]" in f2


def test_iq_file_roundtrip():
    # scale to 0.9 so int formats don't clip the synthetic |x|~1.0 peaks
    iq = 0.9 * _demo_iq(seconds=0.5)[:10000]
    with tempfile.TemporaryDirectory() as d:
        for fmt, tol in [("cf32", 1e-7), ("cs16", 1e-4), ("cu8", 1e-2)]:
            p = os.path.join(d, f"x.{fmt}")
            iq_io.write_iq(p, iq, fmt)
            back = iq_io.read_iq(p)
            assert back.shape == iq.shape
            np.testing.assert_allclose(back, iq, rtol=0, atol=tol * 5)


def test_wav_roundtrip():
    x = np.sin(np.linspace(0, 100, 12500)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        for dtype, tol in [("float32", 1e-7), ("int16", 1e-4)]:
            p = os.path.join(d, f"a_{dtype}.wav")
            wav.write_wav(p, x, 12500, dtype=dtype)
            y, rate = wav.read_wav(p)
            assert rate == 12500
            np.testing.assert_allclose(y, x, atol=tol)


def test_scanner_app_cli(tmp_path):
    from sdr_pmr446_tpu.apps import sdr_pmr446 as app
    iqp = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp, _demo_iq(seconds=1.5))
    outp = str(tmp_path / "out.wav")
    rc = app.main(["--input", iqp, "--output", outp,
                   "--subchunks-per-step", "5", "-s", "18", "-p", "max"])
    assert rc == 0
    audio, rate = wav.read_wav(outp)
    assert rate == C.AUDIO_SAMPLERATE
    assert len(audio) > 0
    snr = synth.tone_snr_db(audio[2 * 1225:], 1000.0)
    assert snr > 25.0


def test_dsd_app_cli(tmp_path):
    from sdr_pmr446_tpu.apps import dsd_in as app
    n = 10 * C.SUBCHUNK_IN
    t = np.arange(n) / C.SDR_SAMPLERATE
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    iq = np.exp(1j * 2 * np.pi * (2000 * np.cumsum(msg) + 2500 * np.arange(n))
                / C.SDR_SAMPLERATE)
    iqp = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp, iq)
    outp = str(tmp_path / "out.raw")
    rc = app.main(["--input", iqp, "--output", outp,
                   "--subchunks-per-step", "5"])
    assert rc == 0
    pcm = np.fromfile(outp, dtype="<i2")
    assert len(pcm) == n * 3 // 64
    assert np.abs(pcm).max() > 1000


def test_driver_metrics_jsonl(tmp_path):
    import json
    p = str(tmp_path / "metrics.jsonl")
    iq = _demo_iq(seconds=1.0)
    drv = ScannerDriver(subchunks_per_step=5, metrics_path=p)
    drv.run(iq_io.block_stream(iq, drv.block_len))
    recs = [json.loads(l) for l in open(p)]
    assert len(recs) == len(iq) // C.SUBCHUNK_IN
    assert recs[-1]["active_chan"] == 4
    assert recs[-1]["ctcss_detected"] and recs[-1]["ctcss_code"] == 12
    assert any(r["events"] for r in recs)


def test_scanner_app_faithful_mode(tmp_path):
    from sdr_pmr446_tpu.apps import sdr_pmr446 as app
    iqp = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp, _demo_iq(seconds=1.5))
    outp = str(tmp_path / "out.wav")
    rc = app.main(["--input", iqp, "--output", outp, "--faithful",
                   "--subchunks-per-step", "5"])
    assert rc == 0
    audio, rate = wav.read_wav(outp)
    assert rate == C.AUDIO_SAMPLERATE and len(audio) > 0
    snr = synth.tone_snr_db(audio[2 * 1225:], 1000.0)
    assert snr > 25.0


def test_waterfall_rows_match_asgram_oracle():
    """Chain step-9 spectrogram rows == the per-sample streaming asgramcf
    emulation (liquid spgram semantics: sliding w/2 window, w/4 hop, per-
    sub-chunk periodogram average) fed with the SAME resampled band —
    including window continuity across block steps."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params
    from sdr_pmr446_tpu.oracle.chain import (dc_blocker_stream,
                                             PolyResamplerStream,
                                             AsgramStream)
    from sdr_pmr446_tpu.taps import design as D

    w = 64
    iq = _demo_iq(seconds=1.0)[: 4 * C.SUBCHUNK_IN]
    chain = ScannerChain(C.BlockConfig(2), waterfall=w)
    st = chain.init_state()
    params = make_runtime_params(C.ScannerArgs())
    rows = []
    for i in range(2):
        st, out = chain.step(
            st, jnp.asarray(iq[i * 2 * C.SUBCHUNK_IN:
                               (i + 1) * 2 * C.SUBCHUNK_IN], jnp.complex64),
            params)
        rows.append(np.asarray(out.waterfall))
    rows = np.concatenate(rows)                          # [4, 64]

    band = PolyResamplerStream(D.resampler_taps(), C.RESAMP_L,
                               C.RESAMP_M).process(
        dc_blocker_stream().process(iq.astype(np.complex128)))
    asg = AsgramStream(w)
    for k in range(4):
        asg.write(band[k * C.SUBCHUNK_RESAMP:(k + 1) * C.SUBCHUNK_RESAMP])
        ref = asg.execute()
        np.testing.assert_allclose(rows[k], ref, rtol=0, atol=1e-2)


def test_waterfall_width_validation():
    from sdr_pmr446_tpu.ops.spectrogram import validate_width, uses_fast_path
    import pytest as _pytest
    validate_width(0)            # off: fine
    validate_width(80)
    validate_width(64)
    validate_width(120)          # the reference README's own demo width
    validate_width(128)          # non-dividing hop: general path
    assert uses_fast_path(80) and not uses_fast_path(120)
    with _pytest.raises(ValueError):
        validate_width(50)       # not a multiple of 4
    with _pytest.raises(ValueError):
        validate_width(4 * C.SUBCHUNK_RESAMP + 4)   # hop > sub-chunk


def test_cli_audio_api_validation():
    """-b validated against the compiled + available API sets
    (reference: RtAudio API lookup, src/sdr_pmr446.c:234-257)."""
    from sdr_pmr446_tpu.apps.sdr_pmr446 import main
    from sdr_pmr446_tpu.io import audio as audio_io
    assert main(["-b", "bogus", "--seconds", "0.1"]) == 1
    assert main(["-b", "jack", "--seconds", "0.1"]) == 1
    # 'wav' is always compiled in and available
    assert "wav" in audio_io.list_apis()
    assert "dummy" in audio_io.list_apis()


def test_scanner_app_clean_cli_errors(tmp_path):
    """Bad flag values exit 1 with a logged error, not a traceback."""
    from sdr_pmr446_tpu.apps.sdr_pmr446 import main
    # waterfall width that is not a multiple of 4
    assert main(["-w", "50", "--seconds", "0.1"]) == 1
    # --resume pointing at a nonexistent checkpoint file
    assert main(["--resume", "--checkpoint", str(tmp_path / "nope.npz"),
                 "--seconds", "0.1"]) == 1
    # --resume pointing at a truncated/corrupt checkpoint
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"PK\x03\x04corrupt")
    assert main(["--resume", "--checkpoint", str(bad),
                 "--seconds", "0.1"]) == 1


def test_driver_checkpoint_resume_equals_uninterrupted(tmp_path):
    """Driver with periodic checkpoints, 'crashed' mid-capture and resumed
    from the checkpoint file, reproduces the uninterrupted run exactly."""
    import itertools
    iq = _demo_iq(seconds=2.0)
    args = C.ScannerArgs(lock_mode="max")

    ref = ScannerDriver(args, subchunks_per_step=5)
    full = ref.run(iq_io.block_stream(iq, ref.block_len))

    ckpt = str(tmp_path / "state.npz")
    drv1 = ScannerDriver(args, subchunks_per_step=5,
                         checkpoint_path=ckpt, checkpoint_every=1)
    n_blocks = len(iq) // drv1.block_len
    crash_at = n_blocks // 2
    part1 = drv1.run(itertools.islice(
        iq_io.block_stream(iq, drv1.block_len), crash_at))

    drv2 = ScannerDriver(args, subchunks_per_step=5,
                         checkpoint_path=ckpt, checkpoint_every=1)
    assert drv2.restore() == crash_at
    part2 = drv2.run(iq_io.block_stream(iq, drv2.block_len))

    got_audio = np.concatenate([part1.audio, part2.audio])
    np.testing.assert_array_equal(got_audio, full.audio)
    np.testing.assert_array_equal(
        np.concatenate([part1.active_trace, part2.active_trace]),
        full.active_trace)
    assert part1.events + part2.events == full.events


def test_driver_two_run_calls_consume_both_iterators():
    """Splitting a capture across two run() calls on ONE driver must equal
    a single run: the resume-skip is armed only by restore(), not by the
    driver having already processed blocks."""
    iq = _demo_iq(seconds=2.0)
    args = C.ScannerArgs(lock_mode="max")

    ref = ScannerDriver(args, subchunks_per_step=5)
    full = ref.run(iq_io.block_stream(iq, ref.block_len))

    drv = ScannerDriver(args, subchunks_per_step=5)
    half = (len(iq) // drv.block_len // 2) * drv.block_len
    p1 = drv.run(iq_io.block_stream(iq[:half], drv.block_len))
    p2 = drv.run(iq_io.block_stream(iq[half:], drv.block_len))
    np.testing.assert_array_equal(
        np.concatenate([p1.audio, p2.audio]), full.audio)
    np.testing.assert_array_equal(
        np.concatenate([p1.active_trace, p2.active_trace]),
        full.active_trace)
    assert p1.events + p2.events == full.events


def test_scanner_app_checkpoint_flags(tmp_path):
    from sdr_pmr446_tpu.apps import sdr_pmr446 as app
    iqp = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp, _demo_iq(seconds=1.0))
    ckpt = str(tmp_path / "st.npz")
    outp = str(tmp_path / "a.wav")
    rc = app.main(["--input", iqp, "--output", outp,
                   "--subchunks-per-step", "5", "--checkpoint", ckpt])
    assert rc == 0 and os.path.exists(ckpt)
    # resume from the final checkpoint: no further blocks to process
    rc = app.main(["--input", iqp, "--output", outp,
                   "--subchunks-per-step", "5", "--checkpoint", ckpt,
                   "--resume"])
    assert rc == 0
    assert app.main(["--resume", "--seconds", "0.1"]) == 1  # needs path


def test_scan_batch_app(tmp_path):
    """Data-parallel multi-capture CLI: 2 captures on a (2,1)/(2,4) mesh,
    per-capture audio + events; each capture's result matches a solo scan."""
    from sdr_pmr446_tpu.apps import scan_batch

    caps = []
    for s, (ch, code) in enumerate([(5, 12), (9, 20)]):
        iq = 0.8 * synth.make_scanner_iq(10 * C.SUBCHUNK_IN, channel=ch,
                                         ctcss_code=code, seed=s)
        pth = str(tmp_path / f"cap{s}.cs16")
        iq_io.write_iq(pth, iq, "cs16")
        caps.append(pth)

    outd = str(tmp_path / "scans")
    rc = scan_batch.main(caps + ["--out-dir", outd, "--mesh", "2,4",
                                 "--subchunks-per-step", "8",
                                 "--steps-per-dispatch", "2", "-w", "64"])
    assert rc == 0
    for s, (ch, code) in enumerate([(5, 12), (9, 20)]):
        wf = open(os.path.join(outd, f"cap{s}.waterfall.log")).read()
        lines = [ln for ln in wf.splitlines() if ln]
        # 10 real sub-chunks per capture: the zero-padded tail of the
        # final block must NOT produce fabricated spectrum rows
        assert len(lines) == 10 and all(
            ln.startswith(" > ") and "max SNR:" in ln for ln in lines)
        audio, rate = wav.read_wav(os.path.join(outd, f"cap{s}.wav"))
        assert rate == C.AUDIO_SAMPLERATE and len(audio) > 0
        # evaluate inside the capture's real 10 sub-chunks (the zero-padded
        # block tail demodulates to noise until the squelch detunes — the
        # same padded-tail artifact as the single-capture app)
        snr = synth.tone_snr_db(audio[2 * 1225:9 * 1225], 1000.0)
        assert snr > 25.0, (s, snr)
        evs = open(os.path.join(outd, f"cap{s}.events.log")).read()
        assert f"Tuned to channel {ch}" in evs
        assert f"Acquired CTCSS code: {code}" in evs


def test_scanner_app_device_decode_matches_host_decode(tmp_path):
    """--device-decode on a cs16 capture produces the exact same WAV as the
    host-converted run (decode parity end-to-end through the app)."""
    from sdr_pmr446_tpu.apps import sdr_pmr446 as app
    iqp = str(tmp_path / "cap.cs16")
    iq_io.write_iq(iqp, _demo_iq(seconds=1.5), "cs16")
    out_host = str(tmp_path / "host.wav")
    out_dev = str(tmp_path / "dev.wav")
    base = ["--input", iqp, "--subchunks-per-step", "5", "-p", "max"]
    assert app.main(base + ["--output", out_host]) == 0
    assert app.main(base + ["--output", out_dev, "--device-decode"]) == 0
    a_host, _ = wav.read_wav(out_host)
    a_dev, _ = wav.read_wav(out_dev)
    np.testing.assert_array_equal(a_host, a_dev)
    # cf32 captures ship as their byte-identical cf32w wire: same WAV
    # bit-exact (the app-reachable bench configuration, VERDICT r2 #3)
    iqp32 = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp32, _demo_iq(seconds=1.5))
    outs = []
    for extra in ([], ["--device-decode"]):
        o = str(tmp_path / f"f32_{len(extra)}.wav")
        assert app.main(["--input", iqp32, "--output", o,
                         "--subchunks-per-step", "5", "-p", "max"]
                        + extra) == 0
        outs.append(wav.read_wav(o)[0])
    np.testing.assert_array_equal(outs[0], outs[1])


def test_scan_batch_app_device_decode(tmp_path):
    """scan_batch --device-decode (raw bytes -> per-shard device decode)
    produces the exact same per-capture WAVs as the host-converted run."""
    from sdr_pmr446_tpu.apps import scan_batch

    caps = []
    for s, (ch, code) in enumerate([(5, 12), (9, 20)]):
        iq = 0.8 * synth.make_scanner_iq(10 * C.SUBCHUNK_IN, channel=ch,
                                         ctcss_code=code, seed=s)
        pth = str(tmp_path / f"cap{s}.cs16")
        iq_io.write_iq(pth, iq, "cs16")
        caps.append(pth)

    d_host = str(tmp_path / "host")
    d_dev = str(tmp_path / "dev")
    base = caps + ["--mesh", "2,4", "--subchunks-per-step", "8"]
    assert scan_batch.main(base + ["--out-dir", d_host]) == 0
    assert scan_batch.main(base + ["--out-dir", d_dev,
                                   "--device-decode"]) == 0
    for s in range(2):
        a, _ = wav.read_wav(os.path.join(d_host, f"cap{s}.wav"))
        b, _ = wav.read_wav(os.path.join(d_dev, f"cap{s}.wav"))
        np.testing.assert_array_equal(a, b)
    # mixed-format inputs reject the flag cleanly (cf32 alone is fine
    # now — it ships as cf32w)
    iqp32 = str(tmp_path / "c.cf32")
    iq_io.write_iq(iqp32, _demo_iq(seconds=0.5))
    assert scan_batch.main([caps[0], iqp32, "--device-decode",
                            "--out-dir", d_dev]) == 1


def test_dsd_app_survives_closed_pipe(tmp_path):
    """Reference parity: dsd_in pipes into dsd/play and exits gracefully
    when the consumer hangs up (ignored SIGPIPE, src/sdr_pmr446.c:190-199);
    the app must exit 0, not crash with BrokenPipeError."""
    import subprocess
    import sys as _sys
    iq = synth.make_scanner_iq(2 * C.SUBCHUNK_IN, channel=8)
    cap = os.path.join(tmp_path, "cap.cf32")
    iq_io.write_iq(cap, iq, "cf32")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    cmd = (f"{_sys.executable} -m sdr_pmr446_tpu.apps.dsd_in "
           f"--input {cap} --output - --subchunks-per-step 1 "
           f"| head -c 100 >/dev/null; exit ${{PIPESTATUS[0]}}")
    proc = subprocess.run(["/bin/bash", "-c", cmd], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "downstream pipe closed" in proc.stderr


def test_orbax_checkpoint_roundtrip_and_resume(tmp_path):
    """Orbax backend: bit-exact state roundtrip, and a driver resumed from
    an orbax checkpoint continues identically to the npz backend."""
    import itertools
    from sdr_pmr446_tpu.runtime.state import (save_state_orbax,
                                              load_state_orbax)
    iq = _demo_iq(seconds=1.5)
    args = C.ScannerArgs(lock_mode="max")

    ref = ScannerDriver(args, subchunks_per_step=5)
    full = ref.run(iq_io.block_stream(iq, ref.block_len))

    ckpt = str(tmp_path / "ck_orbax")
    drv1 = ScannerDriver(args, subchunks_per_step=5, checkpoint_path=ckpt,
                         checkpoint_every=1, checkpoint_backend="orbax")
    part1 = drv1.run(itertools.islice(
        iq_io.block_stream(iq, drv1.block_len), 1))

    # raw roundtrip is bit-exact
    bi, st = load_state_orbax(ckpt)
    assert bi == 1
    for a, b, name in zip(st, drv1.state, st._fields):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    save_state_orbax(str(tmp_path / "ck2"), bi, st)
    bi2, st2 = load_state_orbax(str(tmp_path / "ck2"))
    assert bi2 == bi
    for a, b in zip(st, st2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    drv2 = ScannerDriver(args, subchunks_per_step=5, checkpoint_path=ckpt,
                         checkpoint_backend="orbax")
    assert drv2.restore() == 1
    part2 = drv2.run(iq_io.block_stream(iq, drv2.block_len))
    np.testing.assert_array_equal(
        np.concatenate([part1.audio, part2.audio]), full.audio)
    assert part1.events + part2.events == full.events


def test_adapt_state_histories_migrates_lengths():
    """Checkpoints saved under one chain configuration restore into
    another whose *_hist lengths differ: longer targets are left-padded
    with zeros, shorter ones keep the newest suffix; any non-history
    shape mismatch is rejected loudly."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.runtime.state import (init_scanner_state,
                                              adapt_state_histories)
    src = init_scanner_state(384, 400, 100)
    src = src._replace(resamp_hist=jnp.arange(384).astype(jnp.complex64))
    tgt = init_scanner_state(512, 400, 100)

    up = adapt_state_histories(src, tgt)
    assert up.resamp_hist.shape == (512,)
    np.testing.assert_array_equal(np.asarray(up.resamp_hist[:128]), 0)
    np.testing.assert_array_equal(np.asarray(up.resamp_hist[128:]),
                                  np.arange(384))

    down = adapt_state_histories(up, src)
    np.testing.assert_array_equal(np.asarray(down.resamp_hist),
                                  np.asarray(src.resamp_hist))

    bad = src._replace(demod_prev=jnp.zeros((8,), jnp.complex64))
    try:
        adapt_state_histories(bad, tgt)
        assert False, "expected ValueError on non-history mismatch"
    except ValueError as e:
        assert "demod_prev" in str(e)


def test_driver_stop_request_resume_bitexact(tmp_path):
    """request_stop() (the SIGTERM/SIGQUIT path) stops at a block boundary
    with a FINAL checkpoint flush; resuming reproduces the uninterrupted
    run bit-exact — VERDICT r2 #6's acceptance criterion."""
    iq = _demo_iq(seconds=2.0)
    args = C.ScannerArgs(lock_mode="max")

    ref = ScannerDriver(args, subchunks_per_step=5)
    full = ref.run(iq_io.block_stream(iq, ref.block_len))

    # checkpoint_every=0: ONLY the stop-triggered final flush writes it
    ckpt = str(tmp_path / "sig.npz")
    drv1 = ScannerDriver(args, subchunks_per_step=5,
                         checkpoint_path=ckpt, checkpoint_every=0)

    def stopper(sub, o):
        if sub >= 7:
            drv1.request_stop()

    drv1.on_subchunk = stopper
    part1 = drv1.run(iq_io.block_stream(iq, drv1.block_len))
    assert drv1.stopped
    assert os.path.exists(ckpt)
    n_blocks = len(iq) // drv1.block_len
    assert 0 < drv1.block_index < n_blocks

    drv2 = ScannerDriver(args, subchunks_per_step=5,
                         checkpoint_path=ckpt, checkpoint_every=0)
    assert drv2.restore() == drv1.block_index
    part2 = drv2.run(iq_io.block_stream(iq, drv2.block_len))
    assert not drv2.stopped

    np.testing.assert_array_equal(
        np.concatenate([part1.audio, part2.audio]), full.audio)
    np.testing.assert_array_equal(
        np.concatenate([part1.active_trace, part2.active_trace]),
        full.active_trace)
    assert part1.events + part2.events == full.events


def test_scanner_app_sigterm_graceful(tmp_path):
    """A real SIGTERM to the running CLI exits cleanly (code 0), writes the
    partial WAV and the final checkpoint (reference signal parity,
    src/sdr_pmr446.c:779-786,190-199)."""
    import signal
    import subprocess

    out = str(tmp_path / "sig.wav")
    ckpt = str(tmp_path / "sig_app.npz")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdr_pmr446_tpu.apps.sdr_pmr446",
         "--seconds", "20", "--subchunks-per-step", "5",
         "--output", out, "--checkpoint", ckpt, "--checkpoint-every", "0",
         "-p", "max"],
        stderr=subprocess.PIPE, text=True, env=env, cwd=repo)
    seen = []
    try:
        # wait until the scan loop is demonstrably running, then TERM it
        tuned = False
        for line in proc.stderr:
            seen.append(line)
            if "Tuned to channel" in line:
                tuned = True
                break
        assert tuned, "scanner never tuned:\n" + "".join(seen)
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        seen.append(rest)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, "".join(seen)
    assert "Signal caught, exiting!" in rest
    assert "wrote" in rest and "audio samples" in rest
    assert os.path.exists(ckpt)
    x, sr = wav.read_wav(out)
    assert sr == C.AUDIO_SAMPLERATE and len(x) > 0


def test_waterfall_nondividing_widths_match_asgram_oracle():
    """Arbitrary-width waterfall (hop does NOT divide the sub-chunk, e.g.
    the reference README's own `-w 120` demo) matches the per-sample
    streaming asgramcf oracle, including hop-counter continuity across
    block steps — VERDICT r2 #2's acceptance criterion."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params
    from sdr_pmr446_tpu.oracle.chain import (dc_blocker_stream,
                                             PolyResamplerStream,
                                             AsgramStream)
    from sdr_pmr446_tpu.taps import design as D

    iq = _demo_iq(seconds=1.0)[: 4 * C.SUBCHUNK_IN]
    band = PolyResamplerStream(D.resampler_taps(), C.RESAMP_L,
                               C.RESAMP_M).process(
        dc_blocker_stream().process(iq.astype(np.complex128)))

    for w in (120, 96):
        chain = ScannerChain(C.BlockConfig(2), waterfall=w)
        st = chain.init_state()
        params = make_runtime_params(C.ScannerArgs())
        rows = []
        for i in range(2):
            st, out = chain.step(
                st, jnp.asarray(iq[i * 2 * C.SUBCHUNK_IN:
                                   (i + 1) * 2 * C.SUBCHUNK_IN],
                                jnp.complex64), params)
            rows.append(np.asarray(out.waterfall))
        rows = np.concatenate(rows)                       # [4, w]

        asg = AsgramStream(w)
        for k in range(4):
            asg.write(band[k * C.SUBCHUNK_RESAMP:
                           (k + 1) * C.SUBCHUNK_RESAMP])
            ref = asg.execute()
            np.testing.assert_allclose(rows[k], ref, rtol=0, atol=1e-2,
                                       err_msg=f"w={w} row {k}")


def test_driver_engine_selection(tmp_path):
    """The cf32w wire (a cf32 capture's own bytes, de-interleaved on
    device) through the driver gives exactly the cf32 scan."""
    iq = _demo_iq(seconds=0.5)[: 2 * C.SUBCHUNK_IN]
    ref = ScannerDriver(subchunks_per_step=2)
    a = ref.run(iq_io.block_stream(iq, ref.block_len))
    drv = ScannerDriver(subchunks_per_step=2, input_format="cf32w")
    wire = np.empty(2 * len(iq), np.float32)
    wire[0::2] = iq.real
    wire[1::2] = iq.imag
    assert drv.feed_len == 2 * drv.block_len
    b = drv.run(iq_io.block_stream(wire, drv.feed_len))
    np.testing.assert_array_equal(a.active_trace, b.active_trace)
    np.testing.assert_array_equal(a.audio, b.audio)
    assert a.events == b.events


def test_audio_sink_stalled_player_never_stalls_producer(tmp_path):
    """Reference ring semantics (src/sdr_pmr446.c:470,520-544): a stalled
    live player must not stall the scan loop.  Writing 10 s of audio into
    a sink whose 'player' never reads completes in a bounded fraction of
    real time, with the overflow dropped and a prompt close."""
    import time
    from sdr_pmr446_tpu.io.audio import AudioSink

    sink = AudioSink(C.AUDIO_SAMPLERATE, _argv=["sleep", "30"])
    try:
        chunk = np.zeros(1225, np.float32)
        t0 = time.monotonic()
        for _ in range(100):             # 10 s of audio (122500 samples)
            sink.write(chunk)
        took = time.monotonic() - t0
        assert took < 4.0, f"producer stalled for {took:.1f}s"
        assert sink.dropped > 0
        t1 = time.monotonic()
    finally:
        sink.close()
    assert time.monotonic() - t1 < 8.0
    assert sink.proc.poll() is not None  # the fake player was reaped


def test_audio_sink_healthy_player_gets_everything():
    """With a consuming player the sink drops nothing: ring backpressure
    paces the file-driven producer (the role the blocking SDR read plays
    in the reference) and the pump zero-fills only genuine underruns."""
    from sdr_pmr446_tpu.io.audio import AudioSink

    sink = AudioSink(C.AUDIO_SAMPLERATE,
                     _argv=["/bin/sh", "-c", "cat > /dev/null"])
    try:
        for _ in range(5):               # 0.49 s of audio
            sink.write(np.ones(1225, np.float32))
        assert sink.dropped == 0
    finally:
        sink.close()


def _read_outputs(outd, stems, waterfall=False):
    out = {}
    for st in stems:
        a, _ = wav.read_wav(os.path.join(outd, f"{st}.wav"))
        ev = open(os.path.join(outd, f"{st}.events.log")).read()
        wf = (open(os.path.join(outd, f"{st}.waterfall.log")).read()
              if waterfall else "")
        out[st] = (a, ev, wf)
    return out


def test_scan_batch_checkpoint_resume(tmp_path):
    """scan_batch --checkpoint/--resume: a gracefully stopped batch job
    (the SIGTERM path, via --stop-after) resumes from its checkpoint
    (both backends) and produces outputs IDENTICAL to an uninterrupted
    run — WAVs, event logs, and waterfall logs."""
    import pytest
    from sdr_pmr446_tpu.apps import scan_batch

    caps = []
    for s, (ch, code) in enumerate([(5, 12), (9, 20)]):
        iq = 0.8 * synth.make_scanner_iq(12 * C.SUBCHUNK_IN, channel=ch,
                                         ctcss_code=code, seed=s)
        pth = str(tmp_path / f"cap{s}.cs16")
        iq_io.write_iq(pth, iq, "cs16")
        caps.append(pth)
    base = caps + ["--mesh", "2,1", "--subchunks-per-step", "4", "-w", "64"]

    out_full = str(tmp_path / "full")
    assert scan_batch.main(base + ["--out-dir", out_full]) == 0
    ref = _read_outputs(out_full, ["cap0", "cap1"], waterfall=True)

    for backend in ("orbax", "npz"):
        ckpt = str(tmp_path / f"ck_{backend}")
        if backend == "npz":
            ckpt += ".npz"
        out_p = str(tmp_path / f"part_{backend}")
        rc = scan_batch.main(base + [
            "--out-dir", out_p, "--checkpoint", ckpt,
            "--checkpoint-backend", backend, "--stop-after", "1"])
        assert rc == 0
        assert os.path.exists(ckpt) and os.path.exists(ckpt + ".accum.npz")
        # the stopped run wrote PARTIAL outputs (1 of 3 blocks)
        part = _read_outputs(out_p, ["cap0", "cap1"], waterfall=True)
        assert len(part["cap0"][0]) < len(ref["cap0"][0])

        out_r = str(tmp_path / f"res_{backend}")
        rc = scan_batch.main(base + [
            "--out-dir", out_r, "--checkpoint", ckpt,
            "--checkpoint-backend", backend, "--resume"])
        assert rc == 0
        got = _read_outputs(out_r, ["cap0", "cap1"], waterfall=True)
        for st in ("cap0", "cap1"):
            np.testing.assert_array_equal(got[st][0], ref[st][0])
            assert got[st][1] == ref[st][1]
            assert got[st][2] == ref[st][2]

    # --resume without --checkpoint is a clean error
    assert scan_batch.main(base + ["--out-dir", out_r, "--resume"]) == 1
    # missing checkpoint file: clean error, no traceback
    assert scan_batch.main(base + [
        "--out-dir", out_r, "--checkpoint", str(tmp_path / "nope.npz"),
        "--checkpoint-backend", "npz", "--resume"]) == 1
    del pytest


def test_scan_batch_sigterm_resume(tmp_path):
    """A real SIGTERM to the running scan_batch CLI exits 0 with a final
    checkpoint flush; --resume then completes the batch with outputs
    identical to an uninterrupted run (kill-and-resume, VERDICT r4 #3)."""
    import signal
    import subprocess
    from sdr_pmr446_tpu.apps import scan_batch

    caps = []
    for s, (ch, code) in enumerate([(5, 12), (9, 20)]):
        iq = 0.8 * synth.make_scanner_iq(20 * C.SUBCHUNK_IN, channel=ch,
                                         ctcss_code=code, seed=s)
        pth = str(tmp_path / f"cap{s}.cs16")
        iq_io.write_iq(pth, iq, "cs16")
        caps.append(pth)
    base = caps + ["--subchunks-per-step", "4"]

    out_full = str(tmp_path / "full")
    assert scan_batch.main(base + ["--out-dir", out_full]) == 0
    ref = _read_outputs(out_full, ["cap0", "cap1"])

    ckpt = str(tmp_path / "kill.ck")
    out_k = str(tmp_path / "killed")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdr_pmr446_tpu.apps.scan_batch"] + base
        + ["--out-dir", out_k, "--checkpoint", ckpt],
        stderr=subprocess.PIPE, text=True, env=env, cwd=repo)
    seen = []
    try:
        hit = False
        for line in proc.stderr:
            seen.append(line)
            if "checkpoint at block" in line:
                hit = True
                break
        assert hit, "never checkpointed:\n" + "".join(seen)
        proc.send_signal(signal.SIGTERM)
        seen.append(proc.stderr.read())
        rc = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, "".join(seen)
    assert os.path.exists(ckpt + ".accum.npz")

    out_r = str(tmp_path / "resumed")
    assert scan_batch.main(base + ["--out-dir", out_r, "--checkpoint",
                                   ckpt, "--resume"]) == 0
    got = _read_outputs(out_r, ["cap0", "cap1"])
    for st in ("cap0", "cap1"):
        np.testing.assert_array_equal(got[st][0], ref[st][0])
        assert got[st][1] == ref[st][1]


def test_scan_batch_resume_geometry_guard(tmp_path):
    """Resuming a scan_batch checkpoint under a different block geometry
    or capture count is a clean error (the block-count seek would land
    mid-block), not silent corruption."""
    from sdr_pmr446_tpu.apps import scan_batch

    caps = []
    for s in range(2):
        iq = 0.8 * synth.make_scanner_iq(8 * C.SUBCHUNK_IN, channel=5,
                                         ctcss_code=12, seed=s)
        pth = str(tmp_path / f"gcap{s}.cs16")
        iq_io.write_iq(pth, iq, "cs16")
        caps.append(pth)
    ckpt = str(tmp_path / "g.npz")
    base = caps + ["--out-dir", str(tmp_path / "o"), "--checkpoint", ckpt,
                   "--checkpoint-backend", "npz"]
    assert scan_batch.main(base + ["--subchunks-per-step", "4",
                                   "--stop-after", "1"]) == 0
    # different K
    assert scan_batch.main(base + ["--subchunks-per-step", "8",
                                   "--resume"]) == 1
    # different capture count
    assert scan_batch.main([caps[0], "--out-dir", str(tmp_path / "o"),
                            "--checkpoint", ckpt, "--checkpoint-backend",
                            "npz", "--subchunks-per-step", "4",
                            "--resume"]) == 1
    # matching geometry still resumes fine
    assert scan_batch.main(base + ["--subchunks-per-step", "4",
                                   "--resume"]) == 0
