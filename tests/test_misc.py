"""Profiling utils, PLL design exploration, graft entry points."""

import numpy as np
import pytest


def test_throughput_meter():
    from sdr_pmr446_tpu.utils.profiling import ThroughputMeter
    m = ThroughputMeter(samples_per_block=1000)
    for _ in range(3):
        m.start()
        m.stop()
    r = m.report()
    assert r["blocks"] == 3 and r["samples_per_sec"] > 0


def test_pll_locks_on_tone():
    from sdr_pmr446_tpu.taps.pll_des import evaluate_on_tone
    res = evaluate_on_tone(code=12, amp=0.15, noise=0.02, seconds=1.0)
    assert res.locked_fraction > 0.9
    # tracks the tone frequency
    from sdr_pmr446_tpu import config as C
    f0 = C.CTCSS_FREQS[11]
    tail = res.freq_track[-2000:]
    assert abs(np.mean(tail) - f0) < 2.0


def test_pll_no_lock_on_noise():
    from sdr_pmr446_tpu.taps.pll_des import CtcssPLL
    rng = np.random.default_rng(0)
    x = 0.15 * rng.standard_normal(12500)
    res = CtcssPLL(94.8).run(x)
    assert res.locked_fraction < 0.5


def test_graft_entry_single():
    import __graft_entry__ as g
    import jax
    fn, args = g.entry()
    state, out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    # served entry = the cu8 wire at K=8 (see __graft_entry__.entry)
    assert np.asarray(out.active_chan).shape[0] == 8


def test_graft_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(4)


def test_record_app(tmp_path):
    from sdr_pmr446_tpu.apps import record as app
    from sdr_pmr446_tpu.io import iq as iq_io, synth, wav
    from sdr_pmr446_tpu import config as C
    # signal for first half only -> one tuned segment
    n = 10 * C.SUBCHUNK_IN
    sig1 = synth.make_scanner_iq(n, channel=5, ctcss_code=None)
    rng = np.random.default_rng(0)
    noise = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iqp = str(tmp_path / "cap.cf32")
    iq_io.write_iq(iqp, np.concatenate([sig1, noise]))
    rc = app.main(["--input", iqp, "--outdir", str(tmp_path),
                   "--subchunks-per-step", "5"])
    assert rc == 0
    wavs = sorted(tmp_path.glob("pmr446_*.wav"))
    assert len(wavs) == 1
    audio, rate = wav.read_wav(str(wavs[0]))
    assert rate == C.AUDIO_SAMPLERATE and len(audio) > 0


def test_filter_des_app(tmp_path):
    from sdr_pmr446_tpu.apps import filter_des as app
    rc = app.main(["--outdir", str(tmp_path / "d")])
    assert rc == 0
    import os
    files = os.listdir(tmp_path / "d")
    assert "ctcss_hp_response.csv" in files
    assert "deemph_iir_taps.csv" in files


def test_single_channel_chain():
    import jax.numpy as jnp
    from sdr_pmr446_tpu import config as C
    from sdr_pmr446_tpu.io import synth
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    chain = SingleChannelChain(channel=5, subchunks_per_step=5)
    n = 2 * chain.input_len
    iq = synth.make_scanner_iq(n, channel=5, ctcss_code=None)
    st = chain.init_state()
    parts = []
    for i in range(2):
        st, audio = chain.step(st, jnp.asarray(
            iq[i * chain.input_len:(i + 1) * chain.input_len], jnp.complex64))
        parts.append(np.asarray(audio))
    audio = np.concatenate(parts)
    assert len(audio) == n * 25 // 2048
    snr = synth.tone_snr_db(audio[4000:], 1000.0)
    assert snr > 35.0, f"single-channel tone SNR {snr:.1f}"


@pytest.mark.parametrize("fmt", ["cf32w", "cs16", "cu8", "cs8"])
def test_single_channel_wire_input_equals_host_decoded(fmt):
    """Raw wire words decoded on device == the chain fed the host-decoded
    samples of the same wire, bit for bit, streaming across steps."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.io import synth
    from sdr_pmr446_tpu.ops import decode
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    ref = SingleChannelChain(channel=5, subchunks_per_step=4)
    pkd = SingleChannelChain(channel=5, subchunks_per_step=4,
                             input_format=fmt)
    raw = decode.pack_iq(0.8 * synth.make_scanner_iq(
        2 * ref.input_len, channel=5, ctcss_code=12), fmt)
    wl = pkd.step_arg_len
    st1, st2 = ref.init_state(), pkd.init_state()
    for i in range(2):
        w = jnp.asarray(raw[i * wl:(i + 1) * wl])
        st1, a1 = ref.step(st1, decode.decode_complex(w, fmt))
        st2, a2 = pkd.step(st2, w)
        np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))


def test_transfer_fetch_roundtrip():
    import jax.numpy as jnp
    from sdr_pmr446_tpu.runtime.transfer import fetch
    tree = {"a": jnp.arange(5, dtype=jnp.int32),
            "b": jnp.ones(3, jnp.complex64) * (1 + 2j),
            "c": jnp.asarray(True),
            "d": jnp.linspace(0, 1, 4)}
    out = fetch(tree)
    assert out["a"].dtype == np.int32
    np.testing.assert_array_equal(out["a"], np.arange(5))
    assert out["b"].dtype == np.complex64
    np.testing.assert_allclose(out["b"], (1 + 2j) * np.ones(3))
    assert out["c"].dtype == np.bool_ and bool(out["c"])


def test_profiler_trace_context(tmp_path):
    import jax.numpy as jnp
    from sdr_pmr446_tpu.utils import profiling
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        _ = jnp.sum(jnp.arange(128.0)).block_until_ready()
    import os
    assert os.path.isdir(d) and len(os.listdir(d)) > 0


def test_metrics_jsonl(tmp_path):
    from sdr_pmr446_tpu.utils.profiling import log_jsonl
    import json
    p = str(tmp_path / "m.jsonl")
    log_jsonl(p, {"subchunk": 1, "rssi": -42.0})
    log_jsonl(p, {"subchunk": 2, "rssi": -40.0})
    recs = [json.loads(l) for l in open(p)]
    assert len(recs) == 2 and recs[1]["subchunk"] == 2


def test_audio_sink_gating():
    from sdr_pmr446_tpu.io import audio
    # just exercise the availability probe; the sink itself needs a device
    assert isinstance(audio.available(), bool)


def test_waterfall_render_row_scaling():
    from sdr_pmr446_tpu.ui.waterfall import render_row, CHARSET, DB_REF
    # at the reference level the lowest char; 2 dB per step up the ramp
    db = np.array([DB_REF, DB_REF + 2.0, DB_REF + 2.0 * (len(CHARSET) - 1),
                   DB_REF + 100.0, DB_REF - 50.0])
    row = render_row(db)
    assert row[0] == CHARSET[0]
    assert row[1] == CHARSET[1]
    assert row[2] == CHARSET[-1]
    assert row[3] == CHARSET[-1]      # clipped high
    assert row[4] == CHARSET[0]       # clipped low


def test_block_config_geometry():
    from sdr_pmr446_tpu import config as C
    b = C.BlockConfig(subchunks_per_step=7)
    assert b.input_len == 7 * C.SUBCHUNK_IN
    assert b.resamp_len == b.input_len * 25 // 128
    assert b.audio_len == b.resamp_len // 16
    # the FSM cadence stays within 1% of the reference's 97.66 ms
    assert abs(C.SUBCHUNK_IN / C.SDR_SAMPLERATE - 0.09766) < 1e-3


def test_channel_center_frequencies():
    from sdr_pmr446_tpu.io.synth import channel_center_hz
    # PMR446 channel plan: ch1 = 446.00625 MHz, 12.5 kHz spacing
    assert channel_center_hz(1) == 446_006_250.0
    assert channel_center_hz(16) == 446_193_750.0
    assert channel_center_hz(9) - channel_center_hz(8) == 12_500.0
