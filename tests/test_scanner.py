"""End-to-end scanner tests vs the reference-semantics oracle.

Synthetic golden-IQ fixtures (SURVEY.md §4): NBFM voice + CTCSS on known
channels, AWGN floor.  The JAX chain must reproduce the oracle's control
behavior (tune/detune/channel/CTCSS decisions, per sub-chunk) exactly, and
its audio within an SNR bound away from transition transients.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.oracle.chain import ScannerOracle, GoertzelDetector
from sdr_pmr446_tpu.scanner.chain import (ScannerChain, make_runtime_params)


def run_chain(iq, args=None, subchunks_per_step=5, **chain_kw):
    args = args or C.ScannerArgs()
    chain = ScannerChain(C.BlockConfig(subchunks_per_step),
                         lowpass=args.lowpass, fir_deemph=args.fir_deemph,
                         **chain_kw)
    params = make_runtime_params(args)
    state = chain.init_state()
    outs = []
    step_len = chain.block.input_len
    assert len(iq) % step_len == 0
    for i in range(len(iq) // step_len):
        state, out = chain.step(
            state, jnp.asarray(iq[i * step_len:(i + 1) * step_len],
                               jnp.complex64), params)
        outs.append(out)
    cat = lambda f: np.concatenate([np.asarray(getattr(o, f)) for o in outs])
    return state, {f: cat(f) for f in outs[0]._fields}, chain


class TestGoertzelReformulation:
    """The windowed-DFT |sum x e^{-jwk}|^2 identity vs the per-sample bank."""

    def test_power_identity(self):
        rng = np.random.default_rng(1)
        n = C.CTCSS_BLOCK_SIZE
        x = (0.2 * np.sin(2 * np.pi * 110.9 * np.arange(n) / 12500)
             + 0.05 * rng.standard_normal(n))
        g = GoertzelDetector()
        g.analyze(x)
        w = 2 * np.pi * np.asarray(C.CTCSS_FREQS) / 12500
        dft = np.abs(np.exp(-1j * np.outer(w, np.arange(n))) @ x) ** 2
        np.testing.assert_allclose(dft, g.power, rtol=1e-6, atol=1e-6)


class TestScannerE2E:
    def _mk_iq(self, seconds=3.0, channel=5, ctcss_code=12, **kw):
        n_sub = int(round(seconds * C.SDR_SAMPLERATE / C.SUBCHUNK_IN))
        n_sub -= n_sub % 5          # multiple of subchunks_per_step
        n = n_sub * C.SUBCHUNK_IN
        return synth.make_scanner_iq(n, channel=channel,
                                     ctcss_code=ctcss_code, **kw)

    def test_tunes_detects_and_matches_oracle(self):
        iq = self._mk_iq(seconds=3.0, channel=5, ctcss_code=12)
        ora = ScannerOracle()
        ora.process(iq)
        state, outs, _ = run_chain(iq)

        # control behavior matches the oracle sub-chunk by sub-chunk
        np.testing.assert_array_equal(outs["active_chan"],
                                      np.asarray(ora.active_trace))
        assert outs["active_chan"][-1] == 4            # tuned to channel 5
        assert outs["ev_tuned"].sum() == 1
        kinds = [e.kind for e in ora.events]
        assert "tuned" in kinds and "ctcss_acquired" in kinds

        # CTCSS: correct code detected, stays detected
        det = outs["ct_detected"]
        idx = outs["ct_max_idx"]
        assert det[-1] and idx[-1] == 11               # code 12 (0-based 11)
        assert outs["ev_ct_acquired"].sum() == 1
        # detection trajectory matches oracle exactly
        # (oracle records per-subchunk state via events only; compare final)
        assert bool(ora.goertzel.tone_detected) == bool(det[-1])
        assert ora.goertzel.max_power_index == idx[-1]

        # absolute per-channel RSSI matches find_max inputs
        np.testing.assert_allclose(
            outs["rssi_db"], np.stack(ora.rssi_trace), rtol=0, atol=0.05)
        np.testing.assert_allclose(
            outs["rel_rssi"][-1], ora.rssi, rtol=0, atol=0.05)

    def test_audio_matches_oracle_snr(self):
        iq = self._mk_iq(seconds=3.0, channel=5, ctcss_code=12)
        ora = ScannerOracle()
        ora.process(iq)
        _, outs, _ = run_chain(iq)

        # assemble both audio streams over tuned sub-chunks
        valid = outs["audio_valid"]
        jax_audio = outs["audio"][valid]
        ora_audio = np.stack(ora.audio)
        assert jax_audio.shape == ora_audio.shape
        # skip the tune transient (filters settle within ~2 sub-chunks)
        j = jax_audio[2:].ravel()
        o = ora_audio[2:].ravel()
        err = j - o
        snr = 10 * np.log10(np.mean(o ** 2) / max(np.mean(err ** 2), 1e-30))
        assert snr > 40.0, f"audio SNR vs oracle too low: {snr:.1f} dB"

        # and the audio is the expected demodulated tone
        tone_snr = synth.tone_snr_db(j, 1000.0)
        assert tone_snr > 30.0, f"tone SNR {tone_snr:.1f} dB"

    def test_squelch_stays_scanning_on_noise(self):
        n = 15 * C.SUBCHUNK_IN
        rng = np.random.default_rng(3)
        iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
              ).astype(np.complex128)
        _, outs, _ = run_chain(iq)
        assert np.all(outs["active_chan"] == -1)
        assert not outs["audio_valid"].any()
        ora = ScannerOracle()
        ora.process(iq)
        np.testing.assert_array_equal(outs["active_chan"],
                                      np.asarray(ora.active_trace))

    def test_detune_on_signal_drop(self):
        # signal present for first half, then noise -> tune then detune
        iq1 = self._mk_iq(seconds=1.5, channel=3, ctcss_code=None)
        n2 = len(iq1)
        rng = np.random.default_rng(4)
        iq2 = 1e-3 * (rng.standard_normal(n2) + 1j * rng.standard_normal(n2))
        iq = np.concatenate([iq1, iq2])
        ora = ScannerOracle()
        ora.process(iq)
        _, outs, _ = run_chain(iq)
        np.testing.assert_array_equal(outs["active_chan"],
                                      np.asarray(ora.active_trace))
        assert outs["ev_tuned"].sum() == 1
        assert outs["ev_detuned"].sum() == 1
        assert outs["active_chan"][-1] == -1

    def test_channel_mask_excludes(self):
        # mask out channel 5 (reference -m semantics: listed channels cleared)
        args = C.ScannerArgs(channel_mask=C.parse_channel_mask("5"))
        iq = self._mk_iq(seconds=1.5, channel=5, ctcss_code=None)
        _, outs, _ = run_chain(iq, args=args)
        assert np.all(outs["active_chan"] != 4)
        ora = ScannerOracle(args)
        ora.process(iq)
        np.testing.assert_array_equal(outs["active_chan"],
                                      np.asarray(ora.active_trace))

    def test_lock_mode_max_switches(self):
        # ch 2 strong first, then ch 7 stronger: lock_mode=max must switch
        half = self._mk_iq(seconds=1.5, channel=2, amplitude=0.5,
                           ctcss_code=None)
        n = len(half)
        strong = synth.make_scanner_iq(n, channel=7, amplitude=1.0,
                                       tone_hz=700.0, seed=9,
                                       start_sample=n)
        weak2 = synth.make_scanner_iq(n, channel=2, amplitude=0.5,
                                      tone_hz=1000.0, seed=10,
                                      start_sample=n)
        iq = np.concatenate([half, weak2 + strong])
        args = C.ScannerArgs(lock_mode="max")
        ora = ScannerOracle(args)
        ora.process(iq)
        _, outs, _ = run_chain(iq, args=args)
        np.testing.assert_array_equal(outs["active_chan"],
                                      np.asarray(ora.active_trace))
        assert outs["ev_changed"].sum() >= 1
        assert outs["active_chan"][-1] == 6

    def test_checkpoint_resume(self):
        from sdr_pmr446_tpu.runtime import state as S
        iq = self._mk_iq(seconds=2.0, channel=5, ctcss_code=12)
        # run full
        _, outs_full, chain = run_chain(iq)
        # run half, checkpoint, restore, run rest
        step_len = chain.block.input_len
        params = make_runtime_params(C.ScannerArgs())
        st = chain.init_state()
        half_steps = len(iq) // step_len // 2
        outs1 = []
        for i in range(half_steps):
            st, o = chain.step(st, jnp.asarray(
                iq[i * step_len:(i + 1) * step_len], jnp.complex64), params)
            outs1.append(o)
        import tempfile, os
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "ckpt.npz")
            S.save_state(p, half_steps, st)
            idx, st2 = S.load_state(p)
        assert idx == half_steps
        outs2 = []
        for i in range(half_steps, len(iq) // step_len):
            st2, o = chain.step(st2, jnp.asarray(
                iq[i * step_len:(i + 1) * step_len], jnp.complex64), params)
            outs2.append(o)
        audio_resumed = np.concatenate(
            [np.asarray(o.audio) for o in outs1 + outs2])
        np.testing.assert_allclose(audio_resumed, outs_full["audio"],
                                   rtol=0, atol=1e-6)


class TestVariants:
    def _iq(self, seconds=2.0):
        n = int(seconds * C.SDR_SAMPLERATE)
        n -= n % (5 * C.SUBCHUNK_IN)
        return synth.make_scanner_iq(n, channel=5, ctcss_code=12)

    def _compare(self, args):
        iq = self._iq()
        ora = ScannerOracle(args)
        ora.process(iq)
        _, outs, _ = run_chain(iq, args=args)
        np.testing.assert_array_equal(outs["active_chan"],
                                      np.asarray(ora.active_trace))
        j = outs["audio"][outs["audio_valid"]][2:].ravel()
        o = np.stack(ora.audio)[2:].ravel()
        snr = 10 * np.log10(np.mean(o ** 2)
                            / max(np.mean((j - o) ** 2), 1e-30))
        return snr

    def test_lowpass_variant(self):
        snr = self._compare(C.ScannerArgs(lowpass=True))
        assert snr > 40.0, f"lowpass variant SNR {snr:.1f}"

    def test_fir_deemph_variant(self):
        snr = self._compare(C.ScannerArgs(fir_deemph=True))
        assert snr > 40.0, f"fir-deemph variant SNR {snr:.1f}"

    def test_audio_gain_and_squelch(self):
        snr = self._compare(C.ScannerArgs(audio_gain=2.5, squelch_level=12.0))
        assert snr > 40.0


def test_step_size_invariance():
    """Outputs must not depend on how many sub-chunks one jitted step packs
    (the state carry is exact): K=5 vs K=10 give identical streams."""
    iq = synth.make_scanner_iq(20 * C.SUBCHUNK_IN, channel=5, ctcss_code=12)
    _, o5, _ = run_chain(iq, subchunks_per_step=5)
    _, o10, _ = run_chain(iq, subchunks_per_step=10)
    np.testing.assert_array_equal(o5["active_chan"], o10["active_chan"])
    np.testing.assert_array_equal(o5["ct_detected"], o10["ct_detected"])
    # fp reassociation across different conv batch extents gives ~1e-4 dB
    np.testing.assert_allclose(o5["rssi_db"], o10["rssi_db"],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(o5["audio"], o10["audio"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("fmt", ["cs16", "cu8", "cf32w"])
def test_packed_input_chain_equals_cf32(fmt):
    """Chain fed RAW wire bytes (decoded on device, ops/decode.py) is
    bit-identical to the cf32 chain fed the host-converted samples.
    cf32w is the lossless case: the f32 wire bytes ARE the complex64
    capture."""
    from sdr_pmr446_tpu.ops import decode
    k = 3
    n = 2 * C.BlockConfig(k).input_len
    iq = synth.make_scanner_iq(n, channel=5, ctcss_code=12)
    packed = decode.pack_iq(iq, fmt)                 # quantized wire bytes
    xr, xi = decode.decode_planes(jnp.asarray(packed), fmt)
    host_iq = (np.asarray(xr) + 1j * np.asarray(xi)).astype(np.complex64)

    params = make_runtime_params(C.ScannerArgs())
    ref_chain = ScannerChain(C.BlockConfig(k))
    pkd_chain = ScannerChain(C.BlockConfig(k), input_format=fmt)
    assert pkd_chain.step_arg_len == n // 2 // decode.PACKED_FORMATS[fmt]
    st_r, st_p = ref_chain.init_state(), pkd_chain.init_state()
    wlen = pkd_chain.step_arg_len
    for i in range(2):
        st_r, o_r = ref_chain.step(
            st_r, jnp.asarray(host_iq[i * ref_chain.input_len:
                                      (i + 1) * ref_chain.input_len]),
            params)
        st_p, o_p = pkd_chain.step(
            st_p, jnp.asarray(packed[i * wlen:(i + 1) * wlen]), params)
        for f in o_r._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(o_r, f)), np.asarray(getattr(o_p, f)),
                err_msg=f"{fmt} field {f} step {i}")


_ORACLE_CACHE: dict = {}


def _wire_capture_and_oracle(fmt):
    """(wire words, host-decoded complex capture, oracle) for a 16
    sub-chunk channel-5/CTCSS-12 capture quantized to ``fmt``; the oracle
    runs on exactly the samples the device decodes.  Cached per format:
    the K=1 and K=8 cases share one oracle run."""
    if fmt not in _ORACLE_CACHE:
        from sdr_pmr446_tpu.ops import decode
        iq = 0.8 * synth.make_scanner_iq(16 * C.SUBCHUNK_IN, channel=5,
                                         ctcss_code=12)
        if fmt == "cf32":
            wire = iq.astype(np.complex64)
            host = wire
        else:
            wire = decode.pack_iq(iq, fmt)
            xr, xi = decode.decode_planes(jnp.asarray(wire), fmt)
            host = (np.asarray(xr) + 1j * np.asarray(xi)).astype(
                np.complex64)
        ora = ScannerOracle()
        ora.process(host.astype(np.complex128))
        _ORACLE_CACHE[fmt] = (wire, ora)
    return _ORACLE_CACHE[fmt]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("fmt", ["cf32", "cf32w", "cs16", "cu8", "cs8"])
def test_wire_formats_match_oracle(fmt, k):
    """Every wire the apps feed (cf32 host-converted, cf32w/cs16/cu8/cs8
    decoded on device), at the real-time cadence K=1 and at K=8: the
    sub-chunk control trace equals the float64 oracle's exactly, the
    CTCSS code is identified, and the audio is within the 40 dB gate."""
    wire, ora = _wire_capture_and_oracle(fmt)
    chain = ScannerChain(C.BlockConfig(k), input_format=fmt)
    params = make_runtime_params(C.ScannerArgs())
    st = chain.init_state()
    wl = chain.step_arg_len
    outs = []
    for i in range(len(wire) // wl):
        st, o = chain.step(st, jnp.asarray(wire[i * wl:(i + 1) * wl]),
                           params)
        outs.append(o)
    cat = lambda f: np.concatenate([np.asarray(getattr(o, f))
                                    for o in outs])
    np.testing.assert_array_equal(cat("active_chan"),
                                  np.asarray(ora.active_trace))
    assert cat("ct_detected")[-1] and cat("ct_max_idx")[-1] == 11
    j = cat("audio")[cat("audio_valid")][2:].ravel()
    o = np.stack(ora.audio)[2:].ravel()
    snr = 10 * np.log10(np.mean(o ** 2) / max(np.mean((j - o) ** 2), 1e-30))
    assert snr > 40.0, f"{fmt} K={k}: audio SNR vs oracle {snr:.1f} dB"
