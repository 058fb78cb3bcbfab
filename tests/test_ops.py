"""Differential tests: each JAX block op vs the per-sample NumPy oracle.

This is the SciPy/NumPy-oracle differential strategy of SURVEY.md §4 —
every op must match a straightforward sequential implementation, including
streaming across block boundaries (the carried-state/overlap-save machinery).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.ops import fir, iir, fm
from sdr_pmr446_tpu.ops.resample import PolyResampler
from sdr_pmr446_tpu.ops.pfb import PFBChannelizer
from sdr_pmr446_tpu.oracle import chain as oracle
from sdr_pmr446_tpu.taps import design as D

RNG = np.random.default_rng(42)


def _blocks(x, n):
    size = len(x) // n
    return [x[i * size:(i + 1) * size] for i in range(n)]


class TestFir:
    def test_matches_convolve_and_streams(self):
        taps = RNG.standard_normal(33)
        x = RNG.standard_normal(4 * 256).astype(np.float32)
        ref = oracle.FirStream(taps).process(x)

        hist = fir.fir_init(33)
        outs = []
        for blk in _blocks(x, 4):
            hist, y = fir.fir_apply(hist, jnp.asarray(blk), jnp.asarray(taps, jnp.float32))
            outs.append(np.asarray(y))
        got = np.concatenate(outs)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

    def test_batched_channels(self):
        taps = RNG.standard_normal(17)
        x = RNG.standard_normal((3, 512)).astype(np.float32)
        hist = fir.fir_init(17, channels=3)
        _, y = fir.fir_apply(hist, jnp.asarray(x), jnp.asarray(taps, jnp.float32))
        for c in range(3):
            ref = oracle.FirStream(taps).process(x[c])
            np.testing.assert_allclose(np.asarray(y[c]), ref, atol=1e-4)

    def test_complex_input(self):
        taps = RNG.standard_normal(21)
        x = (RNG.standard_normal(256) + 1j * RNG.standard_normal(256)).astype(np.complex64)
        _, y = fir.fir_apply(fir.fir_init(21, dtype=jnp.complex64),
                             jnp.asarray(x), jnp.asarray(taps, jnp.float32))
        ref = oracle.FirStream(taps, dtype=np.complex128).process(x)
        np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4)

    def test_delay(self):
        x = RNG.standard_normal(300).astype(np.float32)
        ref = oracle.DelayStream(7).process(x)
        hist = fir.delay_init(7)
        outs = []
        for blk in _blocks(x, 3):
            hist, y = fir.delay_apply(hist, jnp.asarray(blk))
            outs.append(np.asarray(y))
        np.testing.assert_allclose(np.concatenate(outs), ref, atol=0)


class TestIir:
    @pytest.mark.parametrize("chunk", [16, 100, 1024, 5000])
    def test_first_order_scan_exact(self, chunk):
        t = 3000
        z = RNG.standard_normal(t).astype(np.float32)
        p = 0.9995
        y0 = 0.3
        ref = np.empty(t)
        acc = y0
        for n in range(t):
            acc = p * acc + z[n]
            ref[n] = acc
        got = np.asarray(iir.first_order_scan(jnp.asarray(z), p,
                                              jnp.float32(y0), chunk=chunk))
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-4)

    def test_dc_blocker_streaming_complex(self):
        x = (RNG.standard_normal(3000) + 0.5
             + 1j * (RNG.standard_normal(3000) - 0.2)).astype(np.complex64)
        ref = oracle.dc_blocker_stream().process(x.astype(np.complex128))
        st = (jnp.zeros((), jnp.complex64), jnp.zeros((), jnp.complex64))
        outs = []
        for blk in _blocks(x, 3):
            st, y = iir.dc_blocker_apply(st, jnp.asarray(blk))
            outs.append(np.asarray(y))
        got = np.concatenate(outs)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)

    def test_dc_blocker_removes_dc(self):
        x = jnp.ones(20000, jnp.float32) * 3.0
        st = (jnp.zeros(()), jnp.zeros(()))
        _, y = iir.dc_blocker_apply(st, x)
        assert abs(float(y[-1])) < 0.05

    def test_batched(self):
        x = RNG.standard_normal((4, 500)).astype(np.float32)
        st = iir.biquad1_init(channels=4)
        _, y = iir.biquad1_apply(st, jnp.asarray(x), 0.5, 0.5, 0.0146)
        for c in range(4):
            ref = oracle.FirstOrderIIRStream(0.5, 0.5, 0.0146).process(x[c])
            np.testing.assert_allclose(np.asarray(y[c]), ref, atol=1e-4)


class TestResampler:
    def test_matches_oracle_streaming(self):
        res = PolyResampler(D.resampler_taps(), C.RESAMP_L, C.RESAMP_M)
        x = (RNG.standard_normal(4 * 2048)
             + 1j * RNG.standard_normal(4 * 2048)).astype(np.complex64)
        ref = oracle.PolyResamplerStream(D.resampler_taps(), C.RESAMP_L,
                                         C.RESAMP_M).process(x)
        hist = res.init()
        outs = []
        for blk in _blocks(x, 4):
            hist, y = res.apply(hist, jnp.asarray(blk))
            outs.append(np.asarray(y))
        got = np.concatenate(outs)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

    def test_tone_preserved(self):
        # a 50 kHz tone must come through the resampler at unity gain
        res = PolyResampler(D.resampler_taps(), C.RESAMP_L, C.RESAMP_M)
        n = 16 * 2048
        t = np.arange(n) / C.SDR_SAMPLERATE
        x = np.exp(2j * np.pi * 50e3 * t).astype(np.complex64)
        _, y = res.apply(res.init(), jnp.asarray(x))
        y = np.asarray(y)[2000:]
        assert abs(np.mean(np.abs(y)) - 1.0) < 0.01

    def test_upsampler_real(self):
        # dsd_in's 48k/12.5k real upsampler uses the same machinery (L=96, M=25)
        taps = D.resampler_taps(L=96, M=25, att_db=60.0, fs_in=12500.0,
                                passband_hz=5000.0, stopband_hz=6200.0)
        res = PolyResampler(taps, 96, 25)
        x = RNG.standard_normal(4 * 25 * 8).astype(np.float32)
        ref = oracle.PolyResamplerStream(taps, 96, 25).process(
            x.astype(np.complex128)).real
        hist = res.init(dtype=jnp.float32)
        _, y = res.apply(hist, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), ref, rtol=0, atol=1e-4)


class TestPfb:
    def test_matches_oracle_streaming(self):
        pfb = PFBChannelizer(D.pfb_prototype())
        n = 4 * 1600
        x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(np.complex64)
        ref = oracle.PFBChannelizerStream(D.pfb_prototype()).process(x)
        st = pfb.init()
        outs = []
        for blk in _blocks(x, 4):
            st, y = pfb.apply(st, jnp.asarray(blk))
            outs.append(np.asarray(y))
        got = np.concatenate(outs, axis=1)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)

    @pytest.mark.parametrize("channel", range(1, C.NUM_CHANNELS + 1))
    def test_tone_lands_on_channel(self, channel):
        # a tone at PMR channel n's center must appear in channelizer bin n-1
        # at near-unity magnitude, and ~nothing anywhere else.
        from sdr_pmr446_tpu.io import synth
        n = 32 * 2048
        fs = C.SDR_RESAMPLERATE
        f_off = (synth.channel_center_hz(channel) - C.SDR_FREQUENCY)
        t = np.arange(n) / fs
        x = np.exp(2j * np.pi * f_off * t).astype(np.complex64)
        pfb = PFBChannelizer(D.pfb_prototype())
        _, y = pfb.apply(pfb.init(), jnp.asarray(x))
        y = np.asarray(y)[:, 100:]
        mags = np.mean(np.abs(y), axis=1)
        assert np.argmax(mags) == channel - 1
        assert abs(mags[channel - 1] - 1.0) < 0.05
        others = np.delete(mags, channel - 1)
        assert np.all(others < 1e-3)


class TestFm:
    def test_matches_oracle(self):
        n = 2000
        msg = np.sin(2 * np.pi * 800 * np.arange(n) / C.AUDIO_SAMPLERATE)
        x = np.exp(1j * np.pi * C.FM_KF * 2 * np.cumsum(msg)).astype(np.complex64)
        ref = oracle.FreqDemStream().process(x.astype(np.complex128))
        prev = fm.fm_init()
        outs = []
        for blk in _blocks(x, 4):
            prev, y = fm.fm_demod(prev, jnp.asarray(blk))
            outs.append(np.asarray(y))
        got = np.concatenate(outs)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
        # demod recovers the message (skip first sample: zero-prev transient)
        np.testing.assert_allclose(got[1:], msg[1:], rtol=0, atol=1e-2)


class TestDecode:
    """On-device wire-format decode == host io/iq.py converters, bit-exact."""

    @pytest.mark.parametrize("fmt", ["cs16", "cu8", "cs8"])
    def test_decode_matches_host_reader(self, fmt, tmp_path):
        from sdr_pmr446_tpu.ops import decode
        from sdr_pmr446_tpu.io import iq as iq_io
        rng = np.random.default_rng(3)
        n = 4096
        if fmt == "cs16":
            raw = rng.integers(-32768, 32768, 2 * n).astype(np.int16)
        elif fmt == "cs8":
            raw = rng.integers(-128, 128, 2 * n).astype(np.int8)
        else:
            raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
        path = str(tmp_path / f"cap.{fmt}")
        raw.tofile(path)
        want = iq_io.read_iq(path)
        packed = decode.pack_bytes(raw, fmt)
        assert packed.dtype == np.float32
        xr, xi = decode.decode_planes(jnp.asarray(packed), fmt)
        np.testing.assert_array_equal(np.asarray(xr), want.real)
        np.testing.assert_array_equal(np.asarray(xi), want.imag)
        z = decode.decode_complex(jnp.asarray(packed), fmt)
        np.testing.assert_array_equal(np.asarray(z), want)

    @pytest.mark.parametrize("fmt", ["cs16", "cu8", "cs8"])
    def test_pack_iq_roundtrip(self, fmt):
        from sdr_pmr446_tpu.ops import decode
        rng = np.random.default_rng(4)
        iq = (0.7 * (rng.standard_normal(1024) + 1j *
                     rng.standard_normal(1024))).astype(np.complex64)
        packed = decode.pack_iq(np.clip(iq.real, -0.99, 0.99) +
                                1j * np.clip(iq.imag, -0.99, 0.99), fmt)
        z = np.asarray(decode.decode_complex(jnp.asarray(packed), fmt))
        tol = {"cs16": 1.0 / 32768.0, "cu8": 1.0 / 127.5,
               "cs8": 1.0 / 128.0}[fmt]
        np.testing.assert_allclose(z.real, np.clip(iq.real, -0.99, 0.99),
                                   atol=tol)
        np.testing.assert_allclose(z.imag, np.clip(iq.imag, -0.99, 0.99),
                                   atol=tol)


def test_decode_fuzz_all_byte_values():
    """Device decode == host converters over RANDOM wire bytes covering
    the full value range of every packed format (not just quantized
    signal fixtures) — including extreme/boundary byte patterns."""
    import numpy as np
    import jax.numpy as jnp
    from sdr_pmr446_tpu.ops import decode
    from sdr_pmr446_tpu.io import native

    rng = np.random.default_rng(123)
    for fmt in ("cs16", "cu8", "cs8"):
        dtype = decode.WIRE_DTYPE[fmt]
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max + 1, 4096, dtype=dtype)
        # force the boundary values in
        raw[:4] = [info.min, info.max, 0, info.max if fmt == "cu8" else -1]
        want = native.convert_iq(raw, fmt)
        packed = decode.pack_bytes(raw, fmt)
        got = np.asarray(decode.decode_complex(jnp.asarray(packed), fmt))
        np.testing.assert_array_equal(got, want.astype(np.complex64),
                                      err_msg=fmt)
