"""Per-sample NumPy oracle of the reference signal chain.

A deliberately slow, obviously-correct emulation of the reference C app's
semantics (stateful per-sample objects, same structure as liquid-dsp usage in
src/sdr_pmr446.c / src/dsd_in.c) using the *same filter taps* as the JAX
chain.  It is the differential-test target for every JAX op and for the
end-to-end scanner:

  - streaming FIR / delay / one-pole IIR     (firfilt_rrrf, wdelayf, iirfilt)
  - polyphase rational resampler             (msresamp_crcf spec)
  - NCO mixer + PFB channelizer              (nco_crcf + firpfbch_crcf)
  - quadrature FM discriminator              (freqdem)
  - Goertzel CTCSS detector                  (src/sdr_pmr446.c:338-418)
  - squelch FSM + audio path                 (src/sdr_pmr446.c:827-908)

Everything is float64 NumPy; the JAX chain is float32 — tests bound the
difference in SNR terms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.taps import design as D


# ----------------------------------------------------------------------------
# Streaming primitives
# ----------------------------------------------------------------------------

class FirStream:
    """Per-sample streaming causal FIR (firfilt_* equivalent)."""

    def __init__(self, taps: np.ndarray, dtype=np.float64):
        self.taps = np.asarray(taps, dtype=np.float64)
        self.hist = np.zeros(len(self.taps) - 1, dtype=dtype)

    def process(self, x: np.ndarray) -> np.ndarray:
        xe = np.concatenate([self.hist, np.asarray(x)])
        y = np.convolve(xe, self.taps, mode="full")[
            len(self.taps) - 1: len(self.taps) - 1 + len(x)]
        if len(self.taps) > 1:
            self.hist = xe[-(len(self.taps) - 1):]
        return y


class DelayStream:
    """wdelayf equivalent: y[n] = x[n - d]."""

    def __init__(self, d: int, dtype=np.float64):
        self.hist = np.zeros(d, dtype=dtype)

    def process(self, x: np.ndarray) -> np.ndarray:
        xe = np.concatenate([self.hist, np.asarray(x)])
        y = xe[: len(x)]
        self.hist = xe[len(x):]
        return y


class FirstOrderIIRStream:
    """y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1], sequential (scipy lfilter+zi)."""

    def __init__(self, b0: float, b1: float, a1: float, dtype=np.float64):
        self.b = np.array([b0, b1], dtype=np.float64)
        self.a = np.array([1.0, a1], dtype=np.float64)
        self.zi = np.zeros(1, dtype=dtype)

    def process(self, x: np.ndarray) -> np.ndarray:
        import scipy.signal as _sig
        y, self.zi = _sig.lfilter(self.b, self.a, np.asarray(x), zi=self.zi)
        return y


def dc_blocker_stream(alpha: float = C.DC_BLOCK_ALPHA) -> FirstOrderIIRStream:
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    return FirstOrderIIRStream(g, -g, -p)


class PolyResamplerStream:
    """Direct polyphase L/M resampler (same math as ops/resample.py).

    y[j] = sum_{i=0}^{P-1} x[q-i] h[i L + r], q=floor(jM/L), r=(jM)%L,
    with x having an implicit zero history (x[n]=0 for n<0).
    Processes blocks whose length is a multiple of M.
    """

    def __init__(self, taps: np.ndarray, L: int, M: int):
        self.h = np.asarray(taps, dtype=np.float64)
        self.L, self.M = L, M
        self.P = len(self.h) // L
        self.hist = np.zeros(self.P - 1, dtype=np.complex128)
        self.phases = [self.h[r::L][::-1] for r in range(L)]
        # phases[r][i'] = h[(P-1-i')*L + r]; dot with x[q-P+1 .. q]

    def process(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        T = len(x)
        assert T % self.M == 0
        xe = np.concatenate([self.hist, x])          # index q -> xe[q + P-1]
        nout = T * self.L // self.M
        y = np.empty(nout, dtype=xe.dtype)
        windows = np.lib.stride_tricks.sliding_window_view(xe, self.P)
        j = np.arange(nout)
        q = (j * self.M) // self.L
        r = (j * self.M) % self.L
        for rr in range(self.L):                     # vectorized per phase
            sel = r == rr
            y[sel] = windows[q[sel]] @ self.phases[rr]
        self.hist = xe[-(self.P - 1):]
        return y


class PFBChannelizerStream:
    """Per-frame mixer + analyzer (nco_crcf + firpfbch_crcf equivalent).

    Mixes x by exp(+j*w_mix*t) (the reference's mix_down with a negative NCO
    frequency, src/sdr_pmr446.c:430-434,808-812), then for each frame of M
    samples emits y[k] = e^{-j w_k s} * sum_m h[m] e^{j w_k m} x~[s-m] with s
    the global index of the frame's last sample — channel k+1 at baseband.
    """

    def __init__(self, prototype: np.ndarray, M: int = C.NUM_CHANNELS,
                 mix_omega: float = C.MIX_OMEGA):
        self.h = np.asarray(prototype, dtype=np.float64)
        self.M = M
        self.mix_omega = mix_omega
        self.n_taps = len(self.h)
        self.hist = np.zeros(self.n_taps - M, dtype=np.complex128)
        self.t0 = 0  # global index of next input sample
        k = np.arange(M)
        m = np.arange(self.n_taps)
        self.emk = np.exp(1j * 2 * np.pi * np.outer(k, m) / M)  # e^{j w_k m}

    def process(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        T = len(x)
        assert T % self.M == 0
        t = self.t0 + np.arange(T)
        xm = x * np.exp(1j * self.mix_omega * t)
        xe = np.concatenate([self.hist, xm])
        F = T // self.M
        # window f = xe[16f : 16f + n_taps]; sum_m h[m] e^{j w_k m} x~[s-m]
        # with x~[s-m] = window[n_taps-1-m]; s = 16(f+n0)+15 -> the e^{-j w_k s}
        # phase factor reduces to e^{-j w_k * 15} (k * 16 f is an integer
        # number of turns).
        windows = np.lib.stride_tricks.sliding_window_view(
            xe, self.n_taps)[:: self.M][:F]                     # [F, n_taps]
        kern = (self.h * self.emk)[:, ::-1]                     # [M, n_taps]
        acc = windows @ kern.T                                  # [F, M]
        phase = np.exp(-1j * 2 * np.pi * np.arange(self.M)
                       * (self.M - 1) / self.M)
        out = (acc * phase).T
        self.hist = xe[-(self.n_taps - self.M):]
        self.t0 += T
        return out


class FreqDemStream:
    """liquid freqdem equivalent; reset() zeroes the previous sample."""

    def __init__(self, kf: float = C.FM_KF):
        self.kf = kf
        self.prev = 0.0 + 0.0j

    def reset(self):
        self.prev = 0.0 + 0.0j

    def process(self, x: np.ndarray) -> np.ndarray:
        xp = np.concatenate([[self.prev], np.asarray(x)[:-1]])
        d = x * np.conj(xp)
        self.prev = x[-1]
        return np.angle(d) / (2.0 * math.pi * self.kf)


class GoertzelDetector:
    """Faithful CTCSS Goertzel bank (src/sdr_pmr446.c:338-409)."""

    def __init__(self, block_size: int = C.CTCSS_BLOCK_SIZE,
                 fs: float = float(C.AUDIO_SAMPLERATE)):
        self.N = block_size
        self.freqs = np.asarray(C.CTCSS_FREQS)
        self.coef = 2.0 * np.cos(2.0 * np.pi * self.freqs / fs)
        self.reset()

    def reset(self):
        self.u0 = np.zeros(len(self.freqs))
        self.u1 = np.zeros(len(self.freqs))
        self.power = np.zeros(len(self.freqs))
        self.samp_processed = 0
        self.max_power = 0.0
        self.max_power_index = 0
        self.tone_detected = False

    def analyze(self, xs: np.ndarray):
        for v in np.asarray(xs):
            t = self.u0.copy()
            self.u0 = v + self.coef * self.u0 - self.u1
            self.u1 = t
            self.samp_processed += 1
            if self.samp_processed == self.N:
                self.power = (self.u0 ** 2 + self.u1 ** 2
                              - self.coef * self.u0 * self.u1)
                self.u0[:] = 0.0
                self.u1[:] = 0.0
                avg = float(np.mean(self.power))
                self.max_power_index = int(np.argmax(self.power))
                self.max_power = float(self.power[self.max_power_index])
                self.tone_detected = (
                    avg > C.CTCSS_AVG_POWER_THRESH
                    and (self.max_power / avg) > C.CTCSS_MAX_AVG_RATIO_THRESH)
                self.samp_processed = 0


# ----------------------------------------------------------------------------
# Full scanner oracle
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class OracleEvent:
    subchunk: int
    kind: str          # tuned|detuned|changed|ctcss_acquired|ctcss_changed|ctcss_lost
    channel: int = -1
    prev_channel: int = -1
    ctcss_code: int = -1


class ScannerOracle:
    """Reference-semantics scanner: per-sub-chunk FSM, single active channel,
    shared (gated) audio filters — mirrors src/sdr_pmr446.c:788-931."""

    def __init__(self, args: Optional[C.ScannerArgs] = None,
                 subchunk_in: int = C.SUBCHUNK_IN):
        self.args = args or C.ScannerArgs()
        self.subchunk_in = subchunk_in
        self.dcblock = dc_blocker_stream()
        self.resamp = PolyResamplerStream(D.resampler_taps(), C.RESAMP_L,
                                          C.RESAMP_M)
        self.pfb = PFBChannelizerStream(D.pfb_prototype())
        self.fm = FreqDemStream()
        self.hp = FirStream(D.ctcss_hp_taps())
        self.delay = DelayStream(C.CTCSS_DELAY)
        self.ctcss_dc = dc_blocker_stream()
        if self.args.fir_deemph:
            self.deemph = FirStream(D.deemph_fir_taps())
        else:
            b, a = D.deemph_iir_coeffs()
            self.deemph = FirstOrderIIRStream(b[0], b[1], a[1])
        self.lp = FirStream(D.audio_lp_taps())
        self.goertzel = GoertzelDetector()
        self.state = "scanning"
        self.active_chan = -1
        self.rssi = 0.0
        self.ctcss_freq = -1.0
        self.subchunk = 0
        self.events: List[OracleEvent] = []
        self.audio: List[np.ndarray] = []
        self.audio_subchunks: List[int] = []
        self.rssi_trace: List[np.ndarray] = []
        self.active_trace: List[int] = []

    # -- reference helpers ---------------------------------------------------

    def _average_power(self, x: np.ndarray) -> float:
        return 20.0 * math.log10(max(float(np.mean(np.abs(x))), 1e-30))

    def _find_max_rssi(self, chan: np.ndarray):
        """(max_i, rel_rssi) per src/sdr_pmr446.c:668-700."""
        max_i, rssi_max, rssi_avg, ch_en = -1, 0.0, 0.0, 0
        for i in range(C.NUM_CHANNELS):
            if self.args.channel_mask & (1 << i):
                ch_en += 1
                r = self._average_power(chan[i])
                rssi_avg += r
                if max_i >= 0:
                    if r > rssi_max:
                        rssi_max, max_i = r, i
                else:
                    rssi_max, max_i = r, i
        rel = rssi_max - rssi_avg / ch_en if max_i >= 0 else 0.0
        return max_i, rel

    def _ctcss_execute(self, x: np.ndarray):
        """src/sdr_pmr446.c:605-628."""
        x = self.ctcss_dc.process(x)
        prev_status = self.goertzel.tone_detected
        prev_code = self.goertzel.max_power_index
        self.goertzel.analyze(x)
        self.ctcss_freq = float(C.CTCSS_FREQS[self.goertzel.max_power_index])
        g = self.goertzel
        if g.tone_detected:
            if not prev_status:
                self.events.append(OracleEvent(
                    self.subchunk, "ctcss_acquired",
                    ctcss_code=g.max_power_index + 1))
            elif prev_code != g.max_power_index:
                self.events.append(OracleEvent(
                    self.subchunk, "ctcss_changed",
                    ctcss_code=g.max_power_index + 1))
        elif prev_status:
            self.events.append(OracleEvent(self.subchunk, "ctcss_lost"))

    # -- main per-sub-chunk processing --------------------------------------

    def process(self, iq: np.ndarray):
        """Process IQ in sub-chunks of ``subchunk_in`` samples."""
        iq = np.asarray(iq, dtype=np.complex128)
        assert len(iq) % self.subchunk_in == 0
        for s in range(len(iq) // self.subchunk_in):
            self._process_subchunk(
                iq[s * self.subchunk_in:(s + 1) * self.subchunk_in])

    def _process_subchunk(self, buf: np.ndarray):
        a = self.args
        buf = self.dcblock.process(buf)
        res = self.resamp.process(buf)
        chan = self.pfb.process(res)                  # [16, ns]
        ns = chan.shape[1]

        max_ch, rel = self._find_max_rssi(chan)
        if self.state == "scanning":
            self.rssi = rel
            if rel > a.squelch_level:
                self.active_chan = max_ch
                self.state = "tuned"
                self.events.append(OracleEvent(self.subchunk, "tuned",
                                               channel=max_ch))
        elif self.state == "tuned":
            self.rssi = rel
            if a.lock_mode == "max" and self.active_chan != max_ch:
                self.events.append(OracleEvent(
                    self.subchunk, "changed", channel=max_ch,
                    prev_channel=self.active_chan))
                self.active_chan = max_ch
            if self.rssi < a.squelch_level - C.SQUELCH_HYSTERESIS_DB:
                self.events.append(OracleEvent(self.subchunk, "detuned",
                                               channel=self.active_chan))
                self.active_chan = -1
                self.state = "scanning"
                self.ctcss_freq = 0.0
                self.fm.reset()
                self.goertzel.reset()

        if self.active_chan >= 0:
            tmp1 = self.fm.process(chan[self.active_chan])
            tmp2 = self.hp.process(tmp1)
            delayed = self.delay.process(tmp1)
            lp_branch = delayed - tmp2
            tmp2 = tmp2 * a.audio_gain
            self._ctcss_execute(lp_branch)
            tmp2 = self.deemph.process(tmp2)
            if a.lowpass:
                tmp2 = self.lp.process(tmp2)
            self.audio.append(tmp2)
            self.audio_subchunks.append(self.subchunk)

        self.rssi_trace.append(np.array(
            [self._average_power(chan[i]) for i in range(C.NUM_CHANNELS)]))
        self.active_trace.append(self.active_chan)
        self.subchunk += 1


class DsdInOracle:
    """Reference-semantics dsd_in chain (src/dsd_in.c:159-180) in float64."""

    def __init__(self):
        from sdr_pmr446_tpu.scanner.dsd_in import stage2_taps, up_taps
        self.dcblock = dc_blocker_stream()
        self.res1 = PolyResamplerStream(D.resampler_taps(), C.RESAMP_L,
                                        C.RESAMP_M)
        self.res2 = PolyResamplerStream(np.asarray(stage2_taps()), 1, 16)
        self.fm = FreqDemStream()
        self.up = PolyResamplerStream(np.asarray(up_taps()), 96, 25)

    def process(self, iq: np.ndarray) -> np.ndarray:
        x = self.dcblock.process(np.asarray(iq, np.complex128))
        band = self.res1.process(x)
        sig = self.res2.process(band)
        audio = self.fm.process(sig)
        out48 = self.up.process(audio.astype(np.complex128)).real
        return np.clip(out48 * 32767.0, -32768.0, 32767.0)


class AsgramStream:
    """Per-sample streaming asgramcf emulation (liquid spgram semantics).

    FFT size w, window length w/2, hop w/4 (spgram_create_default's
    geometry): every hop, the windowed last-w/2 samples are zero-padded to
    w and their periodogram accumulated; execute() returns the fftshifted
    dB average since the previous execute (what asgramcf_execute prints,
    src/sdr_pmr446.c:910-919).  Window/normalization documented in
    ops/spectrogram.py; this class is the differential-test target for it.
    """

    def __init__(self, w: int):
        self.w = w
        self.wl = w // 2
        self.delay = w // 4
        win = np.hamming(self.wl + 1)[: self.wl]
        self.win = win / np.sum(win)
        self.buf = np.zeros(self.wl, np.complex128)
        self.acc = np.zeros(w, np.float64)
        self.n_transforms = 0
        self.counter = 0

    def write(self, x: np.ndarray) -> None:
        for s in np.asarray(x, np.complex128):
            self.buf = np.roll(self.buf, -1)
            self.buf[-1] = s
            self.counter += 1
            if self.counter == self.delay:
                self.counter = 0
                seg = self.buf * self.win
                spec = np.fft.fft(seg, n=self.w)
                self.acc += np.abs(spec) ** 2
                self.n_transforms += 1

    def execute(self) -> np.ndarray:
        p = self.acc / max(self.n_transforms, 1)
        self.acc = np.zeros(self.w, np.float64)
        self.n_transforms = 0
        return np.fft.fftshift(10.0 * np.log10(np.maximum(p, 1e-30)))
