"""Single-channel NBFM monitor chain.

Fixed-tune demodulation of ONE PMR channel from the 1.024 Msps band capture:
resample to 200 kHz, mix the chosen channel to baseband (closed-form phase
ramp — no NCO state), 16x decimating channel filter, NBFM discriminator,
CTCSS-removal highpass, de-emphasis.  This is the scanner's audio path
without the squelch FSM/PFB — the minimum end-to-end slice of SURVEY.md §7
step 3, kept as a first-class config for benchmarking and fixed-channel
monitoring.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.taps import design as D
from sdr_pmr446_tpu.ops import fir, iir, fm
from sdr_pmr446_tpu.ops import decode as decode_op
from sdr_pmr446_tpu.ops.resample import PolyResampler


@functools.lru_cache(maxsize=None)
def channel_filter_taps() -> tuple:
    """16x decimating channel-select lowpass at 200 kHz (6.25 kHz half-band)."""
    h = D.resampler_taps(L=1, M=16, att_db=80.0,
                         fs_in=float(C.SDR_RESAMPLERATE),
                         passband_hz=5600.0, stopband_hz=6900.0)
    return tuple(h.tolist())


class SingleState(NamedTuple):
    dc_x: jax.Array
    dc_y: jax.Array
    res_hist: jax.Array
    ch_hist: jax.Array
    fm_prev: jax.Array
    hp_hist: jax.Array
    deemph_hist: jax.Array
    n0: jax.Array          # global 200 kHz sample index (mod 32) for the mixer


class SingleChannelChain:
    """(state, iq[T]) -> (state, audio[T*25/2048]) for one fixed channel.

    ``input_format`` other than "cf32" takes the capture's raw wire bytes
    packed as f32 words and decodes on device (ops/decode.py), the same
    contract as the scanner chain."""

    def __init__(self, channel: int, subchunks_per_step: int = 10,
                 audio_gain: float = C.SDR_DEFAULT_AUDIO_GAIN,
                 input_format: str = "cf32"):
        if not 1 <= channel <= C.NUM_CHANNELS:
            raise ValueError(f"channel must be 1..{C.NUM_CHANNELS}")
        self.channel = channel
        self.audio_gain = audio_gain
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        if input_format != "cf32" and \
                input_format not in decode_op.PACKED_FORMATS:
            raise ValueError(f"unsupported input_format: {input_format!r}")
        self.input_format = input_format
        self.res = PolyResampler(D.resampler_taps(), C.RESAMP_L, C.RESAMP_M)
        self.chf = PolyResampler(np.asarray(channel_filter_taps()), 1,
                                 C.NUM_CHANNELS)
        self.hp_taps = D.ctcss_hp_taps().astype(np.float32)
        self.deemph_taps = D.deemph_fir_equiv().astype(np.float32)
        # mixer: shift channel k to baseband at 200 kHz.  offset of channel
        # center from band center = (k-1)*12.5k - 93.75k, a multiple of
        # 6.25 kHz = fs/32, so the phase ramp e^{-j w n} has period 32
        # samples: a 32-entry table indexed mod 32 is exact.
        f_off = (channel - 1) * C.CHANNEL_WIDTH_HZ - 93_750.0
        self.omega = 2.0 * np.pi * f_off / C.SDR_RESAMPLERATE
        self.phase_period = 32
        from sdr_pmr446_tpu.runtime.fuse import fused_steps
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))
        self._multi_step = fused_steps(self._step_impl)

    @property
    def step_arg_len(self) -> int:
        if self.input_format == "cf32":
            return self.input_len
        return decode_op.packed_len(self.input_len, self.input_format)

    def init_state(self):
        return SingleState(
            dc_x=jnp.zeros((), jnp.complex64),
            dc_y=jnp.zeros((), jnp.complex64),
            res_hist=self.res.init(),
            ch_hist=self.chf.init(),
            fm_prev=fm.fm_init(),
            hp_hist=fir.fir_init(C.HP_AUDIO_FILT_TAPS),
            deemph_hist=fir.fir_init(self.deemph_taps.shape[0]),
            n0=jnp.zeros((), jnp.int32),
        )

    def step(self, state, iq: jax.Array):
        return self._step(state, iq)

    def multi_step(self, state, iqs: jax.Array):
        """S stacked blocks in one dispatch; audio flattened to [S*T_audio]
        — equal to S step() calls within f32 rounding (runtime/fuse.py)."""
        return self._multi_step(state, iqs)

    def _step_impl(self, state, iq: jax.Array):
        if self.input_format != "cf32":
            iq = decode_op.decode_complex(iq, self.input_format)
        (dc_x, dc_y), x = iir.dc_blocker_apply(
            (state.dc_x, state.dc_y), iq, C.DC_BLOCK_ALPHA)
        rh, band = self.res.apply(state.res_hist, x)
        # closed-form mixer phase: e^{-j w (n0 + n)}; w is a multiple of
        # 2*pi/32 (offsets are multiples of fs/32 = 6.25 kHz), so a 32-entry
        # table indexed mod 32 is exact
        t_band = band.shape[-1]
        tab = jnp.asarray(np.exp(
            -1j * self.omega
            * np.arange(self.phase_period)).astype(np.complex64))
        idx = (jnp.arange(t_band, dtype=jnp.int32)
               + state.n0) % self.phase_period
        mixed = band * tab[idx]
        ch_h, sig_ch = self.chf.apply(state.ch_hist, mixed)
        fm_prev, audio = fm.fm_demod(state.fm_prev, sig_ch)
        hp_h, audio = fir.fir_apply(state.hp_hist, audio, self.hp_taps)
        audio = audio * self.audio_gain
        de_h, audio = fir.fir_apply(state.deemph_hist, audio,
                                    self.deemph_taps)
        n0 = (state.n0 + t_band) % self.phase_period
        new_state = SingleState(dc_x, dc_y, rh, ch_h, fm_prev, hp_h, de_h, n0)
        return new_state, audio
