"""dsd_in: wideband-FM front-end for external digital-voice decoders.

A re-design of the reference's second app (src/dsd_in.c:95-180):

    IQ @1.024 Msps -> DC block -> resample to 12.5 kHz (60 dB)
    -> freqdem(0.5) -> real resample UP to 48 kHz -> s16le

The reference's single msresamp 12.5k/1.024M (ratio 1/81.92) is realized as
the spec-equivalent two-stage polyphase cascade (liquid's msresamp is itself
multi-stage internally): 25/128 to 200 kHz, then a 16x decimating lowpass —
both written as strided convolutions.  The upsampler is the same polyphase
machinery at 96/25.

Note: the reference has a stack-buffer overflow here (buf_out_s sized
res_size=4884 but written with ~18750 samples, src/dsd_in.c:142,172-175 —
SURVEY.md §3.4).  This implementation sizes everything statically from the
block geometry, making that class of bug structurally impossible.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.taps import design as D
from sdr_pmr446_tpu.ops import iir, fm
from sdr_pmr446_tpu.ops import decode as decode_op
from sdr_pmr446_tpu.ops.resample import PolyResampler

DSD_AUDIO_RATE = 48_000
DSD_SIG_RATE = 12_500


@functools.lru_cache(maxsize=None)
def stage2_taps() -> tuple:
    """16x decimating lowpass at 200 kHz: pass 5.2 kHz, stop 6.9 kHz, 60 dB."""
    h = D.resampler_taps(L=1, M=16, att_db=60.0,
                         fs_in=float(C.SDR_RESAMPLERATE),
                         passband_hz=5200.0, stopband_hz=6900.0)
    return tuple(h.tolist())


@functools.lru_cache(maxsize=None)
def up_taps() -> tuple:
    """96/25 audio upsampler taps (12.5 kHz -> 48 kHz, 60 dB)."""
    h = D.resampler_taps(L=96, M=25, att_db=60.0, fs_in=float(DSD_SIG_RATE),
                         passband_hz=5000.0, stopband_hz=6200.0)
    return tuple(h.tolist())


class DsdState(NamedTuple):
    dc_x: jax.Array
    dc_y: jax.Array
    res1_hist: jax.Array
    res2_hist: jax.Array
    fm_prev: jax.Array
    up_hist: jax.Array


class DsdOutputs(NamedTuple):
    pcm: jax.Array        # i16 [T_in * 3 // 64]  48 kHz s16le audio


class DsdInChain:
    """Jittable block step: (state, iq[T]) -> (state', s16 pcm [T*3/64])."""

    def __init__(self, subchunks_per_step: int = 10,
                 input_format: str = "cf32"):
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        assert self.input_len % C.INPUT_GRANULE == 0
        # "cs16"/"cu8": step takes raw wire bytes packed as f32 words and
        # decodes on device (ops/decode.py) — same contract as ScannerChain
        self.input_format = input_format
        if input_format != "cf32" and \
                input_format not in decode_op.PACKED_FORMATS:
            raise ValueError(f"unsupported input_format: {input_format!r}")
        self.res1 = PolyResampler(D.resampler_taps(), C.RESAMP_L, C.RESAMP_M)
        self.res2 = PolyResampler(np.asarray(stage2_taps()), 1, 16)
        self.up = PolyResampler(np.asarray(up_taps()), 96, 25)
        self.output_len = self.input_len * 3 // 64
        from sdr_pmr446_tpu.runtime.fuse import fused_steps
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))
        self._multi_step = fused_steps(self._step_impl)

    @property
    def step_arg_len(self) -> int:
        if self.input_format == "cf32":
            return self.input_len
        return decode_op.packed_len(self.input_len, self.input_format)

    def init_state(self):
        return DsdState(
            dc_x=jnp.zeros((), jnp.complex64),
            dc_y=jnp.zeros((), jnp.complex64),
            res1_hist=self.res1.init(),
            res2_hist=self.res2.init(),
            fm_prev=fm.fm_init(),
            up_hist=self.up.init(dtype=jnp.float32),
        )

    def step(self, state, iq: jax.Array):
        return self._step(state, iq)

    def multi_step(self, state, iqs: jax.Array):
        """S stacked blocks in one dispatch; pcm flattened to [S*out_len]
        — equal to S step() calls within 1 int16 LSB (runtime/fuse.py)."""
        return self._multi_step(state, iqs)

    def _step_impl(self, state, iq: jax.Array):
        if self.input_format != "cf32":
            iq = decode_op.decode_complex(iq, self.input_format)
        (dc_x, dc_y), x = iir.dc_blocker_apply(
            (state.dc_x, state.dc_y), iq, C.DC_BLOCK_ALPHA)
        r1, band = self.res1.apply(state.res1_hist, x)       # 200 kHz
        r2, sig = self.res2.apply(state.res2_hist, band)     # 12.5 kHz
        fm_prev, audio = fm.fm_demod(state.fm_prev, sig)     # 12.5 kHz f32
        uh, out48 = self.up.apply(state.up_hist, audio)      # 48 kHz
        pcm = jnp.clip(out48 * 32767.0, -32768.0, 32767.0).astype(jnp.int16)
        new_state = DsdState(dc_x, dc_y, r1, r2, fm_prev, uh)
        return new_state, DsdOutputs(pcm=pcm)
