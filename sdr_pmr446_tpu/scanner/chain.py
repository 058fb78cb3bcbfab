"""The full 16-channel PMR446 scanner as one jittable block step.

An inversion of the reference's pull-based main loop
(src/sdr_pmr446.c:788-931) into a pure function

    (state, iq_block[T_in], runtime_params) -> (state', StepOutputs)

where every per-sample stage runs densely over the whole block (and over ALL
16 channels — selecting the active channel afterwards is cheaper on an
accelerator than branching, SURVEY.md §7 "hard parts"), and only the per-sub-chunk squelch/
CTCSS decisions run as a lax.scan.

Documented deviations from the reference (all transition transients, bounded
by one filter length per tune/detune/channel-change event; steady-state
output is equivalent):
  - freqdem, HP/LP/de-emphasis filters and the CTCSS-branch DC blocker run
    continuously per channel instead of being fed only the active channel's
    gated stream, so after a transition their histories hold the same
    channel's recent samples rather than the previous channel's stale ones.
  - de-emphasis runs as its exact-to-f32 FIR expansion (the reference itself
    ships a FIR de-emphasis variant, src/sdr_pmr446.c:42-44,457-465).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.taps import design as D
from sdr_pmr446_tpu.ops import fir, iir, fm, rssi as rssi_op, spectrogram
from sdr_pmr446_tpu.ops import decode as decode_op
from sdr_pmr446_tpu.ops.resample import PolyResampler
from sdr_pmr446_tpu.ops.pfb import PFBChannelizer
from sdr_pmr446_tpu.runtime.state import ScannerState, init_scanner_state
from sdr_pmr446_tpu.scanner.fsm import FsmCarry, fsm_ctcss_scan_v3


class RuntimeParams(NamedTuple):
    """Traced runtime knobs (no recompile when they change)."""
    squelch_level: jax.Array   # f32 []
    audio_gain: jax.Array      # f32 []
    channel_mask: jax.Array    # bool [16]
    lock_max: jax.Array        # bool []


def make_runtime_params(args: C.ScannerArgs) -> RuntimeParams:
    mask = np.array([(args.channel_mask >> i) & 1 for i in
                     range(C.NUM_CHANNELS)], dtype=bool)
    return RuntimeParams(
        squelch_level=jnp.float32(args.squelch_level),
        audio_gain=jnp.float32(args.audio_gain),
        channel_mask=jnp.asarray(mask),
        lock_max=jnp.asarray(args.lock_mode == "max"),
    )


class StepOutputs(NamedTuple):
    audio: jax.Array          # f32 [K, ns]  active channel audio per sub-chunk
    audio_valid: jax.Array    # bool [K]     sub-chunk produced audio
    active_chan: jax.Array    # i32 [K]
    rel_rssi: jax.Array       # f32 [K]
    rssi_db: jax.Array        # f32 [K, 16]  absolute per-channel RSSI
    ev_tuned: jax.Array       # bool [K]
    ev_detuned: jax.Array     # bool [K]
    ev_changed: jax.Array     # bool [K]
    ev_prev_chan: jax.Array   # i32 [K]
    ev_new_chan: jax.Array    # i32 [K]
    ct_detected: jax.Array    # bool [K]
    ct_max_idx: jax.Array     # i32 [K]
    ct_freq: jax.Array        # f32 [K]
    ev_ct_acquired: jax.Array  # bool [K]
    ev_ct_changed: jax.Array   # bool [K]
    ev_ct_lost: jax.Array      # bool [K]
    waterfall: jax.Array      # f32 [K, W] spectrum rows (dB), W=0 if off


class ScannerChain:
    """Builds and jits the scanner block step for a given geometry."""

    def __init__(self, block: C.BlockConfig | None = None,
                 lowpass: bool = False, fir_deemph: bool = False,
                 waterfall: int = 0, input_format: str = "cf32"):
        self.block = block or C.BlockConfig()
        # "cf32": step takes complex64 [input_len].  "cs16"/"cu8"/"cs8"/
        # "cf32w": step takes the capture's RAW wire bytes packed as f32
        # transport words ([step_arg_len], ops/decode.py) and decodes on
        # device — 2-4x less host->device + input-read traffic than
        # converting on the host like the reference's CF32 stream setup
        # (src/shared.c:54) forces.
        self.input_format = input_format
        if input_format != "cf32" and \
                input_format not in decode_op.PACKED_FORMATS:
            raise ValueError(f"unsupported input_format: {input_format!r}")
        self.lowpass = lowpass
        self.fir_deemph = fir_deemph
        self.waterfall = waterfall
        spectrogram.validate_width(waterfall)

        self.resampler = PolyResampler(D.resampler_taps(), C.RESAMP_L,
                                       C.RESAMP_M)
        self.pfb = PFBChannelizer(D.pfb_prototype())
        self.hp_taps = D.ctcss_hp_taps().astype(np.float32)
        self.lp_taps = D.audio_lp_taps().astype(np.float32)
        if fir_deemph:
            self.deemph_taps = D.deemph_fir_taps().astype(np.float32)
        else:
            self.deemph_taps = D.deemph_fir_equiv().astype(np.float32)
        self.deemph_hist_len = self.deemph_taps.shape[0] - 1

        from sdr_pmr446_tpu.runtime.fuse import fused_steps
        self._step = jax.jit(self._step_impl, donate_argnums=(0,))
        self._multi_step = fused_steps(self._step_impl)

    def init_state(self) -> ScannerState:
        return init_scanner_state(self.resampler.hist_len,
                                  self.pfb.hist_len,
                                  self.deemph_hist_len,
                                  waterfall=self.waterfall)

    @property
    def input_len(self) -> int:
        """Complex samples consumed per step."""
        return self.block.input_len

    @property
    def step_arg_len(self) -> int:
        """Length of the array actually passed to step(): complex64
        samples for cf32, packed f32 transport words otherwise."""
        if self.input_format == "cf32":
            return self.block.input_len
        return decode_op.packed_len(self.block.input_len, self.input_format)

    def step(self, state: ScannerState, iq: jax.Array,
             params: RuntimeParams):
        """One jitted block step; iq is [input_len] complex64 (cf32) or
        [step_arg_len] packed f32 wire words (cs16/cu8/cs8/cf32w)."""
        return self._step(state, iq, params)

    def multi_step(self, state: ScannerState, iqs: jax.Array,
                   params: RuntimeParams):
        """S stacked blocks in ONE dispatch: lax.scan over the block step.

        ``iqs`` is [S, step_arg_len].  Returns (state', outputs) with every
        output leaf flattened to [S*K, ...] — in order, equal to S
        successive step() calls (decisions exactly, floats to f32 rounding;
        test-enforced).  Streaming deployments use
        this to amortize the per-dispatch host/runtime floor over S blocks
        (the per-step fixed cost is the device analog of the reference's
        per-chunk loop overhead, src/sdr_pmr446.c:788-790); the FSM stays
        sequential ACROSS blocks because the scan carries the state pytree.
        """
        return self._multi_step(state, iqs, params)

    # ------------------------------------------------------------------
    def _step_impl(self, state: ScannerState, iq: jax.Array,
                   params: RuntimeParams):
        K = self.block.subchunks_per_step
        ns = C.SUBCHUNK_AUDIO

        if self.input_format != "cf32":
            iq = decode_op.decode_complex(iq, self.input_format)
        # 1. IQ DC blocker (exact one-pole, src/sdr_pmr446.c:422,795)
        (dc_x, dc_y), x = iir.dc_blocker_apply(
            (state.dc_x, state.dc_y), iq, C.DC_BLOCK_ALPHA)

        # 2. 25/128 polyphase resampler to 200 kHz (:425-428,796)
        resamp_hist, band = self.resampler.apply(state.resamp_hist, x)

        # 3-5. NCO + PFB channelizer + RSSI + NBFM discriminator
        (pfb_hist, parity), chan = self.pfb.apply(
            (state.pfb_hist, state.frame_parity), band)
        rssi_db = rssi_op.subchunk_rssi(chan, K)      # [K, 16]
        demod_prev, demod = fm.fm_demod(state.demod_prev, chan)

        # 6. audio path, all channels: HP (CTCSS removal), complementary
        # LP branch = delay - HP (:882-891)
        hp_hist, hp_out = fir.fir_apply(state.hp_hist, demod,
                                        self.hp_taps)
        delay_hist, delayed = fir.delay_apply(state.delay_hist, demod)
        lp_branch = delayed - hp_out
        (lp_dc_x, lp_dc_y), lp_dcb = iir.dc_blocker_apply(
            (state.lp_dc_x, state.lp_dc_y), lp_branch, C.DC_BLOCK_ALPHA)

        audio_all = hp_out * params.audio_gain
        deemph_hist, audio_all = fir.fir_apply(
            state.deemph_hist, audio_all, self.deemph_taps)
        if self.lowpass:
            audio_lp_hist, audio_all = fir.fir_apply(
                state.audio_lp_hist, audio_all, self.lp_taps)
        else:
            audio_lp_hist = state.audio_lp_hist

        # 7. squelch FSM + CTCSS detection scan over K sub-chunks; lp goes
        # in channel-major so the CTCSS selection is a row gather, not a
        # channel-minor copy
        carry_in = FsmCarry(
            state.fsm_state, state.active_chan, state.rssi,
            state.ct_count, state.ct_carry, state.ct_detected,
            state.ct_max_idx, state.ct_freq)
        carry_out, fo = fsm_ctcss_scan_v3(
            carry_in, rssi_db, None, params.channel_mask,
            params.squelch_level, params.lock_max,
            lp_cm=lp_dcb.reshape(C.NUM_CHANNELS, K, ns))

        # 8. select the active channel's audio per sub-chunk — a direct
        # channel-major row gather (reads the selected 1/16th only)
        sel = jnp.clip(fo.active_chan, 0, C.NUM_CHANNELS - 1)
        audio_sel = audio_all.reshape(C.NUM_CHANNELS, K, ns)[
            sel, jnp.arange(K, dtype=jnp.int32)]
        valid = fo.active_chan >= 0

        # 9. waterfall rows: sliding windowed periodogram over ALL band
        # samples (asgramcf semantics, src/sdr_pmr446.c:473-477,910-919);
        # widths whose hop divides the sub-chunk take the static path,
        # any other multiple of 4 carries the hop counter (wf_cnt)
        wf_cnt = state.wf_cnt
        if self.waterfall > 0:
            if spectrogram.uses_fast_path(self.waterfall):
                wf_hist, wf = spectrogram.asgram_rows(
                    state.wf_hist, band, K, self.waterfall)
            else:
                wf_hist, wf_cnt, wf = spectrogram.asgram_rows_any(
                    state.wf_hist, state.wf_cnt, band, K, self.waterfall)
        else:
            wf_hist = state.wf_hist
            wf = jnp.zeros((K, 0), jnp.float32)

        new_state = ScannerState(
            dc_x=dc_x, dc_y=dc_y, resamp_hist=resamp_hist,
            pfb_hist=pfb_hist, frame_parity=parity,
            demod_prev=demod_prev, hp_hist=hp_hist, delay_hist=delay_hist,
            lp_dc_x=lp_dc_x, lp_dc_y=lp_dc_y, deemph_hist=deemph_hist,
            audio_lp_hist=audio_lp_hist,
            fsm_state=carry_out.fsm_state, active_chan=carry_out.active_chan,
            rssi=carry_out.rssi, ct_count=carry_out.ct_count,
            ct_carry=carry_out.ct_carry, ct_detected=carry_out.ct_detected,
            ct_max_idx=carry_out.ct_max_idx, ct_freq=carry_out.ct_freq,
            wf_hist=wf_hist, wf_cnt=wf_cnt,
        )
        outputs = StepOutputs(
            audio=audio_sel, audio_valid=valid,
            active_chan=fo.active_chan, rel_rssi=fo.rel_rssi,
            rssi_db=rssi_db,
            ev_tuned=fo.ev_tuned, ev_detuned=fo.ev_detuned,
            ev_changed=fo.ev_changed, ev_prev_chan=fo.ev_prev_chan,
            ev_new_chan=fo.ev_new_chan,
            ct_detected=fo.ct_detected, ct_max_idx=fo.ct_max_idx,
            ct_freq=fo.ct_freq, ev_ct_acquired=fo.ev_ct_acquired,
            ev_ct_changed=fo.ev_ct_changed, ev_ct_lost=fo.ev_ct_lost,
            waterfall=wf,
        )
        return new_state, outputs
