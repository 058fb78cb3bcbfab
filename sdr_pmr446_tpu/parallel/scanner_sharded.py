"""Pod-scale scanner: streams x time-shards over a 2-D device mesh.

The distributed execution design of SURVEY.md §2c/§5:

  - mesh axis 'stream': data-parallel over independent IQ captures/bands
    (zero cross-talk);
  - mesh axis 'time': one stream's block sharded along time, with
    filter-history halo exchange (ppermute) for every FIR and an exact
    affine carry composition for the one-pole IIRs (parallel/halo.py);
  - the sequential sub-chunk logic (squelch FSM + CTCSS scan) runs
    replicated on all-gathered per-sub-chunk summaries — audio-rate data is
    ~82x smaller than the input, so the gather is negligible next to the
    front-end compute it unblocks.

The sharded step computes bit-comparable outputs to the single-chip
ScannerChain (test: tests/test_sharding.py, sharded == unsharded).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.taps import design as D
from sdr_pmr446_tpu.ops import fir, fm, rssi as rssi_op, spectrogram
from sdr_pmr446_tpu.ops import decode as decode_op
from sdr_pmr446_tpu.ops.resample import PolyResampler
from sdr_pmr446_tpu.ops.pfb import PFBChannelizer
from sdr_pmr446_tpu.runtime.state import ScannerState, init_scanner_state
from sdr_pmr446_tpu.scanner.chain import RuntimeParams, StepOutputs
from sdr_pmr446_tpu.scanner.fsm import FsmCarry, fsm_ctcss_scan_v3
from sdr_pmr446_tpu.parallel import halo

TIME_AXIS = "time"
STREAM_AXIS = "stream"


class ShardedScannerChain:
    """Scanner over [n_streams, input_len] blocks on a (stream, time) mesh."""

    def __init__(self, mesh: Mesh, block: C.BlockConfig | None = None,
                 lowpass: bool = False, fir_deemph: bool = False,
                 waterfall: int = 0, input_format: str = "cf32"):
        self.mesh = mesh
        self.block = block or C.BlockConfig()
        # "cs16"/"cu8"/"cs8"/"cf32w": step takes [S, words] raw wire bytes
        # packed as f32 transport words, decoded per time-shard on device
        # (ops/decode.py).  Word shards decode to contiguous sample shards
        # (words hold whole samples, and local word counts are even), so
        # halo semantics are unchanged.
        self.input_format = input_format
        if input_format != "cf32" and \
                input_format not in decode_op.PACKED_FORMATS:
            raise ValueError(f"unsupported input_format: {input_format!r}")
        self.lowpass = lowpass
        self.waterfall = waterfall
        spectrogram.validate_width(waterfall)
        self.n_time = mesh.shape[TIME_AXIS]
        self.n_stream = mesh.shape[STREAM_AXIS]
        assert self.block.subchunks_per_step % self.n_time == 0, (
            "subchunks_per_step must divide evenly across the time axis")

        self.resampler = PolyResampler(D.resampler_taps(), C.RESAMP_L,
                                       C.RESAMP_M)
        self.pfb = PFBChannelizer(D.pfb_prototype())
        self.hp_taps = D.ctcss_hp_taps().astype(np.float32)
        self.lp_taps = D.audio_lp_taps().astype(np.float32)
        self.deemph_taps = (D.deemph_fir_taps() if fir_deemph
                            else D.deemph_fir_equiv()).astype(np.float32)
        self.deemph_hist_len = self.deemph_taps.shape[0] - 1

        in_specs = (
            jax.tree.map(lambda _: P(STREAM_AXIS), self._state_struct()),
            P(STREAM_AXIS, TIME_AXIS),                # iq [S, T]
            jax.tree.map(lambda _: P(), RuntimeParams(0, 0, 0, 0)),
        )
        out_specs = (
            jax.tree.map(lambda _: P(STREAM_AXIS), self._state_struct()),
            jax.tree.map(lambda _: P(STREAM_AXIS, TIME_AXIS),
                         self._out_struct()),
        )
        fn = jax.shard_map(self._step_shard, mesh=mesh,
                           in_specs=in_specs, out_specs=out_specs,
                           check_vma=False)
        self._step = jax.jit(fn, donate_argnums=(0,))
        from sdr_pmr446_tpu.runtime.fuse import fused_sharded_steps
        self._multi_step = fused_sharded_steps(fn)

    # -- pytree structure helpers (specs need matching treedefs) ----------
    def _state_struct(self):
        return init_scanner_state(self.resampler.hist_len,
                                  self.pfb.hist_len, self.deemph_hist_len,
                                  waterfall=self.waterfall)

    def _out_struct(self):
        return StepOutputs(*([0] * len(StepOutputs._fields)))

    def init_state(self, n_streams: int) -> ScannerState:
        base = self._state_struct()
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (n_streams,) + a.shape), base)

    @property
    def step_arg_len(self) -> int:
        """Per-stream length of step()'s iq argument: complex samples for
        cf32, packed f32 transport words for cs16/cu8."""
        if self.input_format == "cf32":
            return self.block.input_len
        return decode_op.packed_len(self.block.input_len, self.input_format)

    def step(self, state: ScannerState, iq: jax.Array,
             params: RuntimeParams):
        """iq: [n_streams, input_len] complex64 (cf32) or
        [n_streams, step_arg_len] packed f32 wire words (cs16/cu8/cs8/
        cf32w)."""
        return self._step(state, iq, params)

    def multi_step(self, state: ScannerState, iqs: jax.Array,
                   params: RuntimeParams):
        """S stacked blocks in one dispatch: iqs [S, n_streams,
        step_arg_len]; output leaves come back [n_streams, S*K, ...] —
        per stream and in order, equal to S step() calls (decisions
        exactly, floats to f32 rounding; tests/test_multistep.py — see
        runtime/fuse.py for the rationale)."""
        return self._multi_step(state, iqs, params)

    # ------------------------------------------------------------------
    def _step_shard(self, state: ScannerState, iq: jax.Array,
                    params: RuntimeParams):
        """Per-device body under shard_map: iq [S_local, T_local]."""
        single = functools.partial(self._step_one_stream, params=params)
        return jax.vmap(single)(state, iq)

    def _step_one_stream(self, state: ScannerState, iq: jax.Array,
                         params: RuntimeParams):
        ax = TIME_AXIS
        ntime = self.n_time
        d = jax.lax.axis_index(ax)
        K = self.block.subchunks_per_step
        K_local = K // ntime
        ns = C.SUBCHUNK_AUDIO

        # 0. packed wire bytes -> complex64, decoded on this time-shard's
        # local words (contiguous samples, so the halos below are unchanged)
        if self.input_format != "cf32":
            iq = decode_op.decode_complex(iq, self.input_format)

        # 1. IQ DC blocker: exact cross-shard one-pole
        (dc_x, dc_y), x = halo.shard_dc_blocker(
            (state.dc_x, state.dc_y), iq, C.DC_BLOCK_ALPHA, ax)

        # 2. resampler with input-history halo
        rhist, r_carry = halo.shard_hist(state.resamp_hist, x,
                                         self.resampler.hist_len, ax)
        _, band = self.resampler.apply(rhist, x)

        # 3. PFB with band-history halo; frame parity offset per shard
        phist, p_carry = halo.shard_hist(state.pfb_hist, band,
                                         self.pfb.hist_len, ax)
        f_local = band.shape[-1] // C.NUM_CHANNELS
        parity = (state.frame_parity + d * f_local) % 2
        (_, _), chan = self.pfb.apply((phist, parity), band)
        new_parity = (state.frame_parity + ntime * f_local) % 2

        # 4. per-sub-chunk RSSI (local K_local sub-chunks)
        rssi_local = rssi_op.subchunk_rssi(chan, K_local)

        # 5. FM demod with 1-sample halo per channel
        fm_prev, fm_carry = halo.shard_scalar_prev(state.demod_prev,
                                                   chan, ax)
        _, demod = fm.fm_demod(fm_prev, chan)

        # 6. audio filters with halos
        hp_hist, hp_carry = halo.shard_hist(state.hp_hist, demod,
                                            C.HP_AUDIO_FILT_TAPS - 1, ax)
        _, hp_out = fir.fir_apply(hp_hist, demod, self.hp_taps)
        dl_hist, dl_carry = halo.shard_hist(state.delay_hist, demod,
                                            C.CTCSS_DELAY, ax)
        _, delayed = fir.delay_apply(dl_hist, demod)
        lp_branch = delayed - hp_out
        (lpdc_x, lpdc_y), lp_dcb = halo.shard_dc_blocker(
            (state.lp_dc_x, state.lp_dc_y), lp_branch,
            C.DC_BLOCK_ALPHA, ax)

        audio_all = hp_out * params.audio_gain
        de_hist, de_carry = halo.shard_hist(state.deemph_hist, audio_all,
                                            self.deemph_hist_len, ax)
        _, audio_all = fir.fir_apply(de_hist, audio_all, self.deemph_taps)
        if self.lowpass:
            al_in = audio_all
            al_hist, al_carry = halo.shard_hist(
                state.audio_lp_hist, al_in, C.LP_AUDIO_FILT_TAPS - 1, ax)
            _, audio_all = fir.fir_apply(al_hist, al_in, self.lp_taps)
        else:
            al_carry = state.audio_lp_hist

        # 6b. waterfall rows on the local band shard (history halo: the
        # sliding window reaches w//2 samples into the previous shard)
        wf_cnt = state.wf_cnt
        if self.waterfall > 0:
            wf_hist_loc, wf_carry = halo.shard_hist(
                state.wf_hist, band, spectrogram.hist_len(self.waterfall),
                ax)
            if spectrogram.uses_fast_path(self.waterfall):
                _, wf_rows = spectrogram.asgram_rows(
                    wf_hist_loc, band, K_local, self.waterfall)
            else:
                # this shard's hop counter is analytic from the carried
                # one (NCO-style: phase = f(global sample index), no halo)
                s_local = K_local * C.SUBCHUNK_RESAMP
                _, _, wf_rows = spectrogram.asgram_rows_any(
                    wf_hist_loc, state.wf_cnt, band, K_local,
                    self.waterfall, cnt_offset=d * s_local)
                delay = self.waterfall // 4
                wf_cnt = (state.wf_cnt + ntime * s_local) % delay
        else:
            wf_carry = state.wf_hist
            wf_rows = jnp.zeros((K_local, 0), jnp.float32)

        # 7. gather sub-chunk summaries; replicated FSM+CTCSS scan
        lp_blocks_local = jnp.moveaxis(
            lp_dcb.reshape(C.NUM_CHANNELS, K_local, ns), 0, 1)
        rssi_all = jax.lax.all_gather(rssi_local, ax,
                                      tiled=True)          # [K, 16]
        lp_all = jax.lax.all_gather(lp_blocks_local, ax,
                                    tiled=True)            # [K, 16, ns]
        carry_in = FsmCarry(state.fsm_state, state.active_chan, state.rssi,
                            state.ct_count, state.ct_carry,
                            state.ct_detected, state.ct_max_idx,
                            state.ct_freq)
        carry_out, fo = fsm_ctcss_scan_v3(
            carry_in, rssi_all, lp_all, params.channel_mask,
            params.squelch_level, params.lock_max)

        # 8. local audio selection using the replicated decisions
        sel_all = jnp.clip(fo.active_chan, 0, C.NUM_CHANNELS - 1)
        sel_local = jax.lax.dynamic_slice_in_dim(sel_all, d * K_local,
                                                 K_local)
        audio_blocks = jnp.moveaxis(
            audio_all.reshape(C.NUM_CHANNELS, K_local, ns), 0, 1)
        audio_sel = jnp.take_along_axis(
            audio_blocks, sel_local[:, None, None], axis=1)[:, 0, :]

        loc = lambda a: jax.lax.dynamic_slice_in_dim(a, d * K_local, K_local)
        outputs = StepOutputs(
            audio=audio_sel, audio_valid=loc(fo.active_chan >= 0),
            active_chan=loc(fo.active_chan), rel_rssi=loc(fo.rel_rssi),
            rssi_db=rssi_local,
            ev_tuned=loc(fo.ev_tuned), ev_detuned=loc(fo.ev_detuned),
            ev_changed=loc(fo.ev_changed), ev_prev_chan=loc(fo.ev_prev_chan),
            ev_new_chan=loc(fo.ev_new_chan),
            ct_detected=loc(fo.ct_detected), ct_max_idx=loc(fo.ct_max_idx),
            ct_freq=loc(fo.ct_freq),
            ev_ct_acquired=loc(fo.ev_ct_acquired),
            ev_ct_changed=loc(fo.ev_ct_changed),
            ev_ct_lost=loc(fo.ev_ct_lost),
            waterfall=wf_rows,
        )
        new_state = ScannerState(
            dc_x=dc_x, dc_y=dc_y, resamp_hist=r_carry, pfb_hist=p_carry,
            frame_parity=new_parity, demod_prev=fm_carry,
            hp_hist=hp_carry, delay_hist=dl_carry,
            lp_dc_x=lpdc_x, lp_dc_y=lpdc_y, deemph_hist=de_carry,
            audio_lp_hist=al_carry,
            fsm_state=carry_out.fsm_state, active_chan=carry_out.active_chan,
            rssi=carry_out.rssi, ct_count=carry_out.ct_count,
            ct_carry=carry_out.ct_carry, ct_detected=carry_out.ct_detected,
            ct_max_idx=carry_out.ct_max_idx, ct_freq=carry_out.ct_freq,
            wf_hist=wf_carry, wf_cnt=wf_cnt,
        )
        return new_state, outputs


def make_mesh(n_streams_axis: int, n_time_axis: int,
              devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size >= n_streams_axis * n_time_axis
    devs = devices[: n_streams_axis * n_time_axis].reshape(
        n_streams_axis, n_time_axis)
    return Mesh(devs, (STREAM_AXIS, TIME_AXIS))
