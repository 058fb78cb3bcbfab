"""Time-sharded single-channel NBFM monitor (streams x time mesh).

Distributes the fixed-channel chain (scanner/single.py) the same way
parallel/dsd_sharded.py distributes dsd_in: FIR-history halos + exact
affine IIR carries (parallel/halo.py) over the TIME axis, vmapped over
STREAM.  With this, EVERY signal chain in the framework (scanner, dsd_in,
single) has a sharded == unsharded test-gated distributed variant.

The one piece the other chains don't have is the MIXER.  The channel
offset is a multiple of fs/32, so the phase ramp has period 32, and each
shard's phase base is ``(n0 + axis_index * t_band_local) % 32`` —
closed-form, no cross-shard state beyond the replicated carried ``n0``.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.taps import design as D
from sdr_pmr446_tpu.ops import fir, fm
from sdr_pmr446_tpu.ops.resample import PolyResampler
from sdr_pmr446_tpu.ops import decode as decode_op
from sdr_pmr446_tpu.scanner.single import SingleState, channel_filter_taps
from sdr_pmr446_tpu.parallel import halo
from sdr_pmr446_tpu.parallel.scanner_sharded import STREAM_AXIS, TIME_AXIS


class ShardedSingleChain:
    """Single-channel monitor over [n_streams, input_len] blocks on a
    (stream, time) mesh; step -> (state, audio [n_streams, T*25/2048]).
    Wire formats other than "cf32" are decoded per time shard (words hold
    whole samples)."""

    def __init__(self, mesh: Mesh, channel: int,
                 subchunks_per_step: int = 10,
                 audio_gain: float = C.SDR_DEFAULT_AUDIO_GAIN,
                 input_format: str = "cf32"):
        if not 1 <= channel <= C.NUM_CHANNELS:
            raise ValueError(f"channel must be 1..{C.NUM_CHANNELS}")
        self.mesh = mesh
        self.channel = channel
        self.audio_gain = audio_gain
        self.n_time = mesh.shape[TIME_AXIS]
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        if subchunks_per_step % self.n_time != 0:
            raise ValueError(
                f"subchunks_per_step={subchunks_per_step} must divide "
                f"evenly over the {self.n_time}-way time mesh")
        assert (self.input_len // self.n_time) % C.INPUT_GRANULE == 0
        if input_format != "cf32" and \
                input_format not in decode_op.PACKED_FORMATS:
            raise ValueError(f"unsupported input_format: {input_format!r}")
        self.input_format = input_format
        self.res = PolyResampler(D.resampler_taps(), C.RESAMP_L, C.RESAMP_M)
        self.chf = PolyResampler(np.asarray(channel_filter_taps()), 1,
                                 C.NUM_CHANNELS)
        self.hp_taps = D.ctcss_hp_taps().astype(np.float32)
        self.deemph_taps = D.deemph_fir_equiv().astype(np.float32)
        f_off = (channel - 1) * C.CHANNEL_WIDTH_HZ - 93_750.0
        self.omega = 2.0 * np.pi * f_off / C.SDR_RESAMPLERATE
        self.phase_period = 32
        self.output_len = self.input_len * 25 // 2048

        state_struct = self._init_one()
        in_specs = (
            jax.tree.map(lambda _: P(STREAM_AXIS), state_struct),
            P(STREAM_AXIS, TIME_AXIS),
        )
        out_specs = (
            jax.tree.map(lambda _: P(STREAM_AXIS), state_struct),
            P(STREAM_AXIS, TIME_AXIS),
        )
        fn = jax.shard_map(self._step_shard, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        self._step = jax.jit(fn, donate_argnums=(0,))
        from sdr_pmr446_tpu.runtime.fuse import fused_sharded_steps
        self._multi_step = fused_sharded_steps(fn)

    def _phase_tab(self) -> jnp.ndarray:
        return jnp.asarray(np.exp(
            -1j * self.omega
            * np.arange(self.phase_period)).astype(np.complex64))

    def _init_one(self):
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

    def init_state(self, n_streams: int):
        base = self._init_one()
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (n_streams,) + a.shape), base)

    def step(self, state, iq: jax.Array):
        return self._step(state, iq)

    def multi_step(self, state, iqs: jax.Array):
        """S stacked blocks ([S, n_streams, input_len]) in one dispatch;
        audio back as [n_streams, S*output_len] (runtime/fuse.py)."""
        return self._multi_step(state, iqs)

    def _step_shard(self, state, iq: jax.Array):
        return jax.vmap(self._step_one)(state, iq)

    def _step_one(self, state: SingleState, iq: jax.Array):
        ax = TIME_AXIS
        if self.input_format != "cf32":
            iq = decode_op.decode_complex(iq, self.input_format)
        (dc_x, dc_y), x = halo.shard_dc_blocker(
            (state.dc_x, state.dc_y), iq, C.DC_BLOCK_ALPHA, ax)
        h1, c1 = halo.shard_hist(state.res_hist, x, self.res.hist_len, ax)
        _, band = self.res.apply(h1, x)
        # global mixer phase for THIS shard: the ramp's 32-entry table
        # indexed at n0 + i_time * t_band_local (+ local n) — identical
        # values to the unsharded closed-form mixer, no carried phase
        t_band = band.shape[-1]
        i_time = jax.lax.axis_index(ax)
        tab = self._phase_tab()
        base = (state.n0 + i_time * t_band) % self.phase_period
        idx = (jnp.arange(t_band, dtype=jnp.int32) + base) \
            % self.phase_period
        mixed = band * tab[idx]
        h2, c2 = halo.shard_hist(state.ch_hist, mixed, self.chf.hist_len, ax)
        _, sig = self.chf.apply(h2, mixed)
        fm_prev, fm_carry = halo.shard_scalar_prev(state.fm_prev, sig, ax)
        _, audio = fm.fm_demod(fm_prev, sig)
        h3, c3 = halo.shard_hist(state.hp_hist, audio,
                                 self.hp_taps.shape[0] - 1, ax)
        _, audio = fir.fir_apply(h3, audio, jnp.asarray(self.hp_taps))
        audio = audio * self.audio_gain
        h4, c4 = halo.shard_hist(state.deemph_hist, audio,
                                 self.deemph_taps.shape[0] - 1, ax)
        _, audio = fir.fir_apply(h4, audio, jnp.asarray(self.deemph_taps))
        n0 = (state.n0 + self.n_time * t_band) % self.phase_period
        new_state = SingleState(dc_x, dc_y, c1, c2, fm_carry, c3, c4, n0)
        return new_state, audio
