"""Time-sharded dsd_in chain (streams x time mesh), same halo machinery.

Distributes the reference dsd_in pipeline (src/dsd_in.c:159-180) the same
way parallel/scanner_sharded.py distributes the scanner.

Completes distributed coverage of every signal chain: the wideband-FM
front-end's three resampler stages and discriminator run over time shards
with FIR-history halo exchange and exact IIR carries (parallel/halo.py),
exactly like the scanner (see parallel/scanner_sharded.py).
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.taps import design as D
from sdr_pmr446_tpu.ops import fm
from sdr_pmr446_tpu.ops.resample import PolyResampler
from sdr_pmr446_tpu.ops import decode as decode_op
from sdr_pmr446_tpu.scanner.dsd_in import (DsdState, DsdOutputs,
                                           stage2_taps, up_taps)
from sdr_pmr446_tpu.parallel import halo
from sdr_pmr446_tpu.parallel.scanner_sharded import STREAM_AXIS, TIME_AXIS


class ShardedDsdInChain:
    """dsd_in over [n_streams, input_len] blocks on a (stream, time) mesh.

    ``input_format`` "cf32w"/"cs16"/"cu8"/"cs8" feeds raw wire words
    (time-sharded; words hold whole samples), decoded in one pass per
    shard.
    """

    def __init__(self, mesh: Mesh, subchunks_per_step: int = 10,
                 input_format: str = "cf32"):
        self.mesh = mesh
        self.n_time = mesh.shape[TIME_AXIS]
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        assert (self.input_len // self.n_time) % C.INPUT_GRANULE == 0
        if input_format != "cf32" and \
                input_format not in decode_op.PACKED_FORMATS:
            raise ValueError(f"unsupported input_format: {input_format!r}")
        self.input_format = input_format
        self.res1 = PolyResampler(D.resampler_taps(), C.RESAMP_L, C.RESAMP_M)
        self.res2 = PolyResampler(np.asarray(stage2_taps()), 1, 16)
        self.up = PolyResampler(np.asarray(up_taps()), 96, 25)
        self.output_len = self.input_len * 3 // 64

        state_struct = self._init_one()
        in_specs = (
            jax.tree.map(lambda _: P(STREAM_AXIS), state_struct),
            P(STREAM_AXIS, TIME_AXIS),
        )
        out_specs = (
            jax.tree.map(lambda _: P(STREAM_AXIS), state_struct),
            jax.tree.map(lambda _: P(STREAM_AXIS, TIME_AXIS),
                         DsdOutputs(0)),
        )
        fn = jax.shard_map(self._step_shard, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        self._step = jax.jit(fn, donate_argnums=(0,))
        from sdr_pmr446_tpu.runtime.fuse import fused_sharded_steps
        self._multi_step = fused_sharded_steps(fn)

    def _init_one(self):
        return DsdState(
            dc_x=jnp.zeros((), jnp.complex64),
            dc_y=jnp.zeros((), jnp.complex64),
            res1_hist=self.res1.init(),
            res2_hist=self.res2.init(),
            fm_prev=fm.fm_init(),
            up_hist=self.up.init(dtype=jnp.float32),
        )

    def init_state(self, n_streams: int) -> DsdState:
        base = self._init_one()
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (n_streams,) + a.shape), base)

    def step(self, state: DsdState, iq: jax.Array):
        return self._step(state, iq)

    def multi_step(self, state: DsdState, iqs: jax.Array):
        """S stacked blocks ([S, n_streams, input_len]) in one dispatch;
        pcm comes back [n_streams, S*output_len] — per stream equal to S
        step() calls within 1 int16 LSB (runtime/fuse.py rationale)."""
        return self._multi_step(state, iqs)

    def _step_shard(self, state, iq: jax.Array):
        return jax.vmap(self._step_one)(state, iq)

    def _step_one(self, state: DsdState, iq: jax.Array):
        ax = TIME_AXIS
        if self.input_format != "cf32":
            iq = decode_op.decode_complex(iq, self.input_format)
        (dc_x, dc_y), x = halo.shard_dc_blocker(
            (state.dc_x, state.dc_y), iq, C.DC_BLOCK_ALPHA, ax)
        h1, c1 = halo.shard_hist(state.res1_hist, x, self.res1.hist_len, ax)
        _, band = self.res1.apply(h1, x)
        h2, c2 = halo.shard_hist(state.res2_hist, band, self.res2.hist_len,
                                 ax)
        _, sig = self.res2.apply(h2, band)
        fm_prev, fm_carry = halo.shard_scalar_prev(state.fm_prev, sig, ax)
        _, audio = fm.fm_demod(fm_prev, sig)
        h3, c3 = halo.shard_hist(state.up_hist, audio, self.up.hist_len, ax)
        _, out48 = self.up.apply(h3, audio)
        pcm = jnp.clip(out48 * 32767.0, -32768.0, 32767.0).astype(jnp.int16)
        new_state = DsdState(dc_x, dc_y, c1, c2, fm_carry, c3)
        return new_state, DsdOutputs(pcm=pcm)
