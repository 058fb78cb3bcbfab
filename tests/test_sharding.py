"""Sharded-vs-unsharded equivalence on a virtual 8-device CPU mesh.

The halo-exchange overlap-save correctness gate of SURVEY.md §7: the
time-sharded scanner must reproduce the single-device chain's outputs
(control decisions exactly; audio within fp tolerance).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.parallel.scanner_sharded import (ShardedScannerChain,
                                                     make_mesh)
from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params


def _run_single(iq, subchunks_per_step, n_steps):
    chain = ScannerChain(C.BlockConfig(subchunks_per_step))
    params = make_runtime_params(C.ScannerArgs())
    st = chain.init_state()
    outs = []
    step = chain.block.input_len
    for i in range(n_steps):
        st, o = chain.step(st, jnp.asarray(iq[i * step:(i + 1) * step],
                                           jnp.complex64), params)
        outs.append(jax.tree.map(np.asarray, o))
    return outs


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4), (1, 8)])
def test_sharded_equals_unsharded(mesh_shape):
    n_stream, n_time = mesh_shape
    if n_stream * n_time > len(jax.devices()):
        pytest.skip("not enough devices")
    subchunks = 8
    n_steps = 2
    step_len = subchunks * C.SUBCHUNK_IN

    iqs = [synth.make_scanner_iq(n_steps * step_len, channel=3 + s,
                                 ctcss_code=5 + s, seed=s)
           for s in range(n_stream)]

    # single-device reference, per stream
    singles = [_run_single(iq, subchunks, n_steps) for iq in iqs]

    mesh = make_mesh(n_stream, n_time)
    chain = ShardedScannerChain(mesh, C.BlockConfig(subchunks))
    params = make_runtime_params(C.ScannerArgs())
    st = chain.init_state(n_stream)
    for i in range(n_steps):
        blk = np.stack([iq[i * step_len:(i + 1) * step_len] for iq in iqs])
        st, out = chain.step(st, jnp.asarray(blk, jnp.complex64), params)
        out = jax.tree.map(np.asarray, out)
        for s in range(n_stream):
            ref = singles[s][i]
            np.testing.assert_array_equal(out.active_chan[s],
                                          ref.active_chan)
            np.testing.assert_array_equal(out.audio_valid[s],
                                          ref.audio_valid)
            np.testing.assert_array_equal(out.ct_detected[s],
                                          ref.ct_detected)
            np.testing.assert_array_equal(out.ct_max_idx[s], ref.ct_max_idx)
            np.testing.assert_allclose(out.rssi_db[s], ref.rssi_db,
                                       rtol=0, atol=5e-4)
            np.testing.assert_allclose(out.rel_rssi[s], ref.rel_rssi,
                                       rtol=0, atol=5e-4)
            np.testing.assert_allclose(out.audio[s], ref.audio,
                                       rtol=0, atol=1e-4)


def test_sharded_state_carries_across_steps():
    # tune happens in step 1; step 2 must continue tuned with CTCSS held
    n_time = 4
    subchunks = 4
    step_len = subchunks * C.SUBCHUNK_IN
    iq = synth.make_scanner_iq(3 * step_len, channel=7, ctcss_code=20)
    mesh = make_mesh(1, n_time)
    chain = ShardedScannerChain(mesh, C.BlockConfig(subchunks))
    params = make_runtime_params(C.ScannerArgs())
    st = chain.init_state(1)
    det = []
    for i in range(3):
        st, out = chain.step(
            st, jnp.asarray(iq[None, i * step_len:(i + 1) * step_len],
                            jnp.complex64), params)
        det.append(np.asarray(out.ct_detected)[0])
    assert int(np.asarray(st.active_chan)[0]) == 6
    assert bool(np.asarray(st.ct_detected)[0])
    assert int(np.asarray(st.ct_max_idx)[0]) == 19


def test_sharded_dsd_equals_unsharded():
    from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu.parallel.dsd_sharded import ShardedDsdInChain

    sub = 8
    chain1 = DsdInChain(subchunks_per_step=sub)
    n = 2 * chain1.input_len
    t = np.arange(n) / C.SDR_SAMPLERATE
    msg = 0.4 * np.sin(2 * np.pi * 900.0 * t)
    iq = np.exp(1j * 2 * np.pi * (1500 * np.cumsum(msg) + 2000 * np.arange(n))
                / C.SDR_SAMPLERATE).astype(np.complex64)

    st1 = chain1.init_state()
    ref = []
    for i in range(2):
        st1, o = chain1.step(st1, jnp.asarray(
            iq[i * chain1.input_len:(i + 1) * chain1.input_len]))
        ref.append(np.asarray(o.pcm))
    ref = np.concatenate(ref)

    mesh = make_mesh(1, 4)
    chain2 = ShardedDsdInChain(mesh, subchunks_per_step=sub)
    st2 = chain2.init_state(1)
    got = []
    for i in range(2):
        st2, o = chain2.step(st2, jnp.asarray(
            iq[None, i * chain2.input_len:(i + 1) * chain2.input_len]))
        got.append(np.asarray(o.pcm)[0])
    got = np.concatenate(got)
    assert got.shape == ref.shape
    # sharded IIR carries are affine-composed (different f32 rounding than
    # the sequential scan), so int16 quantization may flip single LSBs —
    # but never more: every sample within 1 LSB AND 90 dB error power bound
    err = got.astype(np.int64) - ref.astype(np.int64)
    assert np.max(np.abs(err)) <= 1
    sig_p = np.mean(ref.astype(np.float64) ** 2)
    err_p = np.mean(err.astype(np.float64) ** 2)
    snr = 10.0 * np.log10(sig_p / max(err_p, 1e-30))
    assert snr > 90.0, snr


def test_halo_biquad_exactness_direct():
    """shard_biquad1 across a 4-device mesh == sequential biquad1_apply."""
    from sdr_pmr446_tpu.ops import iir
    from sdr_pmr446_tpu.parallel import halo
    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(0)
    t = 4 * 2048
    x = rng.standard_normal(t).astype(np.float32)
    b0, b1, a1 = 0.9995, -0.9995, -0.999
    st = (jnp.float32(0.3), jnp.float32(-0.2))
    _, ref = iir.biquad1_apply(st, jnp.asarray(x), b0, b1, a1)

    mesh = make_mesh(1, 4)

    def sharded(state, xs):
        new_st, y = halo.shard_biquad1(state, xs, b0, b1, a1, "time")
        return new_st, y

    f = jax.jit(jax.shard_map(
        sharded, mesh=mesh,
        in_specs=((P(), P()), P("time")),
        out_specs=((P(), P()), P("time")), check_vma=False))
    (nx, ny), y = f(st, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref),
                               rtol=0, atol=2e-4)
    # carried state equals the sequential run's
    np.testing.assert_allclose(float(nx), x[-1], atol=1e-6)
    np.testing.assert_allclose(float(ny), float(ref[-1]), atol=2e-4)


def test_halo_hist_and_scalar_prev_direct():
    from sdr_pmr446_tpu.parallel import halo
    from jax.sharding import PartitionSpec as P
    t = 4 * 256
    x = np.arange(t, dtype=np.float32)
    carried = jnp.full((16,), -1.0, jnp.float32)
    mesh = make_mesh(1, 4)

    def fn(c, xs):
        hist, new_c = halo.shard_hist(c, xs, 16, "time")
        prev, new_p = halo.shard_scalar_prev(c[0], xs, "time")
        return hist, new_c, prev[None], new_p[None]

    f = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(), P("time")),
        out_specs=(P("time"), P(), P("time"), P(None)), check_vma=False))
    hist, new_c, prev, new_p = f(carried, jnp.asarray(x))
    hist = np.asarray(hist).reshape(4, 16)
    # shard 0 gets the carried history; shard d>0 the left neighbor's tail
    np.testing.assert_array_equal(hist[0], -np.ones(16))
    for d in range(1, 4):
        np.testing.assert_array_equal(
            hist[d], x[d * 256 - 16: d * 256])
    np.testing.assert_array_equal(np.asarray(new_c), x[-16:])
    prev = np.asarray(prev).reshape(4)
    assert prev[0] == -1.0
    np.testing.assert_array_equal(prev[1:], [255.0, 511.0, 767.0])
    assert float(np.asarray(new_p)[0]) == x[-1]


def test_batch_reader_feeds_stream_parallel_chain(tmp_path):
    """Stream-parallel integration: the native multi-stream batch reader
    feeds the (stream x time)-sharded scanner; each stream's decisions match
    its own single-stream run."""
    from sdr_pmr446_tpu.io import iq as iq_io, native
    from sdr_pmr446_tpu.parallel.scanner_sharded import ShardedScannerChain
    from sdr_pmr446_tpu.scanner.chain import ScannerChain

    sub = 4
    step_len = sub * C.SUBCHUNK_IN
    n = 2 * step_len
    paths, iqs = [], []
    for s in range(2):
        iq = 0.5 * synth.make_scanner_iq(n, channel=4 + s, ctcss_code=10 + s,
                                         seed=s)
        p = str(tmp_path / f"s{s}.cs16")
        iq_io.write_iq(p, iq, "cs16")
        paths.append(p)
        iqs.append(iq)

    mesh = make_mesh(2, 2)
    chain = ShardedScannerChain(mesh, C.BlockConfig(sub))
    params = make_runtime_params(C.ScannerArgs())
    st = chain.init_state(2)
    br = native.BatchReader(paths, ["cs16"] * 2)
    traces = [[], []]
    while True:
        blocks, got = br.read_block(step_len)
        if got == 0:
            break
        st, out = chain.step(st, jnp.asarray(blocks, jnp.complex64), params)
        for s in range(2):
            traces[s].append(np.asarray(out.active_chan)[s])
    br.close()

    # per-stream single-chip reference (quantized cs16 input, same data)
    single = ScannerChain(C.BlockConfig(sub))
    for s in range(2):
        st1 = single.init_state()
        ref = []
        cap = iq_io.read_iq(paths[s])
        for i in range(2):
            st1, o = single.step(st1, jnp.asarray(
                cap[i * step_len:(i + 1) * step_len], jnp.complex64), params)
            ref.append(np.asarray(o.active_chan))
        np.testing.assert_array_equal(np.concatenate(traces[s]),
                                      np.concatenate(ref))
        assert np.concatenate(traces[s])[-1] == 3 + s


def test_sharded_faithful_equals_unsharded_faithful():
    """ShardedFaithfulChain (front-end time-sharded, gated scan replicated
    on all-gathered sub-chunks) == FaithfulScannerChain across a busy
    tune/detune scenario with streaming state."""
    from sdr_pmr446_tpu.scanner.faithful import FaithfulScannerChain
    from sdr_pmr446_tpu.parallel.faithful_sharded import ShardedFaithfulChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params

    K = 4
    step_len = K * C.SUBCHUNK_IN
    sig = synth.make_scanner_iq(2 * step_len, channel=5, ctcss_code=12)
    rng = np.random.default_rng(2)
    quiet = 1e-3 * (rng.standard_normal(step_len)
                    + 1j * rng.standard_normal(step_len))
    iq = np.concatenate([sig[:2 * step_len], quiet]).astype(np.complex64)

    ref_chain = FaithfulScannerChain(subchunks_per_step=K)
    params = make_runtime_params(C.ScannerArgs(lock_mode="max"))
    st1 = ref_chain.init_state()
    refs = []
    for i in range(3):
        st1, o = ref_chain.step(st1, jnp.asarray(
            iq[i * step_len:(i + 1) * step_len]), params)
        refs.append(jax.tree.map(np.asarray, o))

    mesh = make_mesh(1, 4)
    chain = ShardedFaithfulChain(mesh, subchunks_per_step=K)
    st2 = chain.init_state(1)
    for i in range(3):
        st2, out = chain.step(st2, jnp.asarray(
            iq[None, i * step_len:(i + 1) * step_len]), params)
        out = jax.tree.map(np.asarray, out)
        ref = refs[i]
        np.testing.assert_array_equal(out.active_chan[0], ref.active_chan)
        np.testing.assert_array_equal(out.audio_valid[0], ref.audio_valid)
        np.testing.assert_array_equal(out.ct_detected[0], ref.ct_detected)
        np.testing.assert_array_equal(out.ct_max_idx[0], ref.ct_max_idx)
        np.testing.assert_allclose(out.rel_rssi[0], ref.rel_rssi,
                                   rtol=0, atol=5e-3)
        np.testing.assert_allclose(out.audio[0], ref.audio,
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("w", [64, 120, 128])
def test_sharded_waterfall_equals_unsharded(w):
    """Sharded waterfall rows (w/2 band-history halo) == single-chip rows
    — including the non-dividing-hop general path (w=120, the reference
    README's width, and w=128), whose per-shard hop counter is analytic
    from the carried one."""
    from sdr_pmr446_tpu.parallel.scanner_sharded import ShardedScannerChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params

    K = 4
    step_len = K * C.SUBCHUNK_IN
    iq = synth.make_scanner_iq(2 * step_len, channel=5, ctcss_code=12)
    params = make_runtime_params(C.ScannerArgs())

    ref_chain = ScannerChain(C.BlockConfig(K), waterfall=w)
    st1 = ref_chain.init_state()
    refs = []
    for i in range(2):
        st1, o = ref_chain.step(st1, jnp.asarray(
            iq[i * step_len:(i + 1) * step_len], jnp.complex64), params)
        refs.append(np.asarray(o.waterfall))

    mesh = make_mesh(1, 4)
    chain = ShardedScannerChain(mesh, C.BlockConfig(K), waterfall=w)
    st2 = chain.init_state(1)
    for i in range(2):
        st2, out = chain.step(st2, jnp.asarray(
            iq[None, i * step_len:(i + 1) * step_len], jnp.complex64),
            params)
        np.testing.assert_allclose(np.asarray(out.waterfall)[0], refs[i],
                                   rtol=0, atol=1e-2)


@pytest.mark.parametrize("fmt", ["cs16", "cu8", "cs8"])
def test_sharded_packed_input_equals_cf32(fmt):
    """Sharded chain fed packed wire words (decoded per time-shard on
    device) == sharded chain fed the host-decoded complex64 — bit-exact,
    proving word shards decode to the right contiguous sample shards."""
    from sdr_pmr446_tpu.ops import decode
    subchunks = 8
    step_len = subchunks * C.SUBCHUNK_IN
    sig = synth.make_scanner_iq(2 * step_len, channel=5, ctcss_code=12)
    packed = decode.pack_iq(sig, fmt)
    xr, xi = decode.decode_planes(jnp.asarray(packed), fmt)
    host_iq = (np.asarray(xr) + 1j * np.asarray(xi)).astype(np.complex64)

    mesh = make_mesh(1, 4)
    params = make_runtime_params(C.ScannerArgs())
    ref = ShardedScannerChain(mesh, C.BlockConfig(subchunks))
    pkd = ShardedScannerChain(mesh, C.BlockConfig(subchunks),
                              input_format=fmt)
    wlen = pkd.step_arg_len
    st_r, st_p = ref.init_state(1), pkd.init_state(1)
    for i in range(2):
        st_r, o_r = ref.step(
            st_r, jnp.asarray(host_iq[None, i * step_len:(i + 1) * step_len],
                              jnp.complex64), params)
        st_p, o_p = pkd.step(
            st_p, jnp.asarray(packed[None, i * wlen:(i + 1) * wlen]),
            params)
        for f in o_r._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(o_r, f)), np.asarray(getattr(o_p, f)),
                err_msg=f"{fmt} field {f} step {i}")


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_single_equals_unsharded(mesh_shape):
    """Time-sharded single-channel monitor == sequential chain: with
    this every signal chain (scanner, dsd_in, single) has a sharded
    gate.  The mixer's per-shard global phase base (n0 + i*t_band_local
    mod 32) must reproduce the unsharded closed-form ramp exactly."""
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    from sdr_pmr446_tpu.parallel.single_sharded import ShardedSingleChain

    n_stream, n_time = mesh_shape
    if n_stream * n_time > len(jax.devices()):
        pytest.skip("not enough devices")
    sub = 4
    chan = 7
    chain1 = SingleChannelChain(channel=chan, subchunks_per_step=sub)
    n = 2 * chain1.input_len
    iqs = [synth.make_scanner_iq(n, channel=chan, ctcss_code=3 + s,
                                 seed=11 + s) for s in range(n_stream)]

    refs = []
    for iq in iqs:
        st1 = chain1.init_state()
        parts = []
        for i in range(2):
            st1, a = chain1.step(st1, jnp.asarray(
                iq[i * chain1.input_len:(i + 1) * chain1.input_len]))
            parts.append(np.asarray(a))
        refs.append(np.concatenate(parts))

    mesh = make_mesh(n_stream, n_time)
    chain2 = ShardedSingleChain(mesh, channel=chan, subchunks_per_step=sub)
    st2 = chain2.init_state(n_stream)
    got = [[] for _ in range(n_stream)]
    for i in range(2):
        blk = np.stack([iq[i * chain2.input_len:(i + 1) * chain2.input_len]
                        for iq in iqs])
        st2, a = chain2.step(st2, jnp.asarray(blk, jnp.complex64))
        a = np.asarray(a)
        for s in range(n_stream):
            got[s].append(a[s])
    # mixer phase state must advance replicated, exactly as unsharded
    assert int(np.asarray(st2.n0)[0]) == (2 * chain2.input_len * 25 // 128) \
        % 32
    for s in range(n_stream):
        g = np.concatenate(got[s])
        r = refs[s]
        assert g.shape == r.shape
        sig_p = np.mean(r.astype(np.float64) ** 2)
        err_p = np.mean((g - r).astype(np.float64) ** 2)
        snr = 10.0 * np.log10(sig_p / max(err_p, 1e-30))
        assert snr > 90.0, snr


def test_sharded_single_multi_step():
    """fused_sharded_steps on the single monitor: 2 stacked blocks in one
    dispatch == 2 step() calls (f32 rounding)."""
    from sdr_pmr446_tpu.parallel.single_sharded import ShardedSingleChain

    mesh = make_mesh(1, 4)
    chain = ShardedSingleChain(mesh, channel=5, subchunks_per_step=4)
    iq = synth.make_scanner_iq(2 * chain.input_len, channel=5,
                               ctcss_code=8, seed=2)
    st = chain.init_state(1)
    ref = []
    for i in range(2):
        st, a = chain.step(st, jnp.asarray(
            iq[None, i * chain.input_len:(i + 1) * chain.input_len],
            jnp.complex64))
        ref.append(np.asarray(a)[0])
    ref = np.concatenate(ref)

    st2 = chain.init_state(1)
    blocks = jnp.asarray(
        np.stack([iq[None, :chain.input_len],
                  iq[None, chain.input_len:]]), jnp.complex64)
    st2, fused = chain.multi_step(st2, blocks)
    np.testing.assert_allclose(np.asarray(fused)[0], ref, rtol=0,
                               atol=5e-6)


def test_sharded_single_rejects_invalid_geometry():
    """The sharded single chain raises (not silently degrades) on a
    non-dividing time mesh, an unknown wire format and a channel out of
    the band plan."""
    from sdr_pmr446_tpu.parallel.single_sharded import ShardedSingleChain

    mesh = make_mesh(1, 4)
    with pytest.raises(ValueError, match="divide"):
        ShardedSingleChain(mesh, channel=5, subchunks_per_step=6)
    with pytest.raises(ValueError, match="unsupported input_format"):
        ShardedSingleChain(mesh, channel=5, subchunks_per_step=4,
                           input_format="cs12")
    with pytest.raises(ValueError, match="channel"):
        ShardedSingleChain(mesh, channel=17, subchunks_per_step=4)
