"""Multi-block-per-dispatch (chain.multi_step / driver steps_per_dispatch).

The megastep fuses S block steps into ONE device dispatch with lax.scan,
amortizing the per-dispatch runtime floor.  Contract: every integer/boolean output (FSM
decisions, events, CTCSS codes) is EXACTLY equal to S successive step()
calls; float outputs and carried state agree to f32 rounding (the scan
body compiles with different fusion/FMA choices than the standalone step,
shifting results by ~1 ulp — measured max 7e-7 on CPU).
"""

import numpy as np
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.runtime.driver import ScannerDriver
from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params

FTOL = dict(rtol=3e-5, atol=3e-5)


def _blocks(n_blocks, k, seed=0):
    n = n_blocks * k * C.SUBCHUNK_IN
    iq = synth.make_scanner_iq(n, channel=5, ctcss_code=12, seed=seed)
    return iq.reshape(n_blocks, k * C.SUBCHUNK_IN)


def _assert_leaf(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    if ref.dtype.kind in "biu":
        assert np.array_equal(got, ref), name
    else:
        np.testing.assert_allclose(got, ref, err_msg=name, **FTOL)


def _assert_int_state_equal(st_a, st_b):
    # Float state leaves are NOT compared directly: histories of idle
    # channels carry FM-demodulated noise, where a 1-ulp compile-variant
    # difference is amplified arbitrarily by angle() near |x|=0 (chaotic,
    # not a correctness signal).  Functional equivalence of the float state
    # is established by the continuation step below instead.
    for a, b, name in zip(st_a, st_b, st_a._fields):
        if np.asarray(a).dtype.kind in "biu":
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_multi_step_equals_steps():
    k, s = 2, 3
    chain = ScannerChain(C.BlockConfig(k), waterfall=64)
    params = make_runtime_params(C.ScannerArgs(waterfall=64))
    blks = _blocks(s, k)

    st_a = chain.init_state()
    outs = []
    for i in range(s):
        st_a, o = chain.step(st_a, jnp.asarray(blks[i], jnp.complex64),
                             params)
        outs.append(o)

    st_b = chain.init_state()
    st_b, fused = chain.multi_step(
        st_b, jnp.asarray(blks, jnp.complex64), params)

    for f, field in zip(fused, fused._fields):
        ref = np.concatenate([np.asarray(getattr(o, field)) for o in outs])
        _assert_leaf(f, ref, field)
    _assert_int_state_equal(st_a, st_b)

    # continuation equivalence: one more identical block from both final
    # states must produce the same decisions (exactly) and audio (to f32
    # rounding) — the functional test of the carried float state
    nxt = jnp.asarray(_blocks(1, k, seed=99)[0], jnp.complex64)
    _, oa = chain.step(st_a, nxt, params)
    _, ob = chain.step(st_b, nxt, params)
    for fa, fb, field in zip(oa, ob, oa._fields):
        if field == "waterfall" or np.asarray(fa).dtype.kind not in "biu":
            continue
        assert np.array_equal(np.asarray(fa), np.asarray(fb)), field
    np.testing.assert_allclose(np.asarray(ob.audio), np.asarray(oa.audio),
                               **FTOL)


def test_driver_steps_per_dispatch_equivalence():
    # 7 blocks with S=3: two megasteps + a 1-block tail
    k = 2
    n_blocks = 7
    iq = _blocks(n_blocks, k).reshape(-1)

    r1 = ScannerDriver(subchunks_per_step=k).run(
        iq_io.block_stream(iq, k * C.SUBCHUNK_IN))
    r3 = ScannerDriver(subchunks_per_step=k, steps_per_dispatch=3).run(
        iq_io.block_stream(iq, k * C.SUBCHUNK_IN))

    # events carry formatted RSSI values rounded to 2 decimals; a 1-ulp
    # drift at the rounding boundary is astronomically unlikely with the
    # synthetic signal's >10 dB margins, so exact string equality holds
    assert r1.events == r3.events
    assert np.array_equal(r1.active_trace, r3.active_trace)
    np.testing.assert_allclose(r3.rssi_trace, r1.rssi_trace, **FTOL)
    np.testing.assert_allclose(r3.audio, r1.audio, **FTOL)
    assert np.array_equal(r1.audio_subchunks, r3.audio_subchunks)


def test_sharded_multi_step_equals_steps():
    from sdr_pmr446_tpu.parallel.scanner_sharded import (ShardedScannerChain,
                                                         make_mesh)
    k, s, n_streams = 2, 2, 2
    mesh = make_mesh(2, 2)
    chain = ShardedScannerChain(mesh, C.BlockConfig(k))
    params = make_runtime_params(C.ScannerArgs())
    blks = np.stack([_blocks(s, k, seed=7 + st) for st in range(n_streams)],
                    axis=1)                    # [s, n_streams, T]

    st_a = chain.init_state(n_streams)
    outs = []
    for i in range(s):
        st_a, o = chain.step(st_a, jnp.asarray(blks[i], jnp.complex64),
                             params)
        outs.append(o)
    st_b = chain.init_state(n_streams)
    st_b, fused = chain.multi_step(st_b, jnp.asarray(blks, jnp.complex64),
                                   params)
    for f, field in zip(fused, fused._fields):
        ref = np.concatenate(
            [np.asarray(getattr(o, field)) for o in outs], axis=1)
        _assert_leaf(f, ref, field)
    _assert_int_state_equal(st_a, st_b)


def test_single_and_dsd_multi_step():
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain
    k, s = 1, 3
    blks = _blocks(s, k, seed=11)

    sc = SingleChannelChain(channel=5, subchunks_per_step=k)
    st_a = sc.init_state()
    ref = []
    for i in range(s):
        st_a, a = sc.step(st_a, jnp.asarray(blks[i], jnp.complex64))
        ref.append(np.asarray(a))
    st_b = sc.init_state()
    st_b, fused = sc.multi_step(st_b, jnp.asarray(blks, jnp.complex64))
    np.testing.assert_allclose(np.asarray(fused), np.concatenate(ref),
                               **FTOL)

    # dsd fixture: a strong FM carrier near the tuned center (the chain's
    # deployment signal) — demod of an empty band is chaotic under 1-ulp
    # compile variants (see _assert_int_state_equal) and not the contract
    dc = DsdInChain(subchunks_per_step=k)
    fs = C.SDR_SAMPLERATE
    t = np.arange(s * dc.input_len) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    fmiq = np.exp(1j * 2 * np.pi
                  * (2000.0 * np.cumsum(msg) + 300.0 * np.arange(len(t)))
                  / fs).astype(np.complex64)
    dblks = fmiq.reshape(s, dc.input_len)
    st_a = dc.init_state()
    ref = []
    for i in range(s):
        st_a, o = dc.step(st_a, jnp.asarray(dblks[i], jnp.complex64))
        ref.append(np.asarray(o.pcm))
    st_b = dc.init_state()
    st_b, fused = dc.multi_step(st_b, jnp.asarray(dblks, jnp.complex64))
    # int16 quantization of a ~1-ulp f32 drift: at most 1 LSB, and the
    # error power must stay >=90 dB below the signal (the bar set by
    # tests/test_sharding.py's dsd equality test)
    got, want = np.asarray(fused.pcm, np.int64), np.concatenate(ref)
    diff = got - want.astype(np.int64)
    assert np.abs(diff).max() <= 1
    sig_p = float(np.mean(want.astype(np.float64) ** 2)) + 1e-30
    assert float(np.mean(diff.astype(np.float64) ** 2)) <= sig_p * 1e-9


def test_faithful_multi_step():
    from sdr_pmr446_tpu.scanner.faithful import FaithfulScannerChain
    k, s = 2, 2
    chain = FaithfulScannerChain(subchunks_per_step=k)
    params = make_runtime_params(C.ScannerArgs())
    blks = _blocks(s, k, seed=21)
    st_a = chain.init_state()
    outs = []
    for i in range(s):
        st_a, o = chain.step(st_a, jnp.asarray(blks[i], jnp.complex64),
                             params)
        outs.append(o)
    st_b = chain.init_state()
    st_b, fused = chain.multi_step(st_b, jnp.asarray(blks, jnp.complex64),
                                   params)
    for f, field in zip(fused, fused._fields):
        ref = np.concatenate([np.asarray(getattr(o, field)) for o in outs])
        _assert_leaf(f, ref, field)
    _assert_int_state_equal(st_a, st_b)


def test_driver_prefetch_depth_equivalence():
    # device prefetch stages the same arrays earlier; results are identical
    k = 2
    iq = _blocks(4, k).reshape(-1)
    r1 = ScannerDriver(subchunks_per_step=k, prefetch_depth=1).run(
        iq_io.block_stream(iq, k * C.SUBCHUNK_IN))
    r4 = ScannerDriver(subchunks_per_step=k, prefetch_depth=4).run(
        iq_io.block_stream(iq, k * C.SUBCHUNK_IN))
    assert r1.events == r4.events
    assert np.array_equal(r1.active_trace, r4.active_trace)
    assert np.array_equal(r1.audio, r4.audio)


def test_dsd_sharded_multi_step():
    from sdr_pmr446_tpu.parallel.dsd_sharded import ShardedDsdInChain
    from sdr_pmr446_tpu.parallel.scanner_sharded import make_mesh
    k, s, n_streams = 2, 2, 2
    mesh = make_mesh(2, 2)
    chain = ShardedDsdInChain(mesh, subchunks_per_step=k)
    fs = C.SDR_SAMPLERATE
    t = np.arange(s * chain.input_len) / fs
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    fmiq = np.exp(1j * 2 * np.pi
                  * (2000.0 * np.cumsum(msg) + 300.0 * np.arange(len(t)))
                  / fs).astype(np.complex64)
    blks = np.stack([fmiq.reshape(s, chain.input_len)] * n_streams, axis=1)

    st_a = chain.init_state(n_streams)
    ref = []
    for i in range(s):
        st_a, o = chain.step(st_a, jnp.asarray(blks[i], jnp.complex64))
        ref.append(np.asarray(o.pcm))
    st_b = chain.init_state(n_streams)
    st_b, fused = chain.multi_step(st_b, jnp.asarray(blks, jnp.complex64))
    want = np.concatenate(ref, axis=1).astype(np.int64)
    got = np.asarray(fused.pcm, np.int64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_multi_step_packed_input():
    # megastep over raw cs16 wire words decodes identically per block
    from sdr_pmr446_tpu.ops import decode
    k, s = 1, 2
    chain = ScannerChain(C.BlockConfig(k), input_format="cs16")
    params = make_runtime_params(C.ScannerArgs())
    blks = _blocks(s, k, seed=3)
    packed = np.stack([decode.pack_iq(b, "cs16") for b in blks])

    st_a = chain.init_state()
    chans = []
    for i in range(s):
        st_a, o = chain.step(st_a, jnp.asarray(packed[i]), params)
        chans.append(np.asarray(o.active_chan))
    st_b = chain.init_state()
    st_b, fused = chain.multi_step(st_b, jnp.asarray(packed), params)
    assert np.array_equal(np.asarray(fused.active_chan),
                          np.concatenate(chans))
