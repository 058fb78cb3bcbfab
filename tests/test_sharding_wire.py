"""Sharded == unsharded on the raw wire formats the apps ship.

Every sharded chain decodes its own time shard of wire words on device;
these gates compare each against the unsharded chain fed the SAME wire
words, so a word shard that decoded to the wrong samples, or a halo that
crossed a word boundary wrongly, shows as a mismatch.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode
from sdr_pmr446_tpu.parallel.scanner_sharded import (ShardedScannerChain,
                                                     make_mesh)
from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params

K = 4
N_STEPS = 2


def _wires(fmt, n_stream, n):
    """One wire capture per stream: channel 3+s, CTCSS code 5+s."""
    return [decode.pack_iq(0.8 * synth.make_scanner_iq(
        n, channel=3 + s, ctcss_code=5 + s, seed=s), fmt)
        for s in range(n_stream)]


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("fmt", ["cf32w", "cs16", "cu8", "cs8"])
def test_sharded_scanner_wire_equals_unsharded(fmt, mesh_shape):
    n_stream, n_time = mesh_shape
    ref = ScannerChain(C.BlockConfig(K), input_format=fmt)
    wl = ref.step_arg_len
    wires = _wires(fmt, n_stream, N_STEPS * ref.input_len)
    params = make_runtime_params(C.ScannerArgs())
    refs = []
    for w in wires:
        st = ref.init_state()
        outs = []
        for i in range(N_STEPS):
            st, o = ref.step(st, jnp.asarray(w[i * wl:(i + 1) * wl]), params)
            outs.append(o)
        refs.append(outs)

    chain = ShardedScannerChain(make_mesh(n_stream, n_time),
                                C.BlockConfig(K), input_format=fmt)
    assert chain.step_arg_len == wl
    st = chain.init_state(n_stream)
    for i in range(N_STEPS):
        blk = np.stack([w[i * wl:(i + 1) * wl] for w in wires])
        st, out = chain.step(st, jnp.asarray(blk), params)
        for s in range(n_stream):
            r = refs[s][i]
            for f in ("active_chan", "audio_valid", "ct_detected",
                      "ct_max_idx", "ev_tuned", "ev_ct_acquired"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(out, f))[s],
                    np.asarray(getattr(r, f)), err_msg=f"{f} step {i}")
            np.testing.assert_allclose(np.asarray(out.rssi_db)[s],
                                       np.asarray(r.rssi_db),
                                       rtol=0, atol=5e-4)
            np.testing.assert_allclose(np.asarray(out.audio)[s],
                                       np.asarray(r.audio),
                                       rtol=0, atol=1e-4)


def _fm_capture(n):
    fs = C.SDR_SAMPLERATE
    t = np.arange(n) / fs
    msg = 0.4 * np.sin(2 * np.pi * 900.0 * t)
    return 0.8 * np.exp(1j * 2 * np.pi * (1500 * np.cumsum(msg)
                                          + 2000 * np.arange(n)) / fs)


@pytest.mark.parametrize("fmt", ["cs16", "cu8", "cf32w"])
def test_sharded_dsd_wire_equals_unsharded(fmt):
    """PCM within 1 LSB: the sharded DC blocker's affine carry rounds
    differently from the sequential scan (tests/test_sharding.py)."""
    from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu.parallel.dsd_sharded import ShardedDsdInChain
    ref = DsdInChain(K, input_format=fmt)
    wl = ref.step_arg_len
    wire = decode.pack_iq(_fm_capture(N_STEPS * ref.input_len), fmt)
    chain = ShardedDsdInChain(make_mesh(1, 4), K, input_format=fmt)
    st1, st2 = ref.init_state(), chain.init_state(1)
    for i in range(N_STEPS):
        w = jnp.asarray(wire[i * wl:(i + 1) * wl])
        st1, o1 = ref.step(st1, w)
        st2, o2 = chain.step(st2, w[None])
        err = (np.asarray(o2.pcm)[0].astype(np.int64)
               - np.asarray(o1.pcm).astype(np.int64))
        assert np.max(np.abs(err)) <= 1, (fmt, i)


@pytest.mark.parametrize("fmt", ["cf32w", "cs16"])
def test_sharded_single_wire_equals_unsharded(fmt):
    from sdr_pmr446_tpu.scanner.single import SingleChannelChain
    from sdr_pmr446_tpu.parallel.single_sharded import ShardedSingleChain
    chan = 7
    ref = SingleChannelChain(channel=chan, subchunks_per_step=K,
                             input_format=fmt)
    wl = ref.step_arg_len
    wire = decode.pack_iq(0.8 * synth.make_scanner_iq(
        N_STEPS * ref.input_len, channel=chan, ctcss_code=3), fmt)
    chain = ShardedSingleChain(make_mesh(1, 4), channel=chan,
                               subchunks_per_step=K, input_format=fmt)
    st1, st2 = ref.init_state(), chain.init_state(1)
    for i in range(N_STEPS):
        w = jnp.asarray(wire[i * wl:(i + 1) * wl])
        st1, a1 = ref.step(st1, w)
        st2, a2 = chain.step(st2, w[None])
        r = np.asarray(a1, np.float64)
        err = np.asarray(a2, np.float64)[0] - r
        snr = 10 * np.log10(np.mean(r ** 2) / max(np.mean(err ** 2), 1e-30))
        assert snr > 90.0, (fmt, i, snr)
