"""Targeted FSM/CTCSS-scan unit tests against the per-sample oracle.

Exercises the trickiest reformulation math directly: window-boundary
crossing (count wrap), phase continuity across sub-chunks, tone-change
events, and detector resets on detune.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.oracle.chain import GoertzelDetector
from sdr_pmr446_tpu.scanner.fsm import FsmCarry, fsm_ctcss_scan

NS = C.SUBCHUNK_AUDIO


def _carry0():
    return FsmCarry(
        jnp.asarray(0, jnp.int32), jnp.asarray(-1, jnp.int32),
        jnp.asarray(0.0, jnp.float32), jnp.asarray(0, jnp.int32),
        jnp.zeros(C.CTCSS_NUM_FREQS, jnp.complex64),
        jnp.asarray(False), jnp.asarray(0, jnp.int32),
        jnp.asarray(-1.0, jnp.float32))


def _run(signal, rssi_db=None, k=None):
    """Force channel 0 active (high RSSI) and push `signal` through CTCSS."""
    k = k or len(signal) // NS
    lp = np.zeros((k, 16, NS), np.float32)
    lp[:, 0, :] = signal[: k * NS].reshape(k, NS)
    if rssi_db is None:
        rssi_db = np.full((k, 16), -80.0, np.float32)
        rssi_db[:, 0] = -10.0
    carry, outs = fsm_ctcss_scan(
        _carry0(), jnp.asarray(rssi_db), jnp.asarray(lp),
        jnp.ones(16, bool), jnp.float32(18.0), jnp.asarray(False))
    return carry, outs


def _oracle_detector(signal, k):
    """Reference per-sample detector fed the same gated stream."""
    g = GoertzelDetector()
    det, idx = [], []
    for i in range(k):
        g.analyze(signal[i * NS:(i + 1) * NS])
        det.append(g.tone_detected)
        idx.append(g.max_power_index)
    return np.asarray(det), np.asarray(idx)


def test_detection_trajectory_matches_oracle():
    # tone 20 for 30 sub-chunks, then tone 5: detection must follow with the
    # same per-sub-chunk timing as the per-sample Goertzel bank
    k = 60
    t = np.arange(k * NS) / C.AUDIO_SAMPLERATE
    f1, f2 = C.CTCSS_FREQS[19], C.CTCSS_FREQS[4]
    half = k * NS // 2
    sig = np.where(np.arange(k * NS) < half,
                   0.3 * np.sin(2 * np.pi * f1 * t),
                   0.3 * np.sin(2 * np.pi * f2 * t)).astype(np.float32)
    _, outs = _run(sig, k=k)
    det_o, idx_o = _oracle_detector(sig.astype(np.float64), k)
    np.testing.assert_array_equal(np.asarray(outs.ct_detected), det_o)
    np.testing.assert_array_equal(np.asarray(outs.ct_max_idx), idx_o)
    # the change produced exactly one acquire and one change event
    assert np.asarray(outs.ev_ct_acquired).sum() == 1
    assert np.asarray(outs.ev_ct_changed).sum() == 1


def test_no_detection_on_noise():
    rng = np.random.default_rng(0)
    k = 20
    sig = (0.05 * rng.standard_normal(k * NS)).astype(np.float32)
    _, outs = _run(sig, k=k)
    det_o, idx_o = _oracle_detector(sig.astype(np.float64), k)
    np.testing.assert_array_equal(np.asarray(outs.ct_detected), det_o)
    assert not np.asarray(outs.ct_detected).any()


def test_reset_on_detune_matches_oracle():
    # active for 10 sub-chunks (tone), scanning (low rssi) for 5, active again:
    # the detector must reset at detune and re-acquire with fresh windows
    k = 25
    t = np.arange(k * NS) / C.AUDIO_SAMPLERATE
    sig = (0.3 * np.sin(2 * np.pi * C.CTCSS_FREQS[11] * t)).astype(np.float32)
    rssi = np.full((k, 16), -80.0, np.float32)
    rssi[:10, 0] = -10.0
    rssi[15:, 0] = -10.0
    _, outs = _run(sig, rssi_db=rssi, k=k)

    g = GoertzelDetector()
    det_o = []
    active = np.asarray(outs.active_chan) >= 0
    was_active = False
    for i in range(k):
        if was_active and not active[i]:
            g.reset()
        if active[i]:
            g.analyze(sig[i * NS:(i + 1) * NS].astype(np.float64))
        det_o.append(g.tone_detected)
        was_active = active[i]
    np.testing.assert_array_equal(np.asarray(outs.ct_detected),
                                  np.asarray(det_o))
    assert np.asarray(outs.ev_ct_acquired).sum() == 2


def test_powers_match_oracle_exactly():
    # numerical check of the |sum x e^{-jwk}|^2 == Goertzel power identity
    # through the scan machinery (window boundary inside sub-chunk 2)
    k = 4
    rng = np.random.default_rng(7)
    sig = (0.2 * np.sin(2 * np.pi * 110.9 * np.arange(k * NS) / 12500)
           + 0.02 * rng.standard_normal(k * NS)).astype(np.float32)
    _, outs = _run(sig, k=k)
    det_o, idx_o = _oracle_detector(sig.astype(np.float64), k)
    np.testing.assert_array_equal(np.asarray(outs.ct_max_idx), idx_o)


def test_v2_scan_equals_v1():
    """fsm_ctcss_scan_v2 must be output-identical to the v1 scan across a
    busy scenario (tunes, detunes, tone changes, boundaries)."""
    from sdr_pmr446_tpu.scanner.fsm import fsm_ctcss_scan_v2
    rng = np.random.default_rng(9)
    k = 40
    t = np.arange(k * NS) / C.AUDIO_SAMPLERATE
    sig = np.where(np.arange(k * NS) < k * NS // 2,
                   0.3 * np.sin(2 * np.pi * C.CTCSS_FREQS[19] * t),
                   0.3 * np.sin(2 * np.pi * C.CTCSS_FREQS[4] * t))
    lp = 0.01 * rng.standard_normal((k, 16, NS)).astype(np.float32)
    lp[:, 3, :] += sig.reshape(k, NS).astype(np.float32)
    rssi = np.full((k, 16), -80.0, np.float32)
    rssi[:, 3] = -10.0
    rssi[10:14, 3] = -80.0        # mid-run detune window
    carry = _carry0()
    args = (jnp.asarray(rssi), jnp.asarray(lp), jnp.ones(16, bool),
            jnp.float32(18.0), jnp.asarray(False))
    c1, o1 = fsm_ctcss_scan(carry, *args)
    c2, o2 = fsm_ctcss_scan_v2(carry, *args)
    for f in o1._fields:
        v1 = np.asarray(getattr(o1, f))
        v2 = np.asarray(getattr(o2, f))
        if v1.dtype.kind == "f":
            np.testing.assert_allclose(v1, v2, rtol=0, atol=2e-3, err_msg=f)
        else:
            np.testing.assert_array_equal(v1, v2, err_msg=f)
    for f in c1._fields:
        v1, v2 = np.asarray(getattr(c1, f)), np.asarray(getattr(c2, f))
        if v1.dtype.kind in "fc":
            np.testing.assert_allclose(v1, v2, rtol=0, atol=2e-2, err_msg=f)
        else:
            np.testing.assert_array_equal(v1, v2, err_msg=f)


def _assert_scan_equal(c1, o1, c2, o2, name):
    for f in o1._fields:
        v1 = np.asarray(getattr(o1, f))
        v2 = np.asarray(getattr(o2, f))
        if v1.dtype.kind == "f":
            np.testing.assert_allclose(v1, v2, rtol=0, atol=2e-3,
                                       err_msg=f"{name}:{f}")
        else:
            np.testing.assert_array_equal(v1, v2, err_msg=f"{name}:{f}")
    for f in c1._fields:
        v1, v2 = np.asarray(getattr(c1, f)), np.asarray(getattr(c2, f))
        if v1.dtype.kind in "fc":
            np.testing.assert_allclose(v1, v2, rtol=0, atol=2e-2,
                                       err_msg=f"{name}:{f}")
        else:
            np.testing.assert_array_equal(v1, v2, err_msg=f"{name}:{f}")


def test_v3_scan_equals_v1():
    """fsm_ctcss_scan_v3 (associative formulation) == v1 across randomized
    busy scenarios: random tune/detune patterns, lock_max on and off,
    masked channels, streaming carry across consecutive calls."""
    from sdr_pmr446_tpu.scanner.fsm import fsm_ctcss_scan_v3
    rng = np.random.default_rng(17)
    for trial in range(4):
        k = [7, 16, 40, 23][trial]
        lock = trial % 2 == 1
        mask = np.ones(16, bool)
        if trial == 2:
            mask[5] = False
        carry1 = _carry0()
        carry3 = _carry0()
        for blk in range(3):
            t0 = blk * k * NS
            t = (t0 + np.arange(k * NS)) / C.AUDIO_SAMPLERATE
            tone = C.CTCSS_FREQS[(trial * 7 + blk) % 38]
            sig = 0.3 * np.sin(2 * np.pi * tone * t)
            lp = 0.01 * rng.standard_normal((k, 16, NS)).astype(np.float32)
            ch = (trial + blk) % 16
            if not mask[ch]:
                ch = (ch + 1) % 16
            lp[:, ch, :] += sig.reshape(k, NS).astype(np.float32)
            rssi = np.full((k, 16), -80.0, np.float32)
            rssi[:, ch] = -10.0
            # random detune windows + channel hops
            for _ in range(2):
                a = rng.integers(0, k)
                b = min(k, a + int(rng.integers(1, 5)))
                rssi[a:b, ch] = -80.0
            ch2 = (ch + 3) % 16
            a = rng.integers(0, k)
            rssi[a:, ch2] = -5.0
            args = (jnp.asarray(rssi), jnp.asarray(lp), jnp.asarray(mask),
                    jnp.float32(18.0), jnp.asarray(lock))
            c1, o1 = fsm_ctcss_scan(carry1, *args)
            c3, o3 = fsm_ctcss_scan_v3(carry3, *args)
            _assert_scan_equal(c1, o1, c3, o3,
                               f"trial{trial}blk{blk}")
            carry1, carry3 = c1, c3


_V3_JIT = None


@pytest.mark.parametrize("code", range(1, C.CTCSS_NUM_FREQS + 1))
def test_every_ctcss_tone_identified_by_v3(code):
    """Each of the 38 CTCSS tones, on a channel that changes with the
    code, through the associative-scan FSM the chain runs
    (fsm_ctcss_scan_v3, channel-major lp): detected and identified as
    that code, with the per-sub-chunk trajectory of the float64 Goertzel
    bank."""
    global _V3_JIT
    from sdr_pmr446_tpu.scanner.fsm import fsm_ctcss_scan_v3
    if _V3_JIT is None:                 # one compile for all 38 cases
        _V3_JIT = jax.jit(lambda c, r, lp: fsm_ctcss_scan_v3(
            c, r, None, jnp.ones(16, bool), jnp.float32(18.0),
            jnp.asarray(False), lp_cm=lp))
    k = 6
    ch = (code * 5) % 16
    rng = np.random.default_rng(code)
    t = np.arange(k * NS) / C.AUDIO_SAMPLERATE
    sig = (0.15 * np.sin(2 * np.pi * C.CTCSS_FREQS[code - 1] * t + code)
           + 0.01 * rng.standard_normal(k * NS)).astype(np.float32)
    lp = np.zeros((16, k, NS), np.float32)
    lp[ch] = sig.reshape(k, NS)
    rssi = np.full((k, 16), -80.0, np.float32)
    rssi[:, ch] = -10.0
    _, outs = _V3_JIT(_carry0(), jnp.asarray(rssi), jnp.asarray(lp))
    det_o, idx_o = _oracle_detector(sig.astype(np.float64), k)
    np.testing.assert_array_equal(np.asarray(outs.active_chan), ch)
    np.testing.assert_array_equal(np.asarray(outs.ct_detected), det_o)
    np.testing.assert_array_equal(np.asarray(outs.ct_max_idx), idx_o)
    assert bool(np.asarray(outs.ct_detected)[-1])
    assert int(np.asarray(outs.ct_max_idx)[-1]) == code - 1
    np.testing.assert_allclose(np.asarray(outs.ct_freq)[-1],
                               C.CTCSS_FREQS[code - 1], rtol=1e-6)
