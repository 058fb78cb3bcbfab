"""Squelch FSM + CTCSS detector as a lax.scan over sub-chunk summaries.

The reference's per-chunk control flow (src/sdr_pmr446.c:827-874 state
machine, :605-628 ctcss_execute, :668-700 find_max_rssi_channel) is
inherently sequential in time — but only at sub-chunk granularity (one scalar
decision per ~98 ms).  Here it runs as a lax.scan whose per-step work is a
handful of vector ops over [16] RSSI values and [38, ns] tone phasors, while
all heavy per-sample math stays outside in batched ops.

The Goertzel bank is reformulated exactly: for a zero-initialized Goertzel
over one N-sample window, the power u0^2 + u1^2 - coef*u0*u1 equals
|sum_k x[k] e^{-j w k}|^2 (textbook identity), so per sub-chunk the detector
needs only two masked reductions of x * E against a static phasor table —
no per-sample recurrence.  The carried state is the partial window sum and
the in-window count, matching ctcss_detector_t's (u0, u1, samp_processed)
information content (include/sdr_pmr446.h:42-52).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C


class FsmCarry(NamedTuple):
    fsm_state: jax.Array     # i32
    active_chan: jax.Array   # i32
    rssi: jax.Array          # f32
    ct_count: jax.Array      # i32
    ct_carry: jax.Array      # c64 [38]
    ct_detected: jax.Array   # bool
    ct_max_idx: jax.Array    # i32
    ct_freq: jax.Array       # f32


class FsmOutputs(NamedTuple):
    """Per-sub-chunk outputs (leading axis K after the scan)."""
    active_chan: jax.Array   # i32 [K]  channel gating this sub-chunk's audio
    rel_rssi: jax.Array      # f32 [K]
    ev_tuned: jax.Array      # bool [K]
    ev_detuned: jax.Array    # bool [K]
    ev_changed: jax.Array    # bool [K]
    ev_prev_chan: jax.Array  # i32 [K]  previous channel for 'changed'/'detuned'
    ev_new_chan: jax.Array   # i32 [K]  target channel for 'changed' (pre-detune)
    ct_detected: jax.Array   # bool [K]
    ct_max_idx: jax.Array    # i32 [K]
    ct_freq: jax.Array       # f32 [K]
    ev_ct_acquired: jax.Array  # bool [K]
    ev_ct_changed: jax.Array   # bool [K]
    ev_ct_lost: jax.Array      # bool [K]


@functools.lru_cache(maxsize=None)
def _phasor_table(ns: int) -> np.ndarray:
    """E0[t, i] = exp(-j * w_t * i), static [38, ns] table."""
    w = 2.0 * np.pi * np.asarray(C.CTCSS_FREQS) / C.AUDIO_SAMPLERATE
    i = np.arange(ns)
    return np.exp(-1j * np.outer(w, i)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _count_phasor_table() -> np.ndarray:
    """U[t, c] = exp(-j * w_t * c) for c in [0, CTCSS_BLOCK_SIZE).

    Gathered at the carried in-window count so the window phase reference is
    host-float64-accurate (w*c reaches ~300 rad; f32 phase accumulation would
    drift).
    """
    w = 2.0 * np.pi * np.asarray(C.CTCSS_FREQS) / C.AUDIO_SAMPLERATE
    c = np.arange(C.CTCSS_BLOCK_SIZE)
    return np.exp(-1j * np.outer(w, c)).astype(np.complex64)


def ctcss_tables(ns: int):
    """Static tables for the windowed-DFT CTCSS update (shared by the v1
    scan, the batched v2 scan and faithful mode — single source of truth)."""
    n_win = C.CTCSS_BLOCK_SIZE
    e0 = jnp.asarray(_phasor_table(ns))                    # [38, ns]
    u_table = jnp.asarray(_count_phasor_table())           # [38, 2441]
    # wrap factor applied to post-boundary samples: e^{+j w N}
    # (built in float64 on host — w*N is ~300 rad, keep phase accurate)
    wrap = jnp.asarray(np.exp(
        1j * 2.0 * np.pi * np.asarray(C.CTCSS_FREQS)
        / C.AUDIO_SAMPLERATE * n_win).astype(np.complex64))   # [38]
    freqs = jnp.asarray(np.asarray(C.CTCSS_FREQS, np.float32))
    idx_i = jnp.arange(ns, dtype=jnp.int32)
    return e0, u_table, wrap, freqs, idx_i


def ctcss_subchunk_sums(x, cnt, tables):
    """Pre/post-boundary windowed-DFT sums for one [ns] sub-chunk.

    x: [ns] f32 (DC-blocked CTCSS low-band branch); cnt: samples already in
    the current 2441-window.  Returns (s_pre, s_suf, has_b) with
    s_pre/s_suf [38] c64.  power of the completed window = |carry+s_pre|^2.
    """
    e0, u_table, wrap, _, idx_i = tables
    ns = e0.shape[1]
    n_win = C.CTCSS_BLOCK_SIZE
    u = u_table[:, cnt]
    z = e0 * x[None, :] * u[:, None]
    b = (n_win - 1) - cnt
    pre = (idx_i <= b)[None, :]
    s_pre = jnp.sum(jnp.where(pre, z, 0.0), axis=-1)
    s_suf = jnp.sum(jnp.where(pre, 0.0, z * wrap[:, None]), axis=-1)
    return s_pre, s_suf, b < ns


def ctcss_detect(power):
    """(detected, argmax) per src/sdr_pmr446.c:391-405."""
    avgp = jnp.mean(power)
    pidx = jnp.argmax(power).astype(jnp.int32)
    maxp = power[pidx]
    det = (avgp > C.CTCSS_AVG_POWER_THRESH) & (
        maxp / jnp.maximum(avgp, 1e-30) > C.CTCSS_MAX_AVG_RATIO_THRESH)
    return det, pidx


def fsm_ctcss_scan(carry_in: FsmCarry, rssi_k: jax.Array, lp: jax.Array,
                   mask: jax.Array, squelch: jax.Array, lock_max: jax.Array):
    """Run the FSM+CTCSS scan over K sub-chunks.

    rssi_k: [K, 16] per-sub-chunk per-channel RSSI (dB)
    lp:     [K, 16, ns] DC-blocked CTCSS low-band branch, all channels
    mask:   [16] bool enabled channels; squelch: f32 dB; lock_max: bool
    Returns (carry_out, FsmOutputs with leading K axis).
    """
    K, nch, ns = lp.shape
    n_win = C.CTCSS_BLOCK_SIZE
    tables = ctcss_tables(ns)
    freqs = tables[3]

    nch_en = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)

    def step(carry: FsmCarry, inp):
        rssi_c, lp_c = inp                                  # [16], [16, ns]
        st, act, _, cnt, cc, det, tidx, tfreq = carry

        # --- find_max_rssi_channel (src/sdr_pmr446.c:668-700) ---
        rm = jnp.where(mask, rssi_c, -jnp.inf)
        max_ch = jnp.argmax(rm).astype(jnp.int32)
        avg = jnp.sum(jnp.where(mask, rssi_c, 0.0)) / nch_en.astype(jnp.float32)
        rel = rm[max_ch] - avg

        # --- squelch FSM (src/sdr_pmr446.c:827-874) ---
        scanning = st == 0
        tune = scanning & (rel > squelch)
        in_tuned = jnp.logical_not(scanning)
        do_change = in_tuned & lock_max & (act != max_ch)
        prev_chan = act
        act1 = jnp.where(tune | do_change, max_ch, act)
        detune = in_tuned & (rel < squelch - C.SQUELCH_HYSTERESIS_DB)
        act2 = jnp.where(detune, -1, act1)
        st2 = jnp.where(tune, 1, jnp.where(detune, 0, st)).astype(jnp.int32)

        # detune resets the detector (ctcss_detector_reset + freq=0)
        cnt = jnp.where(detune, 0, cnt)
        cc = jnp.where(detune, 0.0 + 0.0j, cc)
        det_r = jnp.where(detune, False, det)
        tidx_r = jnp.where(detune, 0, tidx)
        tfreq = jnp.where(detune, 0.0, tfreq)

        # --- CTCSS analyze on the active channel (ctcss_execute) ---
        is_active = act2 >= 0
        x = lp_c[jnp.clip(act2, 0, nch - 1)]                # [ns]
        s_pre, s_suf, has_b = ctcss_subchunk_sums(x, cnt, tables)
        y = cc + s_pre
        power = y.real ** 2 + y.imag ** 2                   # Goertzel powers
        newdet, pidx = ctcss_detect(power)

        upd = is_active & has_b
        det2 = jnp.where(upd, newdet, det_r)
        tidx2 = jnp.where(upd, pidx, tidx_r)
        cc2 = jnp.where(is_active,
                        jnp.where(has_b, s_suf, cc + s_pre), cc)
        cnt2 = jnp.where(is_active, (cnt + ns) % n_win, cnt)
        tfreq2 = jnp.where(is_active, freqs[tidx2], tfreq)

        # CTCSS events compare pre/post per call (src/sdr_pmr446.c:607-626)
        acq = is_active & det2 & jnp.logical_not(det_r)
        chg = is_active & det2 & det_r & (tidx2 != tidx_r)
        lost = is_active & jnp.logical_not(det2) & det_r

        carry_out = FsmCarry(st2, act2, rel, cnt2, cc2, det2, tidx2, tfreq2)
        out = FsmOutputs(act2, rel, tune, detune, do_change, prev_chan, act1,
                         det2, tidx2, tfreq2, acq, chg, lost)
        return carry_out, out

    return jax.lax.scan(step, carry_in, (rssi_k, lp))


def fsm_ctcss_scan_v2(carry_in: FsmCarry, rssi_k: jax.Array, lp: jax.Array,
                      mask: jax.Array, squelch: jax.Array,
                      lock_max: jax.Array):
    """Three-phase formulation of fsm_ctcss_scan (identical semantics).

    The v1 scan does [38, ns] elementwise work inside each sequential step.
    Key structural fact: the squelch FSM (and therefore the detector's
    count/reset schedule) depends only on RSSI — never on the tone data — so
    the heavy tone sums can be hoisted out of the recurrence:

      A. scalar lax.scan over K: FSM transitions + per-sub-chunk detector
         counts/boundaries (a handful of scalars per step);
      B. batched tone sums for ALL sub-chunks: two [K, ns] x [ns, 38]
         complex matmuls with masks/phases from phase A;
      C. tiny lax.scan over K carrying only the [38] partial sums and the
         scalar detection state.

    Verified equal to fsm_ctcss_scan by tests/test_fsm_unit.py.
    """
    K, nch, ns = lp.shape
    n_win = C.CTCSS_BLOCK_SIZE
    freqs = jnp.asarray(np.asarray(C.CTCSS_FREQS, np.float32))
    e0 = jnp.asarray(_phasor_table(ns))                    # [38, ns]
    u_table = jnp.asarray(_count_phasor_table())           # [38, 2441]
    wrap = jnp.asarray(np.exp(
        1j * 2.0 * np.pi * np.asarray(C.CTCSS_FREQS)
        / C.AUDIO_SAMPLERATE * n_win).astype(np.complex64))   # [38]
    idx_i = jnp.arange(ns, dtype=jnp.int32)
    nch_en = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)

    # ---- phase A: scalar FSM + count schedule ----
    def step_a(carry, rssi_c):
        st, act, cnt = carry
        rm = jnp.where(mask, rssi_c, -jnp.inf)
        max_ch = jnp.argmax(rm).astype(jnp.int32)
        avg = (jnp.sum(jnp.where(mask, rssi_c, 0.0))
               / nch_en.astype(jnp.float32))
        rel = rm[max_ch] - avg
        scanning = st == 0
        tune = scanning & (rel > squelch)
        in_tuned = jnp.logical_not(scanning)
        do_change = in_tuned & lock_max & (act != max_ch)
        prev_chan = act
        act1 = jnp.where(tune | do_change, max_ch, act)
        detune = in_tuned & (rel < squelch - C.SQUELCH_HYSTERESIS_DB)
        act2 = jnp.where(detune, -1, act1)
        st2 = jnp.where(tune, 1, jnp.where(detune, 0, st)).astype(jnp.int32)
        cnt_r = jnp.where(detune, 0, cnt)
        is_active = act2 >= 0
        b = (n_win - 1) - cnt_r
        has_b = is_active & (b < ns)
        cnt2 = jnp.where(is_active, (cnt_r + ns) % n_win, cnt_r)
        out = (act2, rel, tune, detune, do_change, prev_chan, act1,
               cnt_r, b, has_b, is_active)
        return (st2, act2, cnt2), out

    (st_f, act_f, cnt_f), a = jax.lax.scan(
        step_a, (carry_in.fsm_state, carry_in.active_chan,
                 carry_in.ct_count), rssi_k)
    (act2, rel, tune, detune, do_change, prev_chan, act1,
     cnt_r, b_arr, has_b, is_active) = a

    # ---- phase B: batched tone sums (matmuls) ----
    sel = jnp.clip(act2, 0, nch - 1)
    lp_sel = jnp.take_along_axis(lp, sel[:, None, None], axis=1)[:, 0, :]
    pre = (idx_i[None, :] <= b_arr[:, None]).astype(jnp.float32)  # [K, ns]
    xp = lp_sel * pre
    xs = lp_sel * (1.0 - pre)
    e0t = e0.T                                            # [ns, 38]
    u = u_table.T[cnt_r]                                  # [K, 38]
    # precision=HIGHEST: a lower default precision (TF32 on GPUs) could
    # flip borderline CTCSS detect/argmax decisions vs the v1 scan and the
    # oracle (every value-bearing dot and conv in the repo pins it)
    hi = jax.lax.Precision.HIGHEST
    s_pre = jnp.matmul(xp.astype(jnp.complex64), e0t, precision=hi) * u
    s_suf = (jnp.matmul(xs.astype(jnp.complex64), e0t, precision=hi)
             * (u * wrap[None, :]))

    # ---- phase C: tiny carry scan ([38] partial sums + scalar state) ----
    thr_a = C.CTCSS_AVG_POWER_THRESH
    thr_r = C.CTCSS_MAX_AVG_RATIO_THRESH

    def step_c(carry, inp):
        cc, det, tidx, tfreq = carry
        sp, ss, dt, act_k, hb = inp
        cc_in = jnp.where(dt, 0.0 + 0.0j, cc)
        det_r = jnp.where(dt, False, det)
        tidx_r = jnp.where(dt, 0, tidx)
        tfreq_r = jnp.where(dt, 0.0, tfreq)
        y = cc_in + sp
        power = y.real ** 2 + y.imag ** 2
        avgp = jnp.mean(power)
        pidx = jnp.argmax(power).astype(jnp.int32)
        maxp = power[pidx]
        newdet = (avgp > thr_a) & (maxp / jnp.maximum(avgp, 1e-30) > thr_r)
        upd = act_k & hb
        det2 = jnp.where(upd, newdet, det_r)
        tidx2 = jnp.where(upd, pidx, tidx_r)
        cc2 = jnp.where(act_k, jnp.where(hb, ss, cc_in + sp), cc_in)
        tfreq2 = jnp.where(act_k, freqs[tidx2], tfreq_r)
        acq = act_k & det2 & jnp.logical_not(det_r)
        chg = act_k & det2 & det_r & (tidx2 != tidx_r)
        lost = act_k & jnp.logical_not(det2) & det_r
        return ((cc2, det2, tidx2, tfreq2),
                (det2, tidx2, tfreq2, acq, chg, lost))

    (cc_f, det_f, tidx_f, tfreq_f), c = jax.lax.scan(
        step_c, (carry_in.ct_carry, carry_in.ct_detected,
                 carry_in.ct_max_idx, carry_in.ct_freq),
        (s_pre, s_suf, detune, is_active, has_b))
    det_o, tidx_o, tfreq_o, acq_o, chg_o, lost_o = c

    last_rel = rel[-1] if K > 0 else carry_in.rssi
    carry_out = FsmCarry(st_f, act_f, last_rel, cnt_f, cc_f, det_f,
                         tidx_f, tfreq_f)
    outs = FsmOutputs(act2, rel, tune, detune, do_change, prev_chan, act1,
                      det_o, tidx_o, tfreq_o, acq_o, chg_o, lost_o)
    return carry_out, outs


# ----------------------------------------------------------------------------
# v3: fully associative formulation (no sequential lax.scan at all)
# ----------------------------------------------------------------------------

def _keep_const_scan(keep: jax.Array, val: jax.Array, init: jax.Array):
    """Inclusive prefix of keep-or-set maps: x -> x if keep else val.

    keep/val: [K, ...] per-step maps; init: [...] the value before step 0.
    Returns the [K, ...] value AFTER each step.  Composition
    (g after f) = (f.keep & g.keep, f.val if g.keep else g.val) is
    associative, so the chain runs in log2(K) depth.
    """
    def combine(f, g):                        # g is applied after f
        fk, fv = f
        gk, gv = g
        return fk & gk, jnp.where(gk, fv, gv)

    ks, vs = jax.lax.associative_scan(combine, (keep, val), axis=0)
    return jnp.where(ks, init[None], vs)


class FsmSchedule(NamedTuple):
    """Phase-A outputs: the full FSM/detector schedule, a pure function of
    the per-sub-chunk RSSI (never of the tone data) — so anything tone-
    related downstream (the windowed-DFT sums, even inside a fused
    kernel) can be driven by these tiny [K] vectors."""
    act2: jax.Array       # i32 [K] post-step active channel (-1 = none)
    rel: jax.Array        # f32 [K]
    tune: jax.Array       # bool [K]
    detune: jax.Array     # bool [K]
    do_change: jax.Array  # bool [K]
    act_prev: jax.Array   # i32 [K]
    act1: jax.Array       # i32 [K]
    is_active: jax.Array  # bool [K]
    cnt_r: jax.Array      # i32 [K] in-window count after detune reset
    b_arr: jax.Array      # i32 [K] boundary sample index (n_win-1 - cnt_r)
    has_b: jax.Array      # bool [K] window completes inside this sub-chunk
    upd: jax.Array        # bool [K] detection state updates this sub-chunk
    st_arr: jax.Array     # i32 [K] post-step FSM state
    cnt_arr: jax.Array    # i32 [K] post-step in-window count


def fsm_phase_a(carry_in: FsmCarry, rssi_k: jax.Array, mask: jax.Array,
                squelch: jax.Array, lock_max: jax.Array,
                ns: int) -> FsmSchedule:
    """Associative-scan FSM transitions + detector count schedule (phase A
    of the v3 formulation), batched over K sub-chunks.  Depends only on
    RSSI; identical math to the corresponding section of
    fsm_ctcss_scan_v3 (it IS that section, factored out)."""
    K = rssi_k.shape[0]
    n_win = C.CTCSS_BLOCK_SIZE
    nch_en = jnp.maximum(jnp.sum(mask.astype(jnp.int32)), 1)

    # ---- batched RSSI reductions (no recurrence) ----
    rm = jnp.where(mask[None, :], rssi_k, -jnp.inf)        # [K, 16]
    max_ch = jnp.argmax(rm, axis=-1).astype(jnp.int32)     # [K]
    avg = (jnp.sum(jnp.where(mask[None, :], rssi_k, 0.0), axis=-1)
           / nch_en.astype(jnp.float32))
    rel = jnp.take_along_axis(rm, max_ch[:, None], axis=-1)[:, 0] - avg

    # ---- FSM prefix: maps on (st, act), branch-indexed by st_in ----
    # branch st_in=0: tune -> (1, SET mc) else (0, KEEP)
    # branch st_in=1: detune -> (0, SET -1)
    #                 else (1, SET mc if lock_max else KEEP)
    #                 (when lock_max and act == mc, SET mc == KEEP act)
    tune_b = rel > squelch
    detune_b = rel < squelch - C.SQUELCH_HYSTERESIS_DB
    s_map = jnp.stack([jnp.where(tune_b, 1, 0),
                       jnp.where(detune_b, 0, 1)], axis=-1)  # [K, 2] i32
    keep_map = jnp.stack(
        [jnp.logical_not(tune_b),
         jnp.logical_not(detune_b | jnp.broadcast_to(lock_max, tune_b.shape))],
        axis=-1)                                           # [K, 2]
    val_map = jnp.stack([max_ch, jnp.where(detune_b, -1, max_ch)], axis=-1)

    def fsm_combine(f, g):                    # g applied after f
        fs, fk, fv = f
        gs, gk, gv = g
        s = jnp.take_along_axis(gs, fs, axis=-1)
        gk_f = jnp.take_along_axis(gk, fs, axis=-1)
        gv_f = jnp.take_along_axis(gv, fs, axis=-1)
        return s, fk & gk_f, jnp.where(gk_f, fv, gv_f)

    ss, kk, vv = jax.lax.associative_scan(
        fsm_combine, (s_map, keep_map, val_map), axis=0)
    st0 = carry_in.fsm_state
    act0 = carry_in.active_chan
    st_arr = jnp.take_along_axis(ss, jnp.broadcast_to(st0[None, None],
                                                      (K, 1)), axis=-1)[:, 0]
    k_sel = jnp.take_along_axis(kk, jnp.broadcast_to(st0[None, None],
                                                     (K, 1)), axis=-1)[:, 0]
    v_sel = jnp.take_along_axis(vv, jnp.broadcast_to(st0[None, None],
                                                     (K, 1)), axis=-1)[:, 0]
    act2 = jnp.where(k_sel, act0, v_sel)                   # [K] post-step act
    st_prev = jnp.concatenate([st0[None], st_arr[:-1]])
    act_prev = jnp.concatenate([act0[None], act2[:-1]])

    # per-step event flags from the resolved prefixes (batched)
    scanning = st_prev == 0
    tune = scanning & tune_b
    in_tuned = jnp.logical_not(scanning)
    do_change = in_tuned & lock_max & (act_prev != max_ch)
    act1 = jnp.where(tune | do_change, max_ch, act_prev)
    detune = in_tuned & detune_b
    is_active = act2 >= 0

    # ---- detector count prefix: cnt -> (m*cnt + d) mod n_win ----
    m_map = jnp.where(detune, 0, 1)
    d_map = jnp.where(is_active, ns, 0)

    def cnt_combine(f, g):
        fm, fd = f
        gm, gd = g
        return fm * gm, (gm * fd + gd) % n_win

    cm, cd = jax.lax.associative_scan(cnt_combine, (m_map, d_map), axis=0)
    cnt_arr = (cm * carry_in.ct_count + cd) % n_win        # post-step cnt
    cnt_prev = jnp.concatenate([carry_in.ct_count[None], cnt_arr[:-1]])
    cnt_r = jnp.where(detune, 0, cnt_prev)
    b_arr = (n_win - 1) - cnt_r
    has_b = is_active & (b_arr < ns)
    upd = is_active & has_b
    return FsmSchedule(act2, rel, tune, detune, do_change, act_prev, act1,
                       is_active, cnt_r, b_arr, has_b, upd, st_arr, cnt_arr)


def fsm_tone_sums(sched: FsmSchedule, lp: jax.Array | None,
                  lp_cm: jax.Array | None, ns: int):
    """Phase B: batched windowed-DFT sums (matmuls) for the schedule's selected
    channel — (s_pre, s_suf) [K, 38] c64."""
    K = sched.act2.shape[0]
    n_win = C.CTCSS_BLOCK_SIZE
    e0 = jnp.asarray(_phasor_table(ns))                    # [38, ns]
    u_table = jnp.asarray(_count_phasor_table())           # [38, 2441]
    wrap = jnp.asarray(np.exp(
        1j * 2.0 * np.pi * np.asarray(C.CTCSS_FREQS)
        / C.AUDIO_SAMPLERATE * n_win).astype(np.complex64))   # [38]
    idx_i = jnp.arange(ns, dtype=jnp.int32)
    nch = C.NUM_CHANNELS
    sel = jnp.clip(sched.act2, 0, nch - 1)
    if lp_cm is not None:
        # channel-major gather: reads only the selected rows, no
        # channel-minor copy of the [*, 16, ns] tensor
        lp_sel = lp_cm[sel, jnp.arange(K, dtype=jnp.int32)]
    else:
        lp_sel = jnp.take_along_axis(lp, sel[:, None, None],
                                     axis=1)[:, 0, :]
    pre = (idx_i[None, :] <= sched.b_arr[:, None]).astype(jnp.float32)
    xp = lp_sel * pre
    xs = lp_sel * (1.0 - pre)
    e0t = e0.T                                            # [ns, 38]
    u = u_table.T[sched.cnt_r]                            # [K, 38]
    hi = jax.lax.Precision.HIGHEST
    s_pre = jnp.matmul(xp.astype(jnp.complex64), e0t, precision=hi) * u
    s_suf = (jnp.matmul(xs.astype(jnp.complex64), e0t, precision=hi)
             * (u * wrap[None, :]))
    return s_pre, s_suf


def fsm_phase_c(carry_in: FsmCarry, sched: FsmSchedule, s_pre: jax.Array,
                s_suf: jax.Array):
    """Phase C: Goertzel-carry prefix + detection keep-or-set chains from
    precomputed tone sums ([K, 38] c64 — from fsm_tone_sums or a kernel's
    fused DFT epilogue).  Returns (carry_out, FsmOutputs)."""
    K = sched.act2.shape[0]
    freqs = jnp.asarray(np.asarray(C.CTCSS_FREQS, np.float32))
    (act2, rel, tune, detune, do_change, act_prev, act1, is_active,
     cnt_r, b_arr, has_b, upd, st_arr, cnt_arr) = sched

    # ---- Goertzel carry prefix: cc -> A*cc + B ----
    a_cc = jnp.where(jnp.logical_not(detune) & jnp.logical_not(upd),
                     1.0, 0.0).astype(jnp.complex64)       # [K]
    b_cc = jnp.where(upd[:, None], s_suf,
                     jnp.where(is_active[:, None], s_pre,
                               0.0 + 0.0j))                # [K, 38]

    def cc_combine(f, g):
        fa, fb = f
        ga, gb = g
        return fa * ga, ga[..., None] * fb + gb

    ca, cb = jax.lax.associative_scan(cc_combine, (a_cc, b_cc), axis=0)
    cc_arr = ca[:, None] * carry_in.ct_carry[None, :] + cb  # post-step cc
    cc_prev = jnp.concatenate([carry_in.ct_carry[None], cc_arr[:-1]], axis=0)
    cc_in = jnp.where(detune[:, None], 0.0 + 0.0j, cc_prev)

    # ---- batched detection at every step ----
    y = cc_in + s_pre
    power = y.real ** 2 + y.imag ** 2                      # [K, 38]
    avgp = jnp.mean(power, axis=-1)
    pidx = jnp.argmax(power, axis=-1).astype(jnp.int32)
    maxp = jnp.take_along_axis(power, pidx[:, None], axis=-1)[:, 0]
    newdet = (avgp > C.CTCSS_AVG_POWER_THRESH) & (
        maxp / jnp.maximum(avgp, 1e-30) > C.CTCSS_MAX_AVG_RATIO_THRESH)

    # ---- detected / tone-idx / tone-freq keep-or-set chains ----
    set_dt = upd | detune                   # detune resets, upd overwrites
    det_o = _keep_const_scan(jnp.logical_not(set_dt),
                             jnp.where(upd, newdet, False),
                             carry_in.ct_detected)
    tidx_o = _keep_const_scan(jnp.logical_not(set_dt),
                              jnp.where(upd, pidx, 0),
                              carry_in.ct_max_idx)
    det_prev = jnp.concatenate([carry_in.ct_detected[None], det_o[:-1]])
    tidx_prev = jnp.concatenate([carry_in.ct_max_idx[None], tidx_o[:-1]])
    det_r = jnp.where(detune, False, det_prev)
    tidx_r = jnp.where(detune, 0, tidx_prev)
    set_tf = is_active | detune
    tfreq_o = _keep_const_scan(
        jnp.logical_not(set_tf),
        jnp.where(is_active, freqs[tidx_o], 0.0),
        carry_in.ct_freq)

    acq_o = is_active & det_o & jnp.logical_not(det_r)
    chg_o = is_active & det_o & det_r & (tidx_o != tidx_r)
    lost_o = is_active & jnp.logical_not(det_o) & det_r

    last = lambda a, init: a[-1] if K > 0 else init
    carry_out = FsmCarry(
        last(st_arr, carry_in.fsm_state).astype(jnp.int32),
        last(act2, carry_in.active_chan),
        last(rel, carry_in.rssi), last(cnt_arr, carry_in.ct_count),
        last(cc_arr, carry_in.ct_carry), last(det_o, carry_in.ct_detected),
        last(tidx_o, carry_in.ct_max_idx), last(tfreq_o, carry_in.ct_freq))
    outs = FsmOutputs(act2, rel, tune, detune, do_change, act_prev, act1,
                      det_o, tidx_o, tfreq_o, acq_o, chg_o, lost_o)
    return carry_out, outs


def fsm_ctcss_scan_v3(carry_in: FsmCarry, rssi_k: jax.Array, lp: jax.Array,
                      mask: jax.Array, squelch: jax.Array,
                      lock_max: jax.Array, lp_cm: jax.Array | None = None):
    """Associative-scan formulation of fsm_ctcss_scan (identical semantics).

    ``lp_cm`` ([16, K, ns], channel-major — the layout kernels emit) may
    be passed INSTEAD of ``lp`` ([K, 16, ns]): phase B then gathers the
    active channel's rows directly, so no channel-minor copy of the full
    lp tensor is ever materialized (the gather reads only the selected
    1/16th).  Values are identical either way.

    v2 still runs two sequential lax.scans over K (phase A's FSM
    transitions, phase C's [38]-carry chain) — on an accelerator those are 2*K serial
    loop iterations and profile as the chain's single largest stage.  Every
    recurrence involved is a composition of maps from tiny monoids:

      - squelch FSM: per-step maps on (state, active_chan) that branch on a
        2-value state and either KEEP or SET the channel — composable;
      - detector count: affine maps cnt -> (m*cnt + d) mod 2441, m in {0,1};
      - Goertzel carry: affine maps cc -> A*cc + B with scalar A in {0,1}
        (resets cut chains every <=2 active sub-chunks, so f32 sums keep
        their sequential association in practice);
      - detected/tone-idx/tone-freq: KEEP-or-SET chains.

    so the whole control layer runs as five jax.lax.associative_scans of
    log2(K) depth plus batched tensor ops, factored here into
    fsm_phase_a (RSSI-only schedule) -> fsm_tone_sums (matmul DFT) ->
    fsm_phase_c (detection chains).  Equality with v1 is test-enforced
    (tests/test_fsm_unit.py).
    """
    if lp_cm is not None:
        assert lp is None
        _, _, ns = lp_cm.shape
    else:
        _, _, ns = lp.shape
    sched = fsm_phase_a(carry_in, rssi_k, mask, squelch, lock_max, ns)
    s_pre, s_suf = fsm_tone_sums(sched, lp, lp_cm, ns)
    return fsm_phase_c(carry_in, sched, s_pre, s_suf)
