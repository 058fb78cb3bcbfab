"""Carried-state pytree of the scanner chain.

This is the complete streaming state of SURVEY.md §2c: everything the
reference keeps inside liquid objects (FIR histories, IIR states, NCO phase,
freqdem previous sample, Goertzel accumulators, FSM scalars) made explicit as
one NamedTuple of arrays.  It doubles as the checkpoint format: serializing
(block_index, ScannerState) is a complete resume point (SURVEY.md §5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sdr_pmr446_tpu import config as C


class ScannerState(NamedTuple):
    # front-end (input rate)
    dc_x: jax.Array            # c64 []     IQ DC blocker x[-1]
    dc_y: jax.Array            # c64 []     IQ DC blocker y[-1]
    resamp_hist: jax.Array     # c64 [P-1]  resampler input history
    # band rate (200 kHz)
    pfb_hist: jax.Array        # c64 [400]  channelizer history
    frame_parity: jax.Array    # i32 []     global PFB frame count mod 2
    # channel rate (12.5 kHz), per channel
    demod_prev: jax.Array      # c64 [16]   freqdem previous sample
    hp_hist: jax.Array         # f32 [16, 376]
    delay_hist: jax.Array      # f32 [16, 188]
    lp_dc_x: jax.Array         # f32 [16]   CTCSS-branch DC blocker
    lp_dc_y: jax.Array         # f32 [16]
    deemph_hist: jax.Array     # f32 [16, deemph_taps-1]
    audio_lp_hist: jax.Array   # f32 [16, 102]
    # control (squelch FSM, src/sdr_pmr446.c:827-874)
    fsm_state: jax.Array       # i32 []     0=scanning 1=tuned
    active_chan: jax.Array     # i32 []     -1..15
    rssi: jax.Array            # f32 []     last relative RSSI
    # CTCSS detector (src/sdr_pmr446.c:338-418 reformulated)
    ct_count: jax.Array        # i32 []     samples into current 2441-window
    ct_carry: jax.Array        # c64 [38]   partial windowed-DFT sums
    ct_detected: jax.Array     # bool []
    ct_max_idx: jax.Array      # i32 []
    ct_freq: jax.Array         # f32 []     displayed CTCSS frequency
    wf_hist: jax.Array         # c64 [w//2] asgram sliding-window band
    #                            history ([0] when the waterfall is off)
    wf_cnt: jax.Array          # i32 []     asgram in-hop sample counter
    #                            (always 0 when the hop divides the
    #                            sub-chunk — the static fast path)


def init_scanner_state(resamp_hist_len: int, pfb_hist_len: int,
                       deemph_hist_len: int,
                       waterfall: int = 0) -> ScannerState:
    nch = C.NUM_CHANNELS
    return ScannerState(
        dc_x=jnp.zeros((), jnp.complex64),
        dc_y=jnp.zeros((), jnp.complex64),
        resamp_hist=jnp.zeros((resamp_hist_len,), jnp.complex64),
        pfb_hist=jnp.zeros((pfb_hist_len,), jnp.complex64),
        frame_parity=jnp.zeros((), jnp.int32),
        demod_prev=jnp.zeros((nch,), jnp.complex64),
        hp_hist=jnp.zeros((nch, C.HP_AUDIO_FILT_TAPS - 1), jnp.float32),
        delay_hist=jnp.zeros((nch, C.CTCSS_DELAY), jnp.float32),
        lp_dc_x=jnp.zeros((nch,), jnp.float32),
        lp_dc_y=jnp.zeros((nch,), jnp.float32),
        deemph_hist=jnp.zeros((nch, deemph_hist_len), jnp.float32),
        audio_lp_hist=jnp.zeros((nch, C.LP_AUDIO_FILT_TAPS - 1), jnp.float32),
        fsm_state=jnp.zeros((), jnp.int32),
        active_chan=jnp.full((), -1, jnp.int32),
        rssi=jnp.zeros((), jnp.float32),
        ct_count=jnp.zeros((), jnp.int32),
        ct_carry=jnp.zeros((C.CTCSS_NUM_FREQS,), jnp.complex64),
        ct_detected=jnp.zeros((), jnp.bool_),
        ct_max_idx=jnp.zeros((), jnp.int32),
        ct_freq=jnp.full((), -1.0, jnp.float32),
        # waterfall <= 0 means "off" everywhere (chain guards on > 0)
        wf_hist=jnp.zeros((max(waterfall, 0) // 2,), jnp.complex64),
        wf_cnt=jnp.zeros((), jnp.int32),
    )


def adapt_state_histories(state, reference):
    """Reconcile checkpoint history lengths with the target chain's.

    Chain configuration changes the carried history lengths (the
    de-emphasis history is longer under fir_deemph), so a checkpoint saved
    under one configuration would fail to restore under another with a
    bare shape mismatch.  History semantics make the
    migration well-defined: newest samples live at the END of every
    ``*_hist`` field, so a longer target is LEFT-extended with zeros
    (the extra look-behind decays out within one filter length) and a
    shorter one keeps the newest suffix.  Non-history mismatches raise.
    """
    fields = getattr(state, "_fields", None)
    vals = []
    for i, (cur, ref) in enumerate(zip(state, reference)):
        name = fields[i] if fields else str(i)
        if cur is None:
            # field appended to the pytree after the checkpoint was
            # written (tolerant loaders yield None): take the init value
            vals.append(ref)
            continue
        if cur.shape == ref.shape:
            vals.append(cur)
            continue
        same_lead = cur.shape[:-1] == ref.shape[:-1]
        if not (name.endswith("_hist") and cur.ndim >= 1 and same_lead):
            raise ValueError(
                f"checkpoint field {name!r} has shape {cur.shape}, chain "
                f"expects {ref.shape} — not a history, cannot migrate")
        want = ref.shape[-1]
        have = cur.shape[-1]
        if have >= want:
            vals.append(cur[..., have - want:])
        else:
            pad = [(0, 0)] * (cur.ndim - 1) + [(want - have, 0)]
            vals.append(jnp.pad(cur, pad))
    return type(state)(*vals)


def save_state(path: str, block_index: int, state: ScannerState) -> None:
    """Checkpoint = (block index, full carried-state pytree) -> .npz."""
    from sdr_pmr446_tpu.runtime.transfer import fetch
    host = fetch(list(state))
    arrs = {f"s{i}": v for i, v in enumerate(host)}
    # through a file object: np.savez would append ".npz" to a bare path
    with open(path, "wb") as f:
        np.savez(f, block_index=np.int64(block_index), **arrs)


def load_state(path: str) -> tuple[int, ScannerState]:
    z = np.load(path)
    n = len(ScannerState._fields)
    # fields appended after a checkpoint was written load as None and are
    # filled with the chain's init values by adapt_state_histories
    # (driver.restore always routes through it)
    vals = [jnp.asarray(z[f"s{i}"]) if f"s{i}" in z else None
            for i in range(n)]
    return int(z["block_index"]), ScannerState(*vals)


# ------------------------------------------------------------- orbax backend
def save_state_orbax(path: str, block_index: int, state) -> None:
    """Orbax checkpoint: the production/multi-host-idiomatic backend.

    Same contract as save_state (complete resume point, SURVEY.md §5) but
    stored as an Orbax StandardCheckpoint — sharded arrays save without a
    host gather on real meshes, and the format is the JAX-ecosystem
    standard.  ``path`` is a directory.  Works for any chain's state
    pytree, not just ScannerState.
    """
    import json
    import os
    import orbax.checkpoint as ocp
    from sdr_pmr446_tpu.runtime.transfer import fetch
    host = [np.asarray(v) for v in fetch(list(state))]
    # orbax refuses zero-size arrays (e.g. wf_hist with the waterfall
    # off): store their (shape, dtype) as metadata instead
    leaves, empties = {}, {}
    for i, v in enumerate(host):
        if v.size == 0:
            empties[f"s{i}"] = [list(v.shape), str(v.dtype)]
        else:
            leaves[f"s{i}"] = v
    meta = np.frombuffer(json.dumps(empties).encode(), np.uint8).copy()
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(path),
                   {"block_index": np.int64(block_index),
                    "leaves": leaves, "empties": meta},
                   force=True)


def load_state_orbax(path: str, state_cls=ScannerState):
    """Restore (block_index, state) from an Orbax checkpoint directory."""
    import json
    import os
    import orbax.checkpoint as ocp
    with ocp.StandardCheckpointer() as ckptr:
        tree = ckptr.restore(os.path.abspath(path))
    empties = json.loads(bytes(np.asarray(tree["empties"],
                                          np.uint8)).decode())
    n = len(state_cls._fields)
    vals = []
    for i in range(n):
        key = f"s{i}"
        if key in empties:
            shape, dtype = empties[key]
            vals.append(jnp.zeros(tuple(shape), dtype))
        elif key in tree["leaves"]:
            vals.append(jnp.asarray(tree["leaves"][key]))
        else:
            # field appended after this checkpoint was written: filled
            # with init values by adapt_state_histories downstream
            vals.append(None)
    return int(tree["block_index"]), state_cls(*vals)
