"""Halo-exchange primitives for time-sharded streaming DSP.

This is the distributed backbone of SURVEY.md §2c: when one IQ stream's time
axis is sharded across devices, every causal filter needs the last
``hist_len`` samples of its LEFT neighbor's shard (overlap-save).  Inside a
``shard_map`` these helpers exchange exactly that via ``ppermute`` over the
time mesh axis (NCCL on GPUs), and reconstruct the cross-block carried state from the LAST
shard.

One-pole IIRs can't use a finite halo exactly; instead the recurrence is
solved from zero state per shard and corrected with an affine carry
composition over the gathered per-shard endpoints — exact, one small
``all_gather`` of scalars per section (the block equivalent of the reference's
single retained y[-1], src/sdr_pmr446.c:422,450).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sdr_pmr446_tpu.ops import iir


def _perm_right(num: int):
    """Source -> dest pairs sending each shard's tail to its right neighbor."""
    return [(i, i + 1) for i in range(num - 1)]


def shard_hist(carried_hist: jax.Array, x_shard: jax.Array, hist_len: int,
               axis: str):
    """History for this shard: left neighbor's tail (or carried for shard 0).

    Returns (hist, new_carried) where new_carried is the LAST shard's tail
    broadcast to all shards (the cross-block carried state).
    """
    num = jax.lax.axis_size(axis)
    d = jax.lax.axis_index(axis)
    tail = x_shard[..., x_shard.shape[-1] - hist_len:]
    if num == 1:
        return carried_hist, tail
    left = jax.lax.ppermute(tail, axis, _perm_right(num))
    hist = jnp.where(d == 0, carried_hist, left)
    new_carried = jax.lax.psum(
        jnp.where(d == num - 1, tail, jnp.zeros_like(tail)), axis)
    return hist, new_carried


def shard_biquad1(state, x_shard: jax.Array, b0: float, b1: float, a1: float,
                  axis: str, chunk: int = 128):
    """First-order section y[n] = b0 x + b1 x[n-1] - a1 y[n-1], time-sharded.

    ``state`` = (x_prev, y_prev) carried across block steps (replicated on
    all shards).  Exact: local from-zero scans + affine carry composition
    across shards.
    """
    num = jax.lax.axis_size(axis)
    if num == 1:
        return iir.biquad1_apply(state, x_shard, b0, b1, a1, chunk=chunk)

    x_prev_c, y_prev_c = state
    d = jax.lax.axis_index(axis)
    ts = x_shard.shape[-1]
    p = -a1

    # x[n-1] across the shard boundary: single-sample halo
    last = x_shard[..., -1]
    left_last = jax.lax.ppermute(last, axis, _perm_right(num))
    x_prev = jnp.where(d == 0, x_prev_c, left_last)
    x1 = jnp.concatenate([x_prev[..., None], x_shard[..., :-1]], axis=-1)
    z = b0 * x_shard + b1 * x1

    # local recurrence from zero state
    zero = jnp.zeros_like(last)
    y_local = iir.first_order_scan(z, p, zero, chunk=chunk)
    y_end = y_local[..., -1]

    # affine carry composition: c_d = p^(ts*d) * y_prev
    #                                + sum_{d'<d} p^(ts*(d-1-d')) * y_end[d']
    all_ye = jax.lax.all_gather(y_end, axis)           # [D, ...]
    pT = jnp.asarray(p, y_local.dtype) ** ts
    k = jnp.arange(num)
    # weights for this shard: w[d'] = pT^(d-1-d') if d' < d else 0
    expo = (d - 1 - k).astype(jnp.float32)
    w = jnp.where(k < d, pT ** jnp.maximum(expo, 0.0), 0.0)
    w = w.reshape((num,) + (1,) * (all_ye.ndim - 1)).astype(all_ye.dtype)
    carry_in = (pT ** d.astype(jnp.float32)) * y_prev_c + jnp.sum(
        w * all_ye, axis=0)

    pj = (jnp.asarray(p, y_local.dtype)
          ** jnp.arange(1, ts + 1, dtype=jnp.float32)).astype(y_local.dtype)
    y = y_local + carry_in[..., None] * pj

    new_x_prev = jax.lax.psum(
        jnp.where(d == num - 1, last, jnp.zeros_like(last)), axis)
    new_y_prev = jax.lax.psum(
        jnp.where(d == num - 1, y[..., -1], jnp.zeros_like(y_end)), axis)
    return (new_x_prev, new_y_prev), y


def shard_dc_blocker(state, x_shard, alpha: float, axis: str,
                     chunk: int = 128):
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    return shard_biquad1(state, x_shard, g, -g, -p, axis, chunk=chunk)


def shard_scalar_prev(carried_prev: jax.Array, x_shard: jax.Array,
                      axis: str):
    """1-sample halo (freqdem previous-sample state across shards)."""
    num = jax.lax.axis_size(axis)
    last = x_shard[..., -1]
    if num == 1:
        return carried_prev, last
    d = jax.lax.axis_index(axis)
    left_last = jax.lax.ppermute(last, axis, _perm_right(num))
    prev = jnp.where(d == 0, carried_prev, left_last)
    new_carried = jax.lax.psum(
        jnp.where(d == num - 1, last, jnp.zeros_like(last)), axis)
    return prev, new_carried
