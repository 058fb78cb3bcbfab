"""First-order IIR sections as parallel block ops.

The reference chain has three one-pole recurrences (IQ DC blocker, audio DC
blocker, de-emphasis; src/sdr_pmr446.c:422,450,460-465).  Recurrences are the
one thing accelerators don't do per-sample; here they are computed EXACTLY (same
arithmetic fixed point as the sequential form, up to fp rounding) with a tiled
two-level scan:

  y[n] = p*y[n-1] + z[n]
  1. reshape z into [C, L] chunks; run the recurrence along L for all C chunks
     in parallel (a lax.scan of width-C vector steps);
  2. propagate the C chunk carries with a tiny length-C scan (factor p^L);
  3. add carry_in[c] * p^(j+1) to chunk c — one fused elementwise pass.

Total ~2 passes over the data instead of T sequential steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pow_schedule(p, length: int, dtype):
    # p^(1..L) as a constant vector
    j = jnp.arange(1, length + 1, dtype=jnp.float32)
    if jnp.iscomplexobj(jnp.zeros((), dtype)):
        return (p ** j).astype(dtype)
    return (jnp.asarray(p, jnp.float32) ** j).astype(dtype)


def first_order_scan(z: jax.Array, p: float, y0: jax.Array,
                     chunk: int = 128) -> jax.Array:
    """Solve y[n] = p*y[n-1] + z[n] for n=0..T-1 with y[-1] = y0.

    z: [..., T]; y0: [...] (matching leading shape).  Returns y [..., T].
    Exact (associative reformulation of the recurrence, no truncation).
    """
    lead = z.shape[:-1]
    t = z.shape[-1]
    zf = z.reshape((-1, t))
    b = zf.shape[0]
    y0f = jnp.asarray(y0, zf.dtype).reshape((b,))

    length = min(chunk, t)
    if t % length != 0:
        # fall back to a plain scan layout with padding on the right
        pad = (-t) % length
        zf = jnp.pad(zf, ((0, 0), (0, pad)))
        t_pad = t + pad
    else:
        pad = 0
        t_pad = t
    c = t_pad // length

    zc = zf.reshape((b, c, length))
    p_arr = jnp.asarray(p, zf.dtype)

    # 1) local scans along L, vectorized over (b, c)
    def body(carry, col):
        y = p_arr * carry + col
        return y, y

    _, ylocal = jax.lax.scan(body, jnp.zeros((b, c), zf.dtype),
                             jnp.moveaxis(zc, -1, 0))
    ylocal = jnp.moveaxis(ylocal, 0, -1)          # [b, c, L]

    # 2) chunk-carry propagation: Y_c = p^L * Y_{c-1} + y_end_local[c-1],
    # Y_0 = y0 (=y[-1]); Y_c is the carry INTO chunk c.  Solved with an
    # associative scan over the (small) chunk axis: the affine maps
    # (a, b): y -> a*y + b compose associatively.
    y_end = ylocal[..., -1]                        # [b, c]
    pl = p_arr ** length
    a_seq = jnp.broadcast_to(pl, y_end.shape)
    b_seq = y_end

    def combine(lhs, rhs):
        a1, b1 = lhs
        a2, b2 = rhs
        return a1 * a2, b1 * a2 + b2

    a_cum, b_cum = jax.lax.associative_scan(combine, (a_seq, b_seq), axis=-1)
    # carry into chunk c (c>=1) = a_cum[c-1]*y0 + b_cum[c-1]; chunk 0 gets y0.
    carry_end = a_cum * y0f[..., None] + b_cum     # Y_{c+1} values
    carry_in = jnp.concatenate(
        [y0f[..., None], carry_end[..., :-1]], axis=-1)  # [b, c]

    # 3) correction: y[c, j] = ylocal[c, j] + carry_in[c] * p^(j+1)
    pj = _pow_schedule(p_arr, length, zf.dtype)    # [L]
    y = ylocal + carry_in[..., None] * pj
    y = y.reshape((b, t_pad))
    if pad:
        y = y[:, :t]
    return y.reshape(lead + (t,))


def biquad1_init(channels: int | None = None, dtype=jnp.float32):
    """(x_prev, y_prev) carried state of a 1st-order b/a section."""
    shape = () if channels is None else (channels,)
    return (jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def biquad1_apply(state, x: jax.Array, b0: float, b1: float, a1: float,
                  chunk: int = 128):
    """First-order section y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1].

    state = (x_prev, y_prev) each [...]; x is [..., T].
    Returns (new_state, y).  Used for the DC blockers
    (b=[g,-g], a1=-(1-alpha)) — exact streaming across blocks.
    """
    x_prev, y_prev = state
    x1 = jnp.concatenate([x_prev[..., None], x[..., :-1]], axis=-1)
    z = b0 * x + b1 * x1
    y = first_order_scan(z, -a1, y_prev, chunk=chunk)
    return (x[..., -1], y[..., -1]), y


def dc_blocker_apply(state, x: jax.Array, alpha: float = 0.0005,
                     chunk: int = 128):
    """One-pole DC blocker (liquid iirfilt_*_create_dc_blocker equivalent)."""
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    return biquad1_apply(state, x, g, -g, -p, chunk=chunk)
