"""Block-streaming FIR filtering (overlap-save) as pure functions.

Block replacement for liquid's firfilt_rrrf/wdelayf streaming objects
(reference: src/sdr_pmr446.c:443-458, 882-901): instead of per-sample state
inside an opaque object, each op is ``(history, block) -> (new_history,
block)`` with the history being the last ``len(taps)-1`` input samples —
the overlap-save carried state of SURVEY.md §2c.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def fir_init(taps_len: int, channels: int | None = None,
             dtype=jnp.float32) -> jax.Array:
    """Zero history for a causal FIR with ``taps_len`` taps."""
    h = taps_len - 1
    shape = (h,) if channels is None else (channels, h)
    return jnp.zeros(shape, dtype=dtype)


def fir_apply(hist: jax.Array, x: jax.Array, taps: jax.Array):
    """Causal FIR: y[n] = sum_m taps[m] * x[n-m], streaming across blocks.

    ``x`` is [..., T] (real or complex); ``hist`` is [..., len(taps)-1] (the
    previous block's tail).  Returns (new_hist, y) with y the same shape as x.
    """
    ntaps = taps.shape[0]
    xe = jnp.concatenate([hist, x], axis=-1)
    y = _correlate_valid(xe, taps[::-1])
    new_hist = jax.lax.slice_in_dim(
        xe, xe.shape[-1] - (ntaps - 1), xe.shape[-1], axis=-1)
    return new_hist, y


def _correlate_valid(xe: jax.Array, kernel: jax.Array) -> jax.Array:
    """'valid' correlation of [..., T+L-1] with [L] -> [..., T].

    Lowered through lax.conv_general_dilated (an XLA convolution).
    Complex inputs are filtered as two real convolutions (kernel is real).
    """
    if jnp.iscomplexobj(xe):
        hr = _correlate_valid(xe.real, kernel)
        hi = _correlate_valid(xe.imag, kernel)
        return jax.lax.complex(hr, hi)
    lead = xe.shape[:-1]
    t_ext = xe.shape[-1]
    lhs = xe.reshape((-1, 1, t_ext))
    rhs = kernel.astype(xe.dtype).reshape((1, 1, -1))
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    t_out = t_ext - kernel.shape[0] + 1
    return out.reshape(lead + (t_out,))


def delay_init(n: int, channels: int | None = None,
               dtype=jnp.float32) -> jax.Array:
    shape = (n,) if channels is None else (channels, n)
    return jnp.zeros(shape, dtype=dtype)


def delay_apply(hist: jax.Array, x: jax.Array):
    """Pure n-sample delay line (wdelayf equivalent, src/sdr_pmr446.c:447).

    Returns (new_hist, y) with y[t] = x[t-n] (zeros / previous block's tail
    for the first n samples).
    """
    n = hist.shape[-1]
    xe = jnp.concatenate([hist, x], axis=-1)
    t = x.shape[-1]
    y = jax.lax.slice_in_dim(xe, 0, t, axis=-1)
    new_hist = jax.lax.slice_in_dim(xe, t, t + n, axis=-1)
    return new_hist, y
