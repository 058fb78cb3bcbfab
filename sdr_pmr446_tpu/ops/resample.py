"""Polyphase rational resampler as a strided convolution.

An equivalent of liquid's msresamp_crcf/msresamp_rrrf
(reference: src/sdr_pmr446.c:425-428, src/dsd_in.c:100-104): instead of a
multi-stage streaming object, the exact L/M polyphase decimation

    y[j] = sum_{i=0}^{P-1} x[q - i] * h[i*L + r],
    q = floor(j*M/L) + o_f,  r = (j*M) mod L

is laid out as one strided convolution with an [L, W] kernel matrix over
frames of M input samples (L outputs per frame), one XLA convolution.
Blocks must be a multiple of M samples; the carried state is
the last P-1 input samples (overlap-save).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def _kernel_matrix(taps_key, L: int, M: int) -> np.ndarray:
    """Build the [L, W] per-phase kernel matrix from prototype taps.

    For output j = L*f + p of frame f, the input window (in the
    history-extended block, window start at M*f) has length
    W = P + max_offset + 1, where P = len(taps)/L and
    offset o_p = floor(p*M/L).  K[p, w] = h[(o_p + P - 1 - w)*L + r_p]
    for w in [o_p, o_p + P - 1], else 0, with r_p = (p*M) mod L.
    """
    h = np.asarray(taps_key, dtype=np.float64)
    assert h.shape[0] % L == 0
    P = h.shape[0] // L
    offsets = [(p * M) // L for p in range(L)]
    max_off = max(offsets)
    W = P + max_off
    K = np.zeros((L, W), dtype=np.float64)
    for p in range(L):
        r = (p * M) % L
        o = offsets[p]
        for w in range(o, o + P):
            i = o + P - 1 - w
            K[p, w] = h[i * L + r]
    return K


class PolyResampler:
    """Rational L/M resampler; call apply(hist, x) with len(x) % M == 0."""

    def __init__(self, taps: np.ndarray, L: int, M: int):
        self.L = L
        self.M = M
        taps = np.asarray(taps, dtype=np.float64)
        self.P = taps.shape[0] // L
        # keep as NumPy: trace-time constants must not be device arrays
        # (avoids a device->host read when jit embeds them into the program)
        self.kernel = _kernel_matrix(tuple(taps.tolist()), L, M).astype(
            np.float32)
        self.W = self.kernel.shape[1]
        self.hist_len = self.P - 1

    def init(self, channels: int | None = None, dtype=jnp.complex64):
        shape = ((self.hist_len,) if channels is None
                 else (channels, self.hist_len))
        return jnp.zeros(shape, dtype=dtype)

    def apply(self, hist: jax.Array, x: jax.Array):
        """x: [..., T] with T % M == 0 -> y: [..., T*L/M]; hist: [..., P-1]."""
        T = x.shape[-1]
        assert T % self.M == 0, (T, self.M)
        F = T // self.M
        xe = jnp.concatenate([hist, x], axis=-1)    # [..., P-1+T]
        y = _strided_conv(xe, self.kernel, stride=self.M, frames=F)
        # y: [..., F, L] -> [..., F*L]
        y = y.reshape(y.shape[:-2] + (F * self.L,))
        new_hist = jax.lax.slice_in_dim(
            xe, xe.shape[-1] - self.hist_len, xe.shape[-1], axis=-1)
        return new_hist, y


def _strided_conv(xe: jax.Array, kernel: jax.Array, stride: int,
                  frames: int) -> jax.Array:
    """[..., T_ext] (x) [L, W] kernel -> [..., frames, L].

    Window for frame f starts at f*stride; xe must satisfy
    T_ext >= (frames-1)*stride + W.
    """
    L, W = kernel.shape
    need = (frames - 1) * stride + W
    t_ext = xe.shape[-1]
    assert t_ext >= need, (t_ext, need)
    if t_ext > need:
        xe = jax.lax.slice_in_dim(xe, 0, need, axis=-1)
    if jnp.iscomplexobj(xe):
        yr = _strided_conv(xe.real, kernel, stride, frames)
        yi = _strided_conv(xe.imag, kernel, stride, frames)
        return jax.lax.complex(yr, yi)
    lead = xe.shape[:-1]
    lhs = xe.reshape((-1, 1, xe.shape[-1]))
    # lax.conv_general_dilated is a cross-correlation (no kernel flip):
    # out[f, p] = sum_w xe[f*stride + w] * K[p, w] — exactly the layout of K.
    rhs = kernel[:, None, :]                        # [L, 1, W]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )                                               # [B, L, frames]
    out = jnp.moveaxis(out, -2, -1)                 # [B, frames, L]
    return out.reshape(lead + (frames, L))
