"""Fused NCO-mixer + 16-channel polyphase filterbank channelizer.

Block replacement for the reference's per-sample nco_crcf mix-down +
firpfbch_crcf analyzer inner loop (src/sdr_pmr446.c:804-825): one strided
complex convolution with a static [416, 16] kernel that folds together

  - the Kaiser prototype lowpass (each channel's branch filter),
  - the 16-point DFT across polyphase branches (the channel split),
  - the -93.75 kHz NCO re-centering mixer.

Channel k of the output is the signal at +k*12.5 kHz (after the mixer shift),
i.e. PMR channel k+1, down-converted to baseband and decimated to 12.5 kHz:

  y[n, k] = e^{-j w_k s_n} * sum_m h[m] e^{j w_k m} x~[s_n - m],
  x~[t] = x[t] e^{j w_mix t},  s_n = 16 n + 15,  w_k = 2 pi k / 16.

Because 16*w_mix = 15*pi = pi (mod 2pi), the mixer contributes only a static
in-frame phase plus a global (-1)^n frame flip, so the kernel is constant and
the only carried mixer state is the frame-count parity (the reference's NCO
phase accumulator has no block equivalent — phase is closed-form, SURVEY.md §2c).

Carried state: last 2*16*m - 16 = 400 resampled samples + frame parity.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C


def make_pfb_kernel(prototype: np.ndarray,
                    num_channels: int = C.NUM_CHANNELS,
                    mix_omega: float = C.MIX_OMEGA) -> np.ndarray:
    """Complex [n_taps, num_channels] fused kernel CK[t, k].

    CK[t, k] = h[n_taps-1-t] * exp(j*(-2*pi*k*t/M + mix_omega*(t - (n_taps-M)))).
    """
    h = np.asarray(prototype, dtype=np.float64)
    n = h.shape[0]
    assert n % num_channels == 0
    hist = n - num_channels                     # 400 for 416/16
    t = np.arange(n)
    k = np.arange(num_channels)
    phase = (-2.0 * np.pi * np.outer(t, k) / num_channels
             + mix_omega * (t - hist)[:, None])
    return h[::-1, None] * np.exp(1j * phase)


class PFBChannelizer:
    def __init__(self, prototype: np.ndarray,
                 num_channels: int = C.NUM_CHANNELS,
                 mix_omega: float = C.MIX_OMEGA):
        self.M = num_channels
        self.n_taps = int(np.asarray(prototype).shape[0])
        self.hist_len = self.n_taps - num_channels
        ck = make_pfb_kernel(prototype, num_channels, mix_omega)
        # Real conv kernel [2*M out-channels, 2 in-channels(re,im), n_taps]:
        # out[2k]   = Re(y_k) = conv(xr, Re CK_k) - conv(xi, Im CK_k)
        # out[2k+1] = Im(y_k) = conv(xr, Im CK_k) + conv(xi, Re CK_k)
        rhs = np.zeros((2 * num_channels, 2, self.n_taps), dtype=np.float32)
        for kk in range(num_channels):
            rhs[2 * kk, 0] = ck[:, kk].real
            rhs[2 * kk, 1] = -ck[:, kk].imag
            rhs[2 * kk + 1, 0] = ck[:, kk].imag
            rhs[2 * kk + 1, 1] = ck[:, kk].real
        self.rhs = rhs  # NumPy: safe as a jit trace constant

    def init(self):
        return (jnp.zeros((self.hist_len,), jnp.complex64),
                jnp.zeros((), jnp.int32))

    def apply(self, state, x: jax.Array):
        """x: [T_r] complex resampled band (T_r % 16 == 0) ->
        chan [16, T_r/16] complex channel-major baseband channels."""
        hist, parity = state
        T = x.shape[-1]
        assert T % self.M == 0
        F = T // self.M
        xe = jnp.concatenate([hist, x], axis=-1)        # [hist+T]
        lhs = jnp.stack([xe.real, xe.imag], axis=0)[None]  # [1, 2, hist+T]
        out = jax.lax.conv_general_dilated(
            lhs, self.rhs, window_strides=(self.M,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )[0]                                            # [2*M, F]
        y = jax.lax.complex(out[0::2], out[1::2])       # [M, F]
        # global (-1)^n frame flip from the mixer
        f_sign = 1.0 - 2.0 * (jnp.arange(F, dtype=jnp.float32) % 2.0)
        p_sign = (1.0 - 2.0 * (parity % 2)).astype(jnp.float32)
        y = y * (f_sign * p_sign)[None, :]
        new_hist = xe[xe.shape[-1] - self.hist_len:]
        new_parity = (parity + F) % 2
        return (new_hist, new_parity), y
