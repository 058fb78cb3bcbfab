"""Sliding windowed periodogram — liquid asgramcf/spgramcf semantics.

The reference's waterfall feeds EVERY resampled band sample into a liquid
``asgramcf`` (src/sdr_pmr446.c:473-477, 910-919), which wraps a ``spgramcf``
streaming periodogram: with FFT size ``w`` (the ``-w`` flag), a length
``w/2`` window slides in hops of ``w/4`` samples; each hop's windowed
segment is zero-padded to ``w``, FFT'd, and its ``|X|^2`` accumulated; the
displayed row is the dB average since the previous row.

This op is the block formulation: all hops of a whole block are computed
as ONE batched DFT over a strided window matrix (built from frame-row
slices — windows overlap 50% so no gather is needed), then averaged per
sub-chunk.  Streaming state is the last ``w/2`` band samples.

Documented deviations from liquid (display-only, test-gated against
oracle.asgram_rows which defines the semantics):
  - window function is Hamming (liquid's spgram default window family is
    implementation-detail; the scale constants -40 dB/2 dB still map the
    same dynamic range);
  - normalization is coherent-gain (a unit complex exponential reads
    ~0 dB), matching the scale the repo's renderer was tuned to.

Any width that is a multiple of 4 (>= 8, hop <= sub-chunk) works — the
reference's README demo is ``-w 120`` (README.md:27) and its asgram ring
absorbs any width (src/sdr_pmr446.c:473-477).  Widths whose hop divides
the sub-chunk take the static fast path (asgram_rows: every sub-chunk
fires the same transform count at the same phases); all others take
asgram_rows_any, which carries the oracle's in-hop sample counter as
state, extracts the phase-shifted windows with one traced roll, and
assigns each transform to its sub-chunk row with a one-hot matmul — the
variable per-row transform counts become a masked average over a static
max-hop matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from sdr_pmr446_tpu import config as C


def validate_width(w: int, subchunk: int = C.SUBCHUNK_RESAMP) -> None:
    if w <= 0:
        return
    if w % 4 != 0 or w < 8:
        raise ValueError(f"waterfall width must be a multiple of 4, >= 8 "
                         f"(got {w})")
    if w // 4 > subchunk:
        raise ValueError(
            f"waterfall width {w}: hop {w // 4} exceeds the sub-chunk "
            f"band length {subchunk} (some rows would have no transform)")


def uses_fast_path(w: int, subchunk: int = C.SUBCHUNK_RESAMP) -> bool:
    """True when the hop divides the sub-chunk: phase is statically zero
    and the carried hop counter never leaves 0."""
    return w > 0 and subchunk % (w // 4) == 0


def hist_len(w: int) -> int:
    return w // 2


@functools.lru_cache(maxsize=None)
def _window(w: int) -> np.ndarray:
    wl = w // 2
    win = np.hamming(wl + 1)[:wl]          # periodic Hamming, length w/2
    return (win / np.sum(win)).astype(np.float32)   # coherent normalization


def asgram_init(w: int) -> jax.Array:
    return jnp.zeros((hist_len(w),), jnp.complex64)


@functools.lru_cache(maxsize=None)
def _dft_win_packed(w: int) -> np.ndarray:
    """[w, 2w] f32 one-shot window+DFT matrix over PACKED hop rows
    [wr | wi]: out columns f < w give Re S_f, columns w+f give Im S_f,
    with the Hamming window folded in.  The hop transforms are tiny
    non-power-of-2 DFTs (w is typically 64-200) over tens of thousands of
    windows per block, so they run as one dense matmul; packing the
    complex combination into one contraction leaves exactly two waterfall
    buffers: the packed windows and the packed spectra.
    """
    wl = w // 2
    win = _window(w).astype(np.float64)
    j = np.arange(wl)[:, None]
    k = np.arange(w)[None, :]
    th = 2.0 * np.pi * j * k / w
    cm = np.cos(th) * win[:, None]
    sm = np.sin(th) * win[:, None]
    k4 = np.zeros((w, 2 * w), np.float64)
    k4[:wl, :w] = cm                      # wr -> Re
    k4[wl:, :w] = sm                      # wi -> Re
    k4[:wl, w:] = -sm                     # wr -> Im
    k4[wl:, w:] = cm                      # wi -> Im
    return k4.astype(np.float32)


def _hop_spectra(xr: jax.Array, xi: jax.Array, w: int, frames: int):
    """Packed hop spectra from band PLANES: windows start at xr[i*delay],
    i < frames, assembled from four shifted frame-row slices (50%
    overlap, no gather) into ONE packed [n, w] matrix.  Returns the
    packed [frames, 2w] spectra ([Re | Im]); callers reduce SQUARES of
    this buffer directly (sum then add the halves), so the per-hop
    periodogram never materializes — the waterfall tap's HBM traffic is
    exactly two buffers: packed windows + packed spectra."""
    delay = w // 4
    need = (frames + 1) * delay
    fr = xr[:need].reshape(frames + 1, delay)
    fi = xi[:need].reshape(frames + 1, delay)
    wcat = jnp.concatenate([fr[:frames], fr[1:],
                            fi[:frames], fi[1:]], axis=-1)   # [n, w]
    # barrier: XLA otherwise may rewrite dot(concat(..)) into a SUM of
    # four dots, materializing every [n, 2w] partial product
    wcat = jax.lax.optimization_barrier(wcat)
    return jnp.matmul(wcat, jnp.asarray(_dft_win_packed(w)),
                      precision=jax.lax.Precision.HIGHEST)   # [n, 2w]


def asgram_rows(hist: jax.Array, band: jax.Array, k: int, w: int,
                subchunk: int = C.SUBCHUNK_RESAMP):
    """hist [w//2] c64, band [k*subchunk] c64 -> (new_hist, rows [k, w] f32).

    Row j is the dB-average periodogram of sub-chunk j's hops (fftshifted,
    DC at center), i.e. exactly what asgramcf_execute prints per chunk.
    """
    br = jnp.real(band).astype(jnp.float32)
    bi = jnp.imag(band).astype(jnp.float32)
    wl = w // 2
    delay = w // 4
    n_seg = subchunk // delay              # transforms per sub-chunk
    n_tot = k * n_seg
    xr = jnp.concatenate([jnp.real(hist).astype(jnp.float32), br])
    xi = jnp.concatenate([jnp.imag(hist).astype(jnp.float32), bi])
    # hop t's window starts at xe[(t+1)*delay]
    sp = _hop_spectra(xr[delay:], xi[delay:], w, n_tot)  # [n_tot, 2w]
    s2 = jax.lax.reduce_window(
        sp ** 2, 0.0, jax.lax.add, window_dimensions=(n_seg, 1),
        window_strides=(n_seg, 1), padding="VALID")      # [k, 2w]
    p_avg = (s2[:, :w] + s2[:, w:]) * (1.0 / n_seg)      # [k, w]
    rows = 10.0 * jnp.log10(jnp.maximum(p_avg, 1e-30)).astype(jnp.float32)
    rows = jnp.fft.fftshift(rows, axes=-1)
    new_hist = jax.lax.complex(xr[xr.shape[-1] - wl:],
                               xi[xi.shape[-1] - wl:])
    return new_hist, rows


def asgram_rows_any(hist: jax.Array, cnt: jax.Array, band: jax.Array,
                    k: int, w: int, subchunk: int = C.SUBCHUNK_RESAMP,
                    cnt_offset: jax.Array | None = None):
    """Arbitrary-width variant: hop w/4 need NOT divide the sub-chunk.

    hist [w//2] c64; cnt i32 scalar — the oracle's in-hop sample counter
    (samples consumed since the last transform fired, in [0, delay));
    band [k*subchunk] c64.  Returns (new_hist, new_cnt, rows [k, w]).

    A transform fires after every ``delay``-th stream sample and belongs
    to the sub-chunk containing that sample (AsgramStream semantics).
    All windows of the step are extracted with ONE traced roll of the
    extended signal (phase u0 = delay - cnt), then the static reshape
    trick; per-row averages use a one-hot fire->row matmul, with
    out-of-step fires falling off the one-hot range.

    ``cnt_offset`` (traced, optional) shifts the counter for time-sharded
    execution: shard r at K_local sub-chunks starts r*K_local*subchunk
    samples into the step, so its local counter is analytic from the
    carried one — no halo needed (parallel/scanner_sharded.py).  The
    returned new_cnt is local to THIS call's k sub-chunks; a sharded
    caller advances the carried counter by the full step outside.
    """
    br = jnp.real(band).astype(jnp.float32)
    bi = jnp.imag(band).astype(jnp.float32)
    wl = w // 2
    delay = w // 4
    ks = k * subchunk
    if cnt_offset is not None:
        cnt = (cnt + cnt_offset) % delay
    xr = jnp.concatenate([jnp.real(hist).astype(jnp.float32), br])
    xi = jnp.concatenate([jnp.imag(hist).astype(jnp.float32), bi])
    n_max = ks // delay + 1
    u0 = delay - cnt                            # first fire at xe[u0+wl-1]
    xr_r = jnp.roll(xr, -u0)
    xi_r = jnp.roll(xi, -u0)
    sp = _hop_spectra(xr_r, xi_r, w, n_max)     # [n_max, 2w]
    # fire i consumes band sample u0 + i*delay (1-based); its row is the
    # sub-chunk containing it; fires past the step (u > ks) one-hot to
    # nothing.  delay <= subchunk (validate_width) => every row >= 1 fire.
    u = u0 + delay * jnp.arange(n_max, dtype=jnp.int32)
    row = (u - 1) // subchunk                   # [n_max]; >= k for non-fires
    a = jax.nn.one_hot(row, k, dtype=jnp.float32)   # [n_max, k]
    hi = jax.lax.Precision.HIGHEST
    m2 = jnp.matmul(a.T, sp ** 2, precision=hi)     # [k, 2w]
    rows_sum = m2[:, :w] + m2[:, w:]
    counts = jnp.maximum(jnp.sum(a, axis=0), 1.0)
    p_avg = rows_sum / counts[:, None]
    rows = 10.0 * jnp.log10(jnp.maximum(p_avg, 1e-30)).astype(jnp.float32)
    rows = jnp.fft.fftshift(rows, axes=-1)
    new_hist = jax.lax.complex(xr[xr.shape[-1] - wl:],
                               xi[xi.shape[-1] - wl:])
    new_cnt = (cnt + ks) % delay
    return new_hist, new_cnt.astype(jnp.int32), rows
