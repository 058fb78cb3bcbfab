"""On-device IQ sample-format decoding (cs16 / cu8 -> f32 planes).

The reference receives CF32 from SoapySDR (src/shared.c:54) because liquid
wants complex float, so every sample crosses the host bus at 8 bytes.  SDR
front-ends natively produce 4-byte cs16 (SC16) or 2-byte cu8 (rtl_sdr /
rtl_tcp wire format); converting on the HOST inflates PCIe/HBM input
traffic 2-4x before the chain ever sees it.  Instead, ship the RAW wire
bytes to the device packed inside float32 transport words and decode to
planes on-device, where the unpack fuses into the chain's first pass.

Decoding is pure integer bit-arithmetic on a uint32 bitcast — no int16/
uint8 bitcasts, so it lowers on every backend without relying on sub-word
bitcast support.

Scale conventions match io/iq.py exactly: cs16 -> /32768.0,
cu8 -> (u - 127.5) * (1/127.5), cs8 -> /128.0, so device decode ==
host read_iq bit-for-bit (test-enforced, including under jit fusion).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

#: formats decodable on device; values = complex samples per f32 word.
#: "cf32w" is the cf32 WIRE layout itself — interleaved f32 (re, im),
#: byte-identical to a complex64 capture — carried as raw f32 words so
#: the device de-interleaves it and the host does no conversion at all.
PACKED_FORMATS = {"cs16": 1, "cu8": 2, "cs8": 2, "cf32w": 0.5}

#: the raw element dtype on the wire for each packed format
WIRE_DTYPE = {"cs16": np.int16, "cu8": np.uint8, "cs8": np.int8,
              "cf32w": np.float32}

#: per-element padding value for short tails: the wire value nearest 0.0
#: after decode (cu8 is biased — zero BYTES would decode to -1-1j)
WIRE_FILL = {"cs16": 0, "cu8": 128, "cs8": 0, "cf32w": 0}


# ---------------------------------------------------------------- host side
def pack_bytes(raw: np.ndarray, fmt: str) -> np.ndarray:
    """View a raw interleaved capture array as f32 transport words.

    cs16:    int16 [2N] (I,Q interleaved) -> f32 [N]   (1 sample / word)
    cu8/cs8: u/int8 [2N] (I,Q interleaved) -> f32 [N/2] (2 samples / word)

    Zero-copy reinterpretation (little-endian, as written by rtl_sdr and
    SoapySDR); trailing elements that don't fill a word are dropped.
    """
    if fmt not in PACKED_FORMATS:
        raise ValueError(f"not a packed format: {fmt!r}")
    raw = np.ascontiguousarray(raw, dtype=WIRE_DTYPE[fmt])
    elems_per_word = 4 // raw.itemsize
    raw = raw[: (raw.shape[0] // elems_per_word) * elems_per_word]
    return raw.view(np.float32)


def pack_iq(iq: np.ndarray, fmt: str) -> np.ndarray:
    """Quantize complex64 IQ to ``fmt`` wire bytes, packed as f32 words.

    Convenience for benchmarks/tests; real captures come in as raw bytes
    and go straight through pack_bytes with no quantization step.
    """
    inter = np.empty(2 * len(iq), dtype=np.float32)
    inter[0::2] = np.real(iq)
    inter[1::2] = np.imag(iq)
    if fmt == "cf32w":
        return inter                 # lossless: cf32w IS the f32 wire
    if fmt == "cs16":
        raw = np.clip(inter * 32768.0, -32768, 32767).astype(np.int16)
    elif fmt == "cu8":
        raw = np.clip(inter * 127.5 + 127.5, 0, 255).astype(np.uint8)
    elif fmt == "cs8":
        raw = np.clip(inter * 128.0, -128, 127).astype(np.int8)
    else:
        raise ValueError(f"not a packed format: {fmt!r}")
    return pack_bytes(raw, fmt)


def packed_len(n_samples: int, fmt: str) -> int:
    """f32 transport words needed for ``n_samples`` complex samples."""
    per = PACKED_FORMATS[fmt]
    if per < 1:                      # cf32w: 2 words per complex sample
        return int(round(n_samples / per))
    assert n_samples % per == 0
    return n_samples // per


# -------------------------------------------------------------- device side
def decode_planes(packed: jnp.ndarray, fmt: str):
    """f32 transport words -> (xr, xi) float32 planes.

    Bit-exact vs the host-side io/iq.py converters (test-enforced).
    """
    if fmt == "cf32w":
        # already float on the wire; just de-interleave
        xw = jnp.asarray(packed, jnp.float32).reshape(-1, 2)
        return xw[:, 0], xw[:, 1]
    w = jnp.asarray(packed, jnp.float32).view(jnp.uint32)
    if fmt == "cs16":
        # low halfword = I (first int16 on a little-endian wire), high = Q
        lo = jnp.bitwise_and(w, jnp.uint32(0xFFFF)).astype(jnp.int32)
        hi = jnp.right_shift(w, jnp.uint32(16)).astype(jnp.int32)
        # sign-extend 16 -> 32
        lo = jnp.bitwise_xor(lo, 0x8000) - 0x8000
        hi = jnp.bitwise_xor(hi, 0x8000) - 0x8000
        xr = lo.astype(jnp.float32) * (1.0 / 32768.0)
        xi = hi.astype(jnp.float32) * (1.0 / 32768.0)
        return xr, xi
    if fmt in ("cu8", "cs8"):
        # bytes low->high on the wire: i0, q0, i1, q1
        b = [jnp.bitwise_and(jnp.right_shift(w, jnp.uint32(8 * k)),
                             jnp.uint32(0xFF)).astype(jnp.int32)
             for k in range(4)]
        if fmt == "cs8":
            # sign-extend 8 -> 32
            b = [jnp.bitwise_xor(v, 0x80) - 0x80 for v in b]
        b = [v.astype(jnp.float32) for v in b]
        xr = jnp.stack([b[0], b[2]], axis=-1).reshape(-1)
        xi = jnp.stack([b[1], b[3]], axis=-1).reshape(-1)
        if fmt == "cs8":
            return xr * (1.0 / 128.0), xi * (1.0 / 128.0)
        # multiply by the f32 reciprocal: jit-stable (XLA rewrites division
        # by a non-power-of-two constant, shifting results 1 ulp) and
        # bit-exact vs io/iq.py + native/sdrio.cpp, which use the same form
        inv = np.float32(1.0 / 127.5)
        return (xr - 127.5) * inv, (xi - 127.5) * inv
    raise ValueError(f"not a packed format: {fmt!r}")


def decode_complex(packed: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """f32 transport words -> complex64 (for the XLA chain path)."""
    import jax
    xr, xi = decode_planes(packed, fmt)
    return jax.lax.complex(xr, xi)
