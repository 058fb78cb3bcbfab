"""Threaded streaming pipeline: capture file -> ring buffer -> block steps.

The production data-loader shape of the framework: a reader thread converts
raw IQ (via the native engine when built — sdrio's converters hold no GIL in
the hot loop) into the SPSC ring while the main thread assembles fixed-size
blocks and drives the jitted step.  This is the block-streaming equivalent of the
reference's SoapySDR-read -> cbuffercf -> process loop
(src/sdr_pmr446.c:788-816), with the ring absorbing reader/compute jitter
exactly as the reference's ring absorbs resampler-yield jitter.
"""

from __future__ import annotations

import threading
from typing import Iterator

import numpy as np

from sdr_pmr446_tpu.io import native


class StreamingSource:
    """Background-threaded block source over an IQ capture file (or any
    reader with the CaptureReader read_block/close interface — e.g. the
    rtl_tcp network client, io/rtl_tcp.py)."""

    def __init__(self, path: str, block_len: int, fmt: str = "cf32",
                 ring_blocks: int = 4, read_chunk: int = 1 << 16):
        self._init_with_reader(native.CaptureReader(path, fmt), block_len,
                               ring_blocks=ring_blocks,
                               read_chunk=read_chunk)

    def _init_with_reader(self, reader, block_len: int,
                          ring_blocks: int = 4, read_chunk: int = 1 << 16):
        self.block_len = block_len
        self.read_chunk = read_chunk
        self.reader = reader
        # ring holds interleaved I/Q floats
        self.ring = native.RingBuffer(2 * block_len * ring_blocks)
        self._eof = threading.Event()
        self._stop = threading.Event()
        self._error = None
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._started = False

    def _pump(self):
        try:
            self._pump_inner()
        except BaseException as e:           # propagate to the consumer
            self._error = e
        finally:
            # ALWAYS signal the consumer — also on close()-requested stop,
            # which previously left blocks() spinning on a never-set event
            self._eof.set()

    def _pump_inner(self):
        while not self._stop.is_set():
            block, got = self.reader.read_block(self.read_chunk)
            if got == 0:
                return
            # contiguous complex64 viewed as f32 IS the interleaved I/Q
            # layout the ring holds — zero-copy, no re-interleave pass
            inter = np.ascontiguousarray(
                block[:got], np.complex64).view(np.float32)
            written = 0
            while written < inter.size and not self._stop.is_set():
                w = self.ring.write(inter[written:])
                written += w
                if w == 0:
                    # ring full: wait for the consumer
                    self._stop.wait(0.001)
            if got < self.read_chunk:
                return

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield complex64 blocks of block_len (zero-padded final block)."""
        if not self._started:
            self._thread.start()
            self._started = True
        need = 2 * self.block_len

        def to_c64(raw):
            # interleaved f32 -> complex64 reinterpretation (zero-copy)
            return np.ascontiguousarray(raw, np.float32).view(np.complex64)

        while True:
            if self.ring.size() >= need:
                yield to_c64(self.ring.read(need))
            elif self._eof.is_set():
                if self._error is not None:
                    raise RuntimeError("reader thread failed") from self._error
                # the pump may have written several blocks' worth between
                # our size() check and the eof flag: drain FULL blocks
                # first, then the zero-padded tail
                while self.ring.size() >= need:
                    yield to_c64(self.ring.read(need))
                if self.ring.size() == 0:
                    return
                yield to_c64(self.ring.read(need))  # zero-fills shortfall
                return
            else:
                self._eof.wait(0.001)

    def close(self):
        self._stop.set()
        if self._started:
            self._thread.join(timeout=1.0)
        self.reader.close()
