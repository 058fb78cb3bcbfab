"""dsd_in CLI — DSD signal pre-processor (file driven).

Mirrors the reference app (src/dsd_in.c:40-48): -g/--gain, -f/--frequency,
writing 48 kHz s16le mono to stdout (pipe into `dsd -i -` / `play` exactly as
the reference README shows), or to a file with --output.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import jax.numpy as jnp

from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.scanner.dsd_in import DsdInChain


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsd_in", description="dsd_feeder -- DSD signal pre-processor")
    p.add_argument("-g", "--gain", type=float, default=25.0,
                   help="SDR receiver gain in dB (unused for file sources)")
    p.add_argument("-f", "--frequency", type=float, default=160.0e6,
                   help="receive frequency (metadata for file sources)")
    p.add_argument("--input", type=str, required=True,
                   help="IQ capture file at 1.024 Msps, or "
                        "rtl_tcp://host[:port] for a live network SDR "
                        "tuned to -f (like the reference's live Soapy "
                        "source, src/dsd_in.c:151)")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="live (rtl_tcp) capture duration")
    p.add_argument("--input-format", type=str, default=None)
    p.add_argument("--output", type=str, default="-",
                   help="output path for 48 kHz s16le audio ('-' = stdout)")
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one device dispatch via lax.scan "
                        "(amortizes per-dispatch overhead; output within "
                        "1 int16 LSB of 1)")
    p.add_argument("--device-decode", action="store_true",
                   help="ship the capture's raw wire bytes to the device "
                        "and decode there (cs16/cu8/cs8: 2-4x less "
                        "host->device traffic; cf32 goes as cf32w)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    live = ns.input.startswith("rtl_tcp://")
    if live and ns.device_decode:
        logging.error("--device-decode needs a capture file, not a live "
                      "rtl_tcp stream")
        return 1
    packed_fmt = None
    if ns.device_decode:
        from sdr_pmr446_tpu.ops import decode
        fmt = ns.input_format or iq_io.detect_format(ns.input)
        packed_fmt = {"sc16": "cs16", "rtlsdr": "cu8", "cf32": "cf32w",
                      "fc32": "cf32w"}.get(fmt, fmt)
        if packed_fmt not in decode.PACKED_FORMATS:
            logging.error("--device-decode needs a %s capture "
                          "(got format %r)",
                          "/".join(decode.PACKED_FORMATS), fmt)
            return 1
    chain = DsdInChain(subchunks_per_step=ns.subchunks_per_step,
                       input_format=packed_fmt or "cf32")
    live_source = None
    if live:
        # live network SDR at the -f frequency (reference init_soapy role,
        # src/dsd_in.c:151,26-27); cu8 -> cf32 through the native engine
        from sdr_pmr446_tpu import config as C
        from sdr_pmr446_tpu.io.rtl_tcp import RtlTcpSource
        n_blocks = max(1, int(ns.seconds * C.SDR_SAMPLERATE)
                       // chain.input_len)
        live_source = RtlTcpSource(
            ns.input, chain.input_len, frequency=ns.frequency,
            gain_db=ns.gain, max_samples=n_blocks * chain.input_len)
        logging.info("streaming live from %s (tuner: %s, %.3f MHz, "
                     "%.0f s)", ns.input, live_source.client.tuner_name,
                     ns.frequency / 1e6, ns.seconds)
        blocks = live_source.blocks()
        feed_dtype = jnp.complex64
    elif packed_fmt:
        from sdr_pmr446_tpu.ops import decode
        dtype = decode.WIRE_DTYPE[packed_fmt]
        raw = np.fromfile(ns.input, dtype=dtype)
        raw = raw[: (len(raw) // 2) * 2]
        blk_elems = 2 * chain.input_len
        if len(raw) % blk_elems:
            pad = blk_elems - len(raw) % blk_elems
            raw = np.concatenate(
                [raw, np.full(pad, decode.WIRE_FILL[packed_fmt], dtype)])
        iq = decode.pack_bytes(raw, packed_fmt)
        feed_dtype = jnp.float32
    else:
        iq = iq_io.read_iq(ns.input, ns.input_format)
        feed_dtype = jnp.complex64
    if not live:
        blocks = iq_io.block_stream(iq, chain.step_arg_len)
    state = chain.init_state()
    out = (sys.stdout.buffer if ns.output == "-"
           else open(ns.output, "wb"))
    n_fuse = max(1, ns.steps_per_dispatch)
    # INT/TERM/QUIT exit the loop at the next block boundary with the
    # output flushed (reference signal set, src/sdr_pmr446.c:779-786 —
    # shared by both apps; dsd_in.c reuses the same handler)
    import signal
    stop = {"flag": False}

    def _sig_stop(signum, frame):
        logging.info("Signal caught, exiting!")
        stop["flag"] = True

    for _name in ("SIGTERM", "SIGQUIT"):
        if hasattr(signal, _name):
            try:
                signal.signal(getattr(signal, _name), _sig_stop)
            except (ValueError, OSError):
                pass
    try:
        group = []
        for blk in blocks:
            if stop["flag"]:
                break
            group.append(jnp.asarray(blk, feed_dtype))
            if len(group) < n_fuse:
                continue
            if len(group) == 1:
                state, o = chain.step(state, group[0])
            else:
                state, o = chain.multi_step(state, jnp.stack(group))
            group = []
            out.write(np.asarray(o.pcm).astype("<i2").tobytes())
            out.flush()
        for blk in (() if stop["flag"] else group):   # tail blocks, singly
            state, o = chain.step(state, blk)
            out.write(np.asarray(o.pcm).astype("<i2").tobytes())
            out.flush()
    except BrokenPipeError:
        # the downstream consumer (dsd/play, reference README.md:43-46)
        # closed its end: exit gracefully like the reference's ignored
        # SIGPIPE + flag (src/sdr_pmr446.c:190-199)
        logging.info("downstream pipe closed, exiting")
        try:        # keep interpreter shutdown from re-raising EPIPE
            import os as _o
            fd = _o.open(_o.devnull, _o.O_WRONLY)
            _o.dup2(fd, sys.stdout.fileno())
            _o.close(fd)
        except OSError:
            pass
        return 0
    finally:
        if live_source is not None:
            live_source.close()
        if out is not sys.stdout.buffer:
            out.close()
    logging.info("Exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
