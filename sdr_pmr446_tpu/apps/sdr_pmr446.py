"""sdr_pmr446 CLI — PMR446 band scanner/receiver (file/synthetic driven).

Mirrors the reference app's flags (src/sdr_pmr446.c:161-328): -g/--gain,
-s/--squelch, -w/--waterfall, -l/--lowpass, -m/--mask, -a/--audio-gain,
-b/--audio-api (accepted for CLI parity; file output replaces live audio),
-p/--lock-mode; plus file-driven and rtl_tcp source options replacing the
SoapySDR hardware source (accelerator hosts rarely have a USB SDR attached;
SURVEY.md §2b).
"""

from __future__ import annotations

import argparse
import logging
import sys

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.io import synth, wav
from sdr_pmr446_tpu.runtime.driver import ScannerDriver
from sdr_pmr446_tpu.ui import waterfall as wf_ui


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdr_pmr446",
        description="sdr_pmr446 -- a PMR446 band scanner/receiver")
    p.add_argument("-g", "--gain", type=float, default=C.SDR_DEFAULT_GAIN,
                   help="SDR receiver gain in dB (unused for file sources; "
                        f"default: {C.SDR_DEFAULT_GAIN})")
    p.add_argument("-s", "--squelch", type=float,
                   default=C.SDR_DEFAULT_SQUELCH_LEVEL,
                   help="relative squelch level in dB "
                        f"(default: {C.SDR_DEFAULT_SQUELCH_LEVEL})")
    p.add_argument("-w", "--waterfall", type=int, default=0,
                   help="print an ASCII waterfall of this width")
    p.add_argument("-l", "--lowpass", action="store_true",
                   help="turn on 4.5kHz lowpass audio filter")
    p.add_argument("-m", "--mask", type=str, default="",
                   help="channel mask e.g. 1,2,8-16 (listed channels are "
                        "disabled — matches the reference code's semantics)")
    p.add_argument("-a", "--audio-gain", type=float,
                   default=C.SDR_DEFAULT_AUDIO_GAIN,
                   help=f"audio gain (default: {C.SDR_DEFAULT_AUDIO_GAIN})")
    p.add_argument("-b", "--audio-api", type=str, default="unspecified",
                   help="audio API: alsa | pulse | wav | dummy (validated "
                        "against this host's available sinks, like the "
                        "reference's RtAudio API check)")
    p.add_argument("-p", "--lock-mode", choices=["start", "max"],
                   default="start", help="channel lock mode")
    p.add_argument("--input", type=str, default=None,
                   help="IQ capture file (cf32/cs16/cu8; 1.024 Msps at "
                        "446.1 MHz) or rtl_tcp://host[:port] for a live "
                        "network SDR; default: synthetic demo signal")
    p.add_argument("--input-format", type=str, default=None,
                   choices=list("cf32 fc32 cs16 sc16 cs8 cu8 rtlsdr".split()))
    p.add_argument("--device-decode", action="store_true",
                   help="ship the capture's RAW wire bytes to the device "
                        "(packed in f32 words) and decode there: cs16/cu8/"
                        "cs8 cut host->device traffic 2-4x, and cf32 "
                        "captures go as cf32w (byte-identical interleaved "
                        "f32, zero host conversion)")
    p.add_argument("--output", type=str, default="audio.wav",
                   help="output WAV for the demodulated audio, or 'live' to "
                        "stream through the host audio sink (-b)")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="synthetic source duration")
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one device dispatch via lax.scan "
                        "(amortizes per-dispatch overhead in streaming runs; "
                        "decisions identical to 1, audio to f32 rounding)")
    p.add_argument("--fir-deemph", action="store_true",
                   help="use the FIR de-emphasis variant (APP_FIR_DEEMPH)")
    p.add_argument("--faithful", action="store_true",
                   help="bit-faithful gated audio path (validation mode, "
                        "exact reference transition semantics, slower)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file: periodically persist "
                        "(block index, carried state) for failure recovery")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="blocks between checkpoints (with --checkpoint)")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"],
                   default="npz",
                   help="npz single file, or orbax directory (the JAX-"
                        "ecosystem standard, sharded-array-aware)")
    p.add_argument("--resume", action="store_true",
                   help="restore --checkpoint and continue mid-capture")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(name)s] %(message)s",
                        stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    try:
        mask = (C.parse_channel_mask(ns.mask) if ns.mask
                else (1 << C.MAX_CHANNELS) - 1)
    except ValueError as e:
        logging.error("%s", e)                  # argp_usage-style clean exit
        return 1
    if mask == 0:
        logging.error("No channels enabled in channel mask !")
        return 1
    if ns.waterfall > 0:
        from sdr_pmr446_tpu.ops import spectrogram
        try:
            spectrogram.validate_width(ns.waterfall)
        except ValueError as e:
            logging.error("%s", e)
            return 1
    # -b validation against compiled + available APIs (the reference checks
    # the name against RtAudio's compiled API enum, src/sdr_pmr446.c:234-257)
    from sdr_pmr446_tpu.io import audio as audio_io
    avail_apis = audio_io.list_apis()
    if ns.audio_api not in audio_io.COMPILED_APIS:
        logging.error("Audio API '%s' not recognized (compiled APIs: %s)",
                      ns.audio_api,
                      ", ".join(audio_io.COMPILED_APIS[1:]))
        return 1
    if ns.audio_api != "unspecified" and ns.audio_api not in avail_apis:
        logging.error("Audio API '%s' not available on this host "
                      "(available: %s)", ns.audio_api,
                      ", ".join(avail_apis))
        return 1
    live_sink = None
    if ns.output == "live":
        if ns.audio_api in ("wav", "dummy"):
            logging.error("--output live needs a live API (-b alsa|pulse|"
                          "unspecified), not '%s'", ns.audio_api)
            return 1
        if not audio_io.available(ns.audio_api):
            logging.error("no live audio backend available (have: %s)",
                          ", ".join(avail_apis))
            return 1
        live_sink = audio_io.AudioSink(C.AUDIO_SAMPLERATE, api=ns.audio_api)
    args = C.ScannerArgs(
        gain=ns.gain, audio_gain=ns.audio_gain, squelch_level=ns.squelch,
        waterfall=ns.waterfall, lowpass=ns.lowpass, channel_mask=mask,
        lock_mode=ns.lock_mode, fir_deemph=ns.fir_deemph)
    log = logging.getLogger("sdr_pmr446")
    log.info("gain: %5.2f dB, audio_gain: %5.2f, relative squelch level: "
             "%5.2f dB, waterfall: %d", args.gain, args.audio_gain,
             args.squelch_level, args.waterfall)
    log.info("audio lowpass: %s, channel mask: 0x%04X",
             "enabled" if args.lowpass else "disabled", args.channel_mask)
    log.info("audio sinks available: %s (using: %s)", ", ".join(avail_apis),
             ns.audio_api if ns.output == "live" else "wav file")
    # the reference prints its resampler design at init
    # (msresamp_crcf_print, src/sdr_pmr446.c:428)
    from sdr_pmr446_tpu.taps.design import resampler_print
    log.info("%s", resampler_print())

    packed_fmt = None
    if ns.device_decode:
        from sdr_pmr446_tpu.ops import decode
        fmt = ns.input_format or (iq_io.detect_format(ns.input)
                                  if ns.input else "cf32")
        packed_fmt = {"sc16": "cs16", "rtlsdr": "cu8", "cf32": "cf32w",
                      "fc32": "cf32w"}.get(fmt, fmt)
        if not ns.input or ns.input.startswith("rtl_tcp://"):
            logging.error("--device-decode needs a capture FILE "
                          "(synthetic/rtl_tcp inputs have no wire bytes "
                          "to ship)")
            return 1
        if ns.faithful:
            logging.error("--device-decode is not available with "
                          "--faithful (the validation chain takes "
                          "complex64 input)")
            return 1
        if packed_fmt not in decode.PACKED_FORMATS:
            logging.error("--device-decode needs a cf32/%s capture file "
                          "(got format %r)",
                          "/".join(sorted(decode.PACKED_FORMATS)), fmt)
            return 1

    live_source = None
    if ns.input and ns.input.startswith("rtl_tcp://"):
        if ns.faithful:
            logging.error("--faithful is offline-only (file/synthetic "
                          "input), not usable with rtl_tcp")
            return 1
        iq = None
    elif packed_fmt:
        # raw wire bytes -> f32 transport words; decode happens ON DEVICE
        from sdr_pmr446_tpu.ops import decode
        import numpy as np
        dtype = decode.WIRE_DTYPE[packed_fmt]
        raw = np.fromfile(ns.input, dtype=dtype)
        raw = raw[: (len(raw) // 2) * 2]
        n_samp = len(raw) // 2
        log.info("read %d IQ samples (%.2f s) from %s (device decode: %s)",
                 n_samp, n_samp / C.SDR_SAMPLERATE, ns.input, packed_fmt)
        # pad the raw bytes to whole blocks with the format's near-zero
        # value (cu8 zeros would decode to -1-1j, not silence)
        blk_elems = 2 * ns.subchunks_per_step * C.SUBCHUNK_IN
        if len(raw) % blk_elems:
            pad = blk_elems - len(raw) % blk_elems
            raw = np.concatenate(
                [raw, np.full(pad, decode.WIRE_FILL[packed_fmt], dtype)])
        iq = decode.pack_bytes(raw, packed_fmt)
    elif ns.input:
        iq = iq_io.read_iq(ns.input, ns.input_format)
        log.info("read %d IQ samples (%.2f s) from %s", len(iq),
                 len(iq) / C.SDR_SAMPLERATE, ns.input)
    else:
        n = int(ns.seconds * C.SDR_SAMPLERATE)
        n -= n % (ns.subchunks_per_step * C.SUBCHUNK_IN)
        iq = synth.make_scanner_iq(n, channel=5, ctcss_code=12)
        log.info("using synthetic NBFM demo signal on channel 5, CTCSS 12")

    if ns.faithful:
        from sdr_pmr446_tpu.scanner.faithful import FaithfulScannerChain
        from sdr_pmr446_tpu.scanner.chain import make_runtime_params
        from sdr_pmr446_tpu.runtime.transfer import fetch
        import numpy as np
        import jax.numpy as jnp
        chain = FaithfulScannerChain(subchunks_per_step=ns.subchunks_per_step,
                                     lowpass=args.lowpass)
        params = make_runtime_params(args)
        st = chain.init_state()
        audio = []
        n_streamed = 0
        for i in range(len(iq) // chain.input_len):
            st, o = chain.step(st, jnp.asarray(
                iq[i * chain.input_len:(i + 1) * chain.input_len],
                jnp.complex64), params)
            host = fetch({"a": o.audio, "v": o.audio_valid})
            chunk = host["a"][host["v"]].ravel()
            if live_sink is not None:
                live_sink.write(chunk)
                n_streamed += len(chunk)
            else:
                audio.append(chunk)
        if live_sink is not None:
            live_sink.close()
            log.info("streamed %d audio samples (faithful mode) live",
                     n_streamed)
        else:
            out_audio = (np.concatenate(audio) if audio
                         else np.zeros(0, np.float32))
            wav.write_wav(ns.output, out_audio, C.AUDIO_SAMPLERATE)
            log.info("wrote %d audio samples (faithful mode) to %s",
                     len(out_audio), ns.output)
        log.info("Exiting")
        return 0

    driver = ScannerDriver(args, subchunks_per_step=ns.subchunks_per_step,
                           checkpoint_path=ns.checkpoint,
                           checkpoint_every=ns.checkpoint_every,
                           input_format=packed_fmt or "cf32",
                           steps_per_dispatch=ns.steps_per_dispatch,
                           checkpoint_backend=ns.checkpoint_backend)
    if ns.resume:
        if not ns.checkpoint:
            logging.error("--resume needs --checkpoint")
            return 1
        try:
            driver.restore()
        except Exception as e:          # missing/truncated checkpoint file
            logging.error("cannot restore checkpoint '%s': %s",
                          ns.checkpoint, e)
            return 1

    def on_subchunk(sub, o):
        if live_sink is not None and o["audio_valid"]:
            live_sink.write(o["audio"])
        if args.waterfall > 0:
            print(wf_ui.render_waterfall_line(o["waterfall"],
                                              float(o["rel_rssi"])))
            footer = wf_ui.render_footer(
                args.waterfall, args.channel_mask, int(o["active_chan"]),
                bool(o["ct_detected"]), int(o["ct_max_idx"]) + 1,
                float(o["ct_freq"]))
            print(footer, end="\r")
            sys.stdout.flush()

    if args.waterfall > 0 or live_sink is not None:
        driver.on_subchunk = on_subchunk

    if iq is None:                      # live rtl_tcp network SDR
        from sdr_pmr446_tpu.io.rtl_tcp import RtlTcpSource
        n_blocks = max(1, int(ns.seconds * C.SDR_SAMPLERATE)
                       // driver.block_len)
        live_source = RtlTcpSource(
            ns.input, driver.block_len, gain_db=ns.gain,
            max_samples=n_blocks * driver.block_len)
        log.info("streaming live from %s (tuner: %s, %.1f MHz, %.0f s)",
                 ns.input, live_source.client.tuner_name,
                 C.SDR_FREQUENCY / 1e6, ns.seconds)
        blocks = live_source.blocks()
    else:
        blocks = iq_io.block_stream(iq, driver.feed_len)

    # signal parity with the reference (src/sdr_pmr446.c:779-786,190-199):
    # INT/TERM/QUIT set a stop flag and the loop exits at the next block
    # boundary with a final checkpoint flush; USR1 is a no-op wake.  SIGINT
    # additionally keeps Python's KeyboardInterrupt as a mid-step backstop.
    import signal

    def _sig_stop(signum, frame):
        log.info("Signal caught, exiting!")
        driver.request_stop()

    for _name in ("SIGTERM", "SIGQUIT"):
        if hasattr(signal, _name):
            try:
                signal.signal(getattr(signal, _name), _sig_stop)
            except (ValueError, OSError):
                pass                     # not the main thread / unsupported
    if hasattr(signal, "SIGUSR1"):
        try:
            signal.signal(signal.SIGUSR1, lambda *_: None)
        except (ValueError, OSError):
            pass

    interrupted = False
    try:
        result = driver.run(blocks)
    except KeyboardInterrupt:
        # graceful teardown like the reference's SIGINT handler
        # (src/sdr_pmr446.c:190-199,933-940): stop cleanly; the driver's
        # own backstop usually converts this into a partial result first
        log.info("Signal caught, exiting!")
        interrupted = True
        driver.checkpoint_now()
    finally:
        # ALWAYS release the audio subprocess and the rtl_tcp socket —
        # also on reader-thread/driver errors, not just SIGINT/success
        if live_source is not None:
            live_source.close()
        if live_sink is not None:
            live_sink.close()
    if interrupted:
        return 130
    if live_sink is not None:
        log.info("streamed %d audio samples (%.2f s) live", len(result.audio),
                 len(result.audio) / C.AUDIO_SAMPLERATE)
    else:
        wav.write_wav(ns.output, result.audio, C.AUDIO_SAMPLERATE)
        log.info("wrote %d audio samples (%.2f s) to %s", len(result.audio),
                 len(result.audio) / C.AUDIO_SAMPLERATE, ns.output)
    log.info("Exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
