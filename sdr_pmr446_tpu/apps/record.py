"""record — capture scanner audio into timestamped WAV files.

Functional parity with scripts/record.py in the reference, which records the
app's live PulseAudio output to a timestamped WAV and drops all-zero chunks.
Here the scanner is file-driven, so recording is exact: each contiguous
tuned segment (tune → detune) becomes its own timestamped WAV — the
zero-dropping behavior falls out structurally because audio only exists
while tuned.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import sys


from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.io import wav
from sdr_pmr446_tpu.runtime.driver import ScannerDriver


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(
        prog="record", description="record tuned segments to WAV files")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--input-format", type=str, default=None)
    p.add_argument("--outdir", type=str, default=".")
    p.add_argument("-s", "--squelch", type=float,
                   default=C.SDR_DEFAULT_SQUELCH_LEVEL)
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one device dispatch (lax.scan)")
    ns = p.parse_args(argv)
    from sdr_pmr446_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    iq = iq_io.read_iq(ns.input, ns.input_format)
    args = C.ScannerArgs(squelch_level=ns.squelch)
    drv = ScannerDriver(args, subchunks_per_step=ns.subchunks_per_step,
                        steps_per_dispatch=ns.steps_per_dispatch)
    res = drv.run(iq_io.block_stream(iq, drv.block_len))

    if len(res.audio) == 0:
        logging.info("no tuned segments")
        return 0

    # split the audio stream into contiguous tuned segments
    subs = res.audio_subchunks
    ns_audio = C.SUBCHUNK_AUDIO
    seg_starts = [0]
    for i in range(1, len(subs)):
        if subs[i] != subs[i - 1] + 1:
            seg_starts.append(i)
    seg_starts.append(len(subs))

    os.makedirs(ns.outdir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%d_%m_%Y_%H_%M_%S")
    written = []
    for k in range(len(seg_starts) - 1):
        a, b = seg_starts[k], seg_starts[k + 1]
        seg = res.audio[a * ns_audio: b * ns_audio]
        path = os.path.join(ns.outdir, f"pmr446_{stamp}_{k:03d}.wav")
        wav.write_wav(path, seg, C.AUDIO_SAMPLERATE)
        written.append(path)
        logging.info("wrote %s (%.2f s, sub-chunks %d..%d)", path,
                     len(seg) / C.AUDIO_SAMPLERATE, subs[a], subs[b - 1])
    print("\n".join(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())
