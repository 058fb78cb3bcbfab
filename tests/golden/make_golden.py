"""Generate the C-chain golden fixture (VERDICT r4 #2 / BASELINE accuracy).

Exports the repo's regenerated-from-spec taps, synthesizes a deterministic
PMR446 capture, runs the liquid-dsp harness (tests/golden/harness.c) over
it, and packs (audio, events, capture params) into golden_scanner.npz —
the fixture tests/test_golden.py differentials the JAX chain against.

Needs liquid-dsp + the built harness; on the zero-egress dev hosts that
is impossible, so this runs in
CI (.github/workflows/golden.yml) and the resulting npz is committed.

    python tests/golden/make_golden.py [--out tests/golden]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from sdr_pmr446_tpu import config as C            # noqa: E402
from sdr_pmr446_tpu.io import synth               # noqa: E402
from sdr_pmr446_tpu.taps import design as D       # noqa: E402

CHANNEL = 5
CTCSS_CODE = 12
SECONDS = 3.0
SEED = 20260820


def export_taps(outdir: str) -> None:
    D.ctcss_hp_taps().astype(np.float32).tofile(
        os.path.join(outdir, "hp_audio.f32"))
    b, a = D.deemph_iir_coeffs()
    np.asarray([b[0], b[1], a[0], a[1]], np.float32).tofile(
        os.path.join(outdir, "deemph_iir.f32"))
    np.asarray(C.CTCSS_FREQS, np.float32).tofile(
        os.path.join(outdir, "ctcss_freqs.f32"))


def make_capture(outdir: str) -> str:
    n = int(SECONDS * C.SDR_SAMPLERATE)
    n -= n % C.SUBCHUNK_IN
    iq = 0.7 * synth.make_scanner_iq(n, channel=CHANNEL,
                                     ctcss_code=CTCSS_CODE, seed=SEED)
    path = os.path.join(outdir, "golden_capture.cf32")
    iq.astype(np.complex64).tofile(path)
    return path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.dirname(
        os.path.abspath(__file__)))
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    harness = os.path.join(here, "harness")
    if not os.path.exists(harness):
        print("harness not built (make -C tests/golden); liquid-dsp is "
              "unavailable on zero-egress hosts — run in CI", file=sys.stderr)
        return 3
    export_taps(args.out)
    cap = make_capture(args.out)
    audio_f = os.path.join(args.out, "golden_audio.f32")
    events_f = os.path.join(args.out, "golden_events.log")
    subprocess.run([harness, cap, args.out, audio_f, events_f], check=True)
    audio = np.fromfile(audio_f, np.float32)
    events = open(events_f).read()
    np.savez(os.path.join(args.out, "golden_scanner.npz"),
             audio=audio, events=np.array(events),
             channel=CHANNEL, ctcss_code=CTCSS_CODE,
             seconds=SECONDS, seed=SEED)
    print(f"golden: {audio.shape[0]} audio samples, "
          f"{len(events.splitlines())} events")
    return 0


if __name__ == "__main__":
    sys.exit(main())
