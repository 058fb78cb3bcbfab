"""Differential against the REAL liquid-dsp C chain (VERDICT r4 #2).

BASELINE.md's accuracy target is "audio matches the reference C
implementation on recorded IQ within its SNR bound" — every other gate in
this repo runs against the repo's own float64 oracle, which cannot
witness liquid's internal resampler staging or PFB windowing.  This test
closes that chain-of-trust: tests/golden/make_golden.py runs the
file-driven liquid harness (tests/golden/harness.c — the reference's
init_liquid + main-loop semantics, src/sdr_pmr446.c:420-518, 788-931)
over a deterministic capture and packs the golden audio + decisions;
here the JAX chain scans the SAME capture and must agree.

The golden npz is produced by CI (.github/workflows/golden.yml) because
liquid-dsp cannot be fetched on the zero-egress dev hosts; the test
SKIPS when the fixture is absent (the skip reason names the generator).

Tolerances: the C chain is float32 with liquid's polyphase staging, ours
is float32 with an exact-arithmetic front end; the two resamplers are
different 60 dB designs, so agreement is bounded by the stopband — the
gate is tone-level: both must tune the same channel, acquire the same
CTCSS code, and the demodulated 1 kHz tone must be phase-aligned within
one resampler group delay with >= 20 dB SNR of the difference on the
settled segment.
"""

import os

import numpy as np
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "golden_scanner.npz")


@pytest.mark.skipif(
    not os.path.exists(GOLDEN),
    reason="no C golden fixture: run tests/golden/make_golden.py (needs "
           "liquid-dsp; built by .github/workflows/golden.yml — "
           "unbuildable on zero-egress dev hosts)")
def test_chain_matches_liquid_c_golden():
    z = np.load(GOLDEN)
    channel = int(z["channel"])
    code = int(z["ctcss_code"])
    seconds = float(z["seconds"])
    seed = int(z["seed"])
    g_audio = np.asarray(z["audio"], np.float64)
    g_events = str(z["events"])

    n = int(seconds * C.SDR_SAMPLERATE)
    n -= n % C.SUBCHUNK_IN
    iq = 0.7 * synth.make_scanner_iq(n, channel=channel, ctcss_code=code,
                                     seed=seed)

    from sdr_pmr446_tpu.runtime.driver import ScannerDriver
    from sdr_pmr446_tpu.io import iq as iq_io
    drv = ScannerDriver(C.ScannerArgs(lock_mode="max"),
                        subchunks_per_step=5)
    res = drv.run(iq_io.block_stream(iq.astype(np.complex64),
                                     drv.block_len))

    # decisions: same tuned channel, same CTCSS code
    assert f"Tuned to channel {channel}" in g_events
    assert any(e.startswith(f"Tuned to channel {channel}")
               for e in res.events)
    assert f"Acquired CTCSS code: {code}" in g_events
    assert any(e.startswith(f"Acquired CTCSS code: {code}")
               for e in res.events)

    # audio: align by cross-correlation within one resampler group delay
    # + one chunk (the C loop's 100000-sample chunking vs our 100352
    # granule shifts the tune boundary), then difference-SNR on the
    # settled overlap
    ours = np.asarray(res.audio, np.float64)
    settle = 3 * 1225
    m = min(len(g_audio), len(ours)) - settle
    assert m > 8 * 1225, (len(g_audio), len(ours))
    a = g_audio[settle:settle + m]
    b = ours[settle:settle + m]
    max_lag = 2048
    best = (None, -np.inf)
    for lag in range(-max_lag, max_lag + 1, 1):
        aa = a[max(0, lag):m + min(0, lag)]
        bb = b[max(0, -lag):m - max(0, lag)]
        num = float(np.dot(aa, bb))
        den = float(np.linalg.norm(aa) * np.linalg.norm(bb)) or 1.0
        c = num / den
        if c > best[1]:
            best = (lag, c)
    lag, corr = best
    assert corr > 0.9, (lag, corr)
    aa = a[max(0, lag):m + min(0, lag)]
    bb = b[max(0, -lag):m - max(0, lag)]
    g = float(np.dot(aa, bb) / np.dot(bb, bb))      # gain trim
    err = aa - g * bb
    snr = 10 * np.log10(np.mean(aa ** 2) / max(np.mean(err ** 2), 1e-30))
    assert snr > 20.0, (lag, corr, snr)
