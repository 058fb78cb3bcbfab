"""Configuration for the PMR446 scanner framework.

Mirrors the compile-time constants and runtime flags of the reference C app
(reference: src/sdr_pmr446.c:18-46 constants, include/sdr_pmr446.h:28-40 args,
src/dsd_in.c:22-27), re-expressed as frozen dataclasses.  Block geometry is
static: all chunk sizes are multiples of 2048 input samples so that the
25/128 rational resampler and the 16-way channelizer produce exactly integral
outputs per chunk (2048 in -> 400 resampled -> 25 channel frames), which keeps
every array shape static under jit (the reference instead absorbs fractional
yields in ring buffers, src/sdr_pmr446.c:797-816).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# ----------------------------------------------------------------------------
# Fixed radio constants (reference: src/sdr_pmr446.c:22-34, include/sdr_pmr446.h:13)
# ----------------------------------------------------------------------------

SDR_SAMPLERATE = 1_024_000          # input IQ rate [Hz]
CHANNEL_WIDTH_HZ = 12_500           # PMR446 channel spacing [Hz]
NUM_CHANNELS = 16
AUDIO_SAMPLERATE = CHANNEL_WIDTH_HZ  # 12.5 kHz mono audio
BAND_START_HZ = 446.0e6
SDR_RESAMPLERATE = NUM_CHANNELS * CHANNEL_WIDTH_HZ      # 200 kHz
SDR_FREQUENCY = BAND_START_HZ + (NUM_CHANNELS // 2) * CHANNEL_WIDTH_HZ  # 446.1 MHz

# Exact rational resampling ratio 200000/1024000 = 25/128.
RESAMP_L = 25
RESAMP_M = 128

# NCO band re-centering: -(15/32)*2pi rad/sample at 200 kHz = -93.75 kHz, which
# puts PFB bin 0 exactly on PMR channel 1 (reference: src/sdr_pmr446.c:430-434).
# liquid's nco_crcf_mix_down with a negative frequency multiplies by
# exp(-j*theta[n]) with theta[n] = n*omega, omega < 0 -> equivalently
# multiplies by exp(+j*|omega|*n): an upward shift by +93.75 kHz.
NCO_OFFSET_RAD = -0.5 * (NUM_CHANNELS - 1) / NUM_CHANNELS * 2.0 * math.pi
MIX_OMEGA = -NCO_OFFSET_RAD          # +0.9375*pi rad/sample applied as exp(+j*w*n)

SDR_DEFAULT_GAIN = 42.0
SDR_DEFAULT_AUDIO_GAIN = 4.0
SDR_DEFAULT_SQUELCH_LEVEL = 18.0     # relative squelch [dB]
SQUELCH_HYSTERESIS_DB = 5.0          # detune at squelch-5 (src/sdr_pmr446.c:859)

# CTCSS tone detection (reference: src/sdr_pmr446.c:46,138-141,366-409).
CTCSS_NUM_FREQS = 38
CTCSS_BLOCK_SIZE = 2441              # samples @12.5 kHz per detection block
CTCSS_AVG_POWER_THRESH = 120.0
CTCSS_MAX_AVG_RATIO_THRESH = 10.0
CTCSS_FREQS: Tuple[float, ...] = (
    67.0, 71.9, 74.4, 77.0, 79.7, 82.5, 85.4, 88.5, 91.5, 94.8, 97.4, 100.0,
    103.5, 107.2, 110.9, 114.8, 118.8, 123.0, 127.3, 131.8, 136.5, 141.3,
    146.2, 151.4, 156.7, 162.2, 167.9, 173.8, 179.9, 186.2, 192.8, 203.5,
    210.7, 218.1, 225.7, 233.6, 241.8, 250.3,
)

# Filter-chain spec (lengths mirror the reference tables, src/sdr_pmr446.c:39-44).
HP_AUDIO_FILT_TAPS = 377             # CTCSS-removal highpass
LP_AUDIO_FILT_TAPS = 103             # optional 4.5 kHz audio lowpass
DEEMPH_FIR_TAPS = 101                # FIR de-emphasis variant (APP_FIR_DEEMPH)
CTCSS_DELAY = (HP_AUDIO_FILT_TAPS - 1) // 2   # 188-sample linear-phase delay
DC_BLOCK_ALPHA = 0.0005              # both IQ and audio DC blockers
DEEMPH_TAU = 50e-6                   # de-emphasis time constant [s]
PFB_SEMILENGTH = 13                  # kaiser prototype semi-length m (filter len 2*16*13)
PFB_ATT_DB = 80.0
RESAMP_ATT_DB = 60.0

FM_KF = 0.5                          # freqdem modulation factor (src/sdr_pmr446.c:440)

MAX_CHANNELS = 64                    # channel-mask width (src/sdr_pmr446.c:18)

# ----------------------------------------------------------------------------
# Block geometry
# ----------------------------------------------------------------------------

# Smallest input granule with integral yields everywhere:
#   2048 in @1.024M -> 400 resampled @200k -> 25 channel frames @12.5k
INPUT_GRANULE = RESAMP_M * NUM_CHANNELS           # 2048

# FSM decision sub-chunk: closest multiple of the granule to the reference's
# 100000-sample (97.66 ms) cadence (src/sdr_pmr446.c:30).
SUBCHUNK_GRANULES = 49
SUBCHUNK_IN = SUBCHUNK_GRANULES * INPUT_GRANULE   # 100352 input samples (98 ms)
SUBCHUNK_RESAMP = SUBCHUNK_IN * RESAMP_L // RESAMP_M   # 19600
SUBCHUNK_AUDIO = SUBCHUNK_RESAMP // NUM_CHANNELS        # 1225 audio samples


def _check_geometry() -> None:
    assert SUBCHUNK_IN % RESAMP_M == 0
    assert SUBCHUNK_RESAMP % NUM_CHANNELS == 0
    assert SUBCHUNK_IN * RESAMP_L % RESAMP_M == 0


_check_geometry()


@dataclasses.dataclass(frozen=True)
class ScannerArgs:
    """Runtime flags of the scanner app (reference: include/sdr_pmr446.h:28-40).

    ``channel_mask`` follows the reference *code* semantics: bit i set means
    channel i+1 is enabled; ``-m`` CLEARS the bits of listed channels
    (src/sdr_pmr446.c:293-295 — note the reference's --help text claims the
    opposite; we mirror the code, not the doc).
    """

    frequency: float = SDR_FREQUENCY
    gain: float = SDR_DEFAULT_GAIN
    audio_gain: float = SDR_DEFAULT_AUDIO_GAIN
    squelch_level: float = SDR_DEFAULT_SQUELCH_LEVEL
    waterfall: int = 0               # ASCII waterfall width (0 = off)
    lowpass: bool = False            # enable 4.5 kHz audio lowpass
    channel_mask: int = (1 << MAX_CHANNELS) - 1
    lock_mode: str = "start"         # "start" | "max"
    fir_deemph: bool = False         # use the FIR de-emphasis variant


@dataclasses.dataclass(frozen=True)
class DsdInArgs:
    """Runtime flags of the dsd_in app (reference: src/dsd_in.c:22-48)."""

    frequency: float = 160.0e6
    gain: float = 25.0


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Geometry of one jitted scanner step.

    One step consumes ``subchunks_per_step`` FSM sub-chunks, i.e.
    ``subchunks_per_step * SUBCHUNK_IN`` input IQ samples.
    """

    subchunks_per_step: int = 10     # ~0.98 s of signal per step

    @property
    def input_len(self) -> int:
        return self.subchunks_per_step * SUBCHUNK_IN

    @property
    def resamp_len(self) -> int:
        return self.subchunks_per_step * SUBCHUNK_RESAMP

    @property
    def audio_len(self) -> int:
        return self.subchunks_per_step * SUBCHUNK_AUDIO


def parse_channel_mask(spec: str) -> int:
    """Parse ``-m``-style channel-mask specs like ``1,2,8-16``.

    Mirrors src/sdr_pmr446.c:263-299: starts from all-ones and clears the bit
    of every listed channel; ranges are inclusive.  Raises ValueError on
    channels outside 1..MAX_CHANNELS.
    """
    mask = (1 << MAX_CHANNELS) - 1
    i, n = 0, len(spec)
    while i < n:
        l = 0
        while i < n and spec[i].isdigit():
            l = l * 10 + int(spec[i])
            i += 1
        if i < n and spec[i] == "-":
            i += 1
            r = 0
            while i < n and spec[i].isdigit():
                r = r * 10 + int(spec[i])
                i += 1
        else:
            r = l
        if not (1 <= l <= MAX_CHANNELS) or not (1 <= r <= MAX_CHANNELS):
            raise ValueError(
                f"channels in mask must be in the range 1-{MAX_CHANNELS}"
            )
        for ch in range(l, r + 1):
            mask &= ~(1 << (ch - 1))
        while i < n and not spec[i].isdigit():
            i += 1
    return mask
