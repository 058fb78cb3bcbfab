"""The scanner across the band plan and the audio-filter variants.

Every PMR446 channel is tuned and logged in the reference's format
(src/sdr_pmr446.c:838-862,614-626) through one shared driver, and every
lowpass x FIR-de-emphasis combination is held to the float64 oracle.
"""

import re

import numpy as np
import pytest

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io, synth
from sdr_pmr446_tpu.oracle.chain import ScannerOracle
from sdr_pmr446_tpu.runtime.driver import ScannerDriver
from sdr_pmr446_tpu.scanner.chain import ScannerChain, make_runtime_params

K = 5


@pytest.fixture(scope="module")
def driver():
    """One driver (one compiled chain) shared by all 16 channel cases."""
    return ScannerDriver(C.ScannerArgs(), subchunks_per_step=K)


@pytest.mark.parametrize("channel", range(1, C.NUM_CHANNELS + 1))
def test_scanner_tunes_every_channel(driver, channel):
    code = 1 + (channel * 7) % C.CTCSS_NUM_FREQS
    iq = synth.make_scanner_iq(2 * K * C.SUBCHUNK_IN, channel=channel,
                               ctcss_code=code, seed=channel)
    driver.state = driver.chain.init_state()      # a fresh scan
    driver.subchunk = driver.block_index = 0
    res = driver.run(iq_io.block_stream(iq, driver.block_len))
    assert re.fullmatch(rf"Tuned to channel {channel} \(RSSI: \d+\.\d\ddB\)",
                        res.events[0]), res.events
    f = np.float32(C.CTCSS_FREQS[code - 1])
    assert res.events[1:] == [
        f"Acquired CTCSS code: {code} (frequency: {f:3.2f}Hz)"], res.events
    assert np.all(res.active_trace[1:] == channel - 1)


@pytest.mark.parametrize("fir_deemph", [False, True])
@pytest.mark.parametrize("lowpass", [False, True])
def test_audio_variants_match_oracle(lowpass, fir_deemph):
    args = C.ScannerArgs(lowpass=lowpass, fir_deemph=fir_deemph)
    iq = synth.make_scanner_iq(4 * K * C.SUBCHUNK_IN, channel=5,
                               ctcss_code=12)
    ora = ScannerOracle(args)
    ora.process(iq)
    chain = ScannerChain(C.BlockConfig(K), lowpass=lowpass,
                         fir_deemph=fir_deemph)
    params = make_runtime_params(args)
    st = chain.init_state()
    audio, valid, active = [], [], []
    n = chain.input_len
    for i in range(len(iq) // n):
        st, o = chain.step(st, np.asarray(iq[i * n:(i + 1) * n],
                                          np.complex64), params)
        audio.append(np.asarray(o.audio))
        valid.append(np.asarray(o.audio_valid))
        active.append(np.asarray(o.active_chan))
    np.testing.assert_array_equal(np.concatenate(active), ora.active_trace)
    j = np.concatenate(audio)[np.concatenate(valid)][2:].ravel()
    o = np.stack(ora.audio)[2:].ravel()
    snr = 10 * np.log10(np.mean(o ** 2) / max(np.mean((j - o) ** 2), 1e-30))
    assert snr > 40.0, f"lowpass={lowpass} fir_deemph={fir_deemph}: {snr:.1f}"
