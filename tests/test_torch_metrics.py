"""The port's copies of the audio metrics (`covomix_tpu_torch/util/metrics.py`,
`util/pesq_nb.py`) against the JAX package's on the same signals: every
number within METRIC_TOL (both are the same numpy / scipy code)."""

import numpy as np
import pytest

from covomix_tpu.util import metrics as JM
from covomix_tpu.util.pesq_nb import pesq_nb as j_pesq
from covomix_tpu_torch.util import metrics as PM
from covomix_tpu_torch.util.pesq_nb import pesq_nb as p_pesq

METRIC_TOL = 1e-6


def _pair(seconds, sr, snr_db, seed):
    """A speech-like signal (harmonics under a slow envelope) and a noisy copy."""
    rs = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = sum(np.sin(2 * np.pi * f0 * t + rs.rand()) / f0 * 120 for f0 in (110, 220, 330, 550))
    x = 0.1 * x * (0.5 + 0.5 * np.sin(2 * np.pi * 2.5 * t)) ** 2
    noise = rs.randn(len(x)) * np.sqrt(np.mean(x ** 2) / 10 ** (snr_db / 10))
    return x.astype(np.float32), (x + noise).astype(np.float32)


@pytest.mark.parametrize("sr,snr", [(8000, 30), (8000, 5), (16000, 15)])
def test_metrics_equal_jax(sr, snr):
    ref, deg = _pair(2.0, sr, snr, seed=snr)
    for name in ("si_sdr",):
        assert getattr(PM, name)(ref, deg) == pytest.approx(getattr(JM, name)(ref, deg), abs=METRIC_TOL)
    for name in ("stoi", "estoi"):
        assert getattr(PM, name)(ref, deg, sr) == pytest.approx(getattr(JM, name)(ref, deg, sr), abs=METRIC_TOL)
    assert p_pesq(ref, deg, sr) == pytest.approx(j_pesq(ref, deg, sr), abs=METRIC_TOL)
    mel_a = np.random.RandomState(sr).randn(50, 80).astype(np.float32)
    mel_b = mel_a[:48] + 0.1 * np.random.RandomState(snr).randn(48, 80).astype(np.float32)
    assert PM.mcd(mel_a, mel_b) == pytest.approx(JM.mcd(mel_a, mel_b), abs=METRIC_TOL)
    mix = deg + 0.5 * ref[::-1]
    np.testing.assert_allclose(PM.energy_ratios(deg, ref, mix), JM.energy_ratios(deg, ref, mix), atol=METRIC_TOL)


def test_edge_cases_equal_jax():
    """Signals too short for STOI's segments give nan on both sides; PESQ of a
    signal with itself is 4.5; too short for PESQ raises on both sides."""
    ref, deg = _pair(0.2, 8000, 20, seed=3)
    assert np.isnan(PM.stoi(ref, deg, 8000)) and np.isnan(JM.stoi(ref, deg, 8000))
    x, _ = _pair(1.0, 8000, 20, seed=4)
    assert p_pesq(x, x) == pytest.approx(4.5, abs=METRIC_TOL) == j_pesq(x, x)
    for fn in (p_pesq, j_pesq):
        with pytest.raises(ValueError, match="too short"):
            fn(x[:100], x[:100])
