"""Audio evaluation metrics in numpy / scipy: SI-SDR, MCD, STOI / ESTOI and
the SI-SDR / SIR / SAR energy ratios (the port's own copy of
covomix_tpu/util/metrics.py, the numbers of `hifigan_inference
--metrics_csv`).

  * SI-SDR / energy ratios (covomix/util/other.py:14-125, hifi-gan/inference.py:14)
  * STOI / ESTOI from the published definitions (the reference's tables,
    hifi-gan/evaluate_metric.py:44-72, call the pystoi package)
  * MCD over log-mel frames."""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly


def si_sdr(reference: np.ndarray, estimate: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SDR in dB (covomix/util/other.py si_sdr)."""
    reference = reference - reference.mean()
    estimate = estimate - estimate.mean()
    alpha = np.dot(estimate, reference) / (np.dot(reference, reference) + eps)
    target = alpha * reference
    noise = estimate - target
    return float(10 * np.log10((np.sum(target**2) + eps) / (np.sum(noise**2) + eps)))


def mcd(mel_ref: np.ndarray, mel_hyp: np.ndarray) -> float:
    """Mel-cepstral-distortion-style distance in dB over log-mel frames
    [T, n_mels] (the vocoder's mel-fidelity metric). Uses the standard
    10/ln(10)*sqrt(2) scaling on the log-mel L2 distance."""
    n = min(len(mel_ref), len(mel_hyp))
    diff = mel_ref[:n] - mel_hyp[:n]
    const = 10.0 / np.log(10.0) * np.sqrt(2.0)
    return float(const * np.mean(np.sqrt(np.sum(diff**2, axis=1)) / np.sqrt(mel_ref.shape[1])))


def energy_ratios(estimate: np.ndarray, reference: np.ndarray, mixture: np.ndarray):
    """si_sdr / si_sir / si_sar decomposition, exactly the reference math
    (si_sdr_components + energy_ratios, covomix/util/other.py:14-40): NO
    mean-centering, e_noise projects the FULL estimate onto n = mixture -
    reference (alpha_n = <s_hat, n>/||n||^2 — not the residual s_hat -
    s_target, which would differ by <s_target, n>/||n||^2)."""
    eps = 1e-8
    s, s_hat = reference, estimate
    n = mixture - reference
    s_target = (np.dot(s_hat, s) / (np.dot(s, s) + eps)) * s
    e_noise = (np.dot(s_hat, n) / (np.dot(n, n) + eps)) * n
    e_art = s_hat - s_target - e_noise
    num = np.sum(s_target**2) + eps
    sdr = 10 * np.log10(num / (np.sum((e_noise + e_art) ** 2) + eps))
    sir = 10 * np.log10(num / (np.sum(e_noise**2) + eps))
    sar = 10 * np.log10(num / (np.sum(e_art**2) + eps))
    return float(sdr), float(sir), float(sar)


# ---------------------------------------------------------------------------
# STOI (Taal et al. 2011) / ESTOI (Jensen & Taal 2016), numpy implementation


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs / 2, nfft // 2 + 1)
    k = np.arange(num_bands, dtype=float)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = 2.0 ** ((2 * k - 1) / 6.0) * min_freq
    hi = 2.0 ** ((2 * k + 1) / 6.0) * min_freq
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm, cf


def _stft_frames(x: np.ndarray, win: int, hop: int, nfft: int):
    if len(x) < win:
        return np.zeros((0, nfft // 2 + 1))
    n = 1 + (len(x) - win) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    w = np.hanning(win + 2)[1:-1]
    return np.fft.rfft(x[idx] * w, nfft, axis=1)


def _remove_silent_frames(x, y, dyn_range=40, win=256, hop=128):
    if len(x) < win:
        # shorter than one window: no frames (the 1 + .. formula would still
        # yield one frame whose indices run past the signal)
        return x[:0], y[:0]
    n = 1 + (len(x) - win) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
    w = np.hanning(win + 2)[1:-1]
    energies = 20 * np.log10(np.linalg.norm(x[idx] * w, axis=1) + 1e-12)
    mask = energies > energies.max() - dyn_range
    xs, ys = np.zeros_like(x), np.zeros_like(y)
    count = np.zeros(len(x))
    for i in np.where(mask)[0]:
        xs[idx[i]] += x[idx[i]] * w
        ys[idx[i]] += y[idx[i]] * w
        count[idx[i]] += w
    keep = count > 0
    return xs[keep] / np.maximum(count[keep], 1e-12), ys[keep] / np.maximum(count[keep], 1e-12)


def stoi(reference: np.ndarray, estimate: np.ndarray, fs: int, extended: bool = False) -> float:
    """Short-time objective intelligibility (10 kHz internal rate, 15 third-
    octave bands, 384 ms segments), per the published algorithm."""
    FS, N_FRAME, NFFT, NUM_BANDS, MIN_FREQ, N = 10000, 256, 512, 15, 150.0, 30
    n = min(len(reference), len(estimate))
    x, y = np.asarray(reference[:n], float), np.asarray(estimate[:n], float)
    if fs != FS:
        g = np.gcd(fs, FS)
        x = resample_poly(x, FS // g, fs // g)
        y = resample_poly(y, FS // g, fs // g)
    x, y = _remove_silent_frames(x, y, 40, N_FRAME, N_FRAME // 2)
    if len(x) < N_FRAME * 2:
        return float("nan")
    X = np.abs(_stft_frames(x, N_FRAME, N_FRAME // 2, NFFT)) ** 2
    Y = np.abs(_stft_frames(y, N_FRAME, N_FRAME // 2, NFFT)) ** 2
    obm, _ = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    Xb = np.sqrt(X @ obm.T)  # [frames, bands]
    Yb = np.sqrt(Y @ obm.T)
    if Xb.shape[0] < N:
        return float("nan")
    scores = []
    for m in range(N, Xb.shape[0] + 1):
        xseg = Xb[m - N : m]  # [N, bands]
        yseg = Yb[m - N : m]
        if extended:
            xn = (xseg - xseg.mean(0)) / (np.linalg.norm(xseg - xseg.mean(0), axis=0) + 1e-12)
            yn = (yseg - yseg.mean(0)) / (np.linalg.norm(yseg - yseg.mean(0), axis=0) + 1e-12)
            xr = (xn - xn.mean(1, keepdims=True))
            yr = (yn - yn.mean(1, keepdims=True))
            xr /= np.linalg.norm(xr, axis=1, keepdims=True) + 1e-12
            yr /= np.linalg.norm(yr, axis=1, keepdims=True) + 1e-12
            # Jensen & Taal 2016 eq. 4: average the N unit-norm frame inner
            # products (each <= 1 by Cauchy-Schwarz) — dividing by the band
            # count instead doubled the score (N=30 frames / J=15 bands)
            scores.append(np.sum(xr * yr) / N)
        else:
            alpha = np.linalg.norm(xseg, axis=0, keepdims=True) / (np.linalg.norm(yseg, axis=0, keepdims=True) + 1e-12)
            yprime = np.minimum(yseg * alpha, xseg * (1 + 10 ** (15 / 20)))
            xm = xseg - xseg.mean(0)
            ym = yprime - yprime.mean(0)
            corr = np.sum(xm * ym, 0) / (np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12)
            scores.append(corr.mean())
    return float(np.mean(scores))


def estoi(reference: np.ndarray, estimate: np.ndarray, fs: int) -> float:
    return stoi(reference, estimate, fs, extended=True)
