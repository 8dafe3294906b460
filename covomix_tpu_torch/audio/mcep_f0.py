"""Mel-cepstral (mcep / mfsc) and coarse-F0 utilities, numpy only (the
port's own copy of covomix_tpu/audio/mcep_f0.py, giving the same numbers).

  * `mcep`: mel-cepstral analysis of one magnitude-spectrum frame. The order-M
    cepstrum c on the alpha-warped frequency axis minimizes the unbiased
    log-spectral criterion (Fukada et al. 1992, the one SPTK's `mcep`
    minimizes)

        E(c) = mean_w [ exp(R) - R - 1 ],   R(w) = log P(w) - 2 (B c)(w)

    with P the frame's power spectrum and B[w, m] = cos(m beta(w)), beta the
    first-order all-pass phase beta(w) = w + 2 atan(alpha sin w /
    (1 - alpha cos w)); a damped Newton iteration (gradient -2 B^T (e^R - 1),
    Gauss-Newton Hessian 4 B^T diag(e^R) B) converges in a handful of steps.
    Its coefficients agree with SPTK's to the optimizer's tolerance, not bit
    for bit.
  * `code_harmonic` / `decode_harmonic`: magnitude spectrogram <-> mfsc (the
    x2-endpoint mirror + rfft packing, and its inverse with |H| = exp(B c)).
  * `f0_to_coarse`: Hz -> 256-bin mel-scale coarse index.
"""

from __future__ import annotations

import numpy as np

# Reference module constants (covomix_model/utils.py:9-13, 42-45).
GAMMA = 0
ALPHA = 0.45
EN_FLOOR = 10 ** (-80 / 20)
FFT_SIZE = 2048

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0


def _warp_basis(n_freq: int, order: int, alpha: float) -> np.ndarray:
    """Cosine basis on the alpha-warped frequency grid: [n_freq, order+1]."""
    w = np.linspace(0.0, np.pi, n_freq)
    beta = w + 2.0 * np.arctan2(alpha * np.sin(w), 1.0 - alpha * np.cos(w))
    m = np.arange(order + 1)
    return np.cos(np.outer(beta, m))


def mcep(spec: np.ndarray, order: int, alpha: float = ALPHA,
         floor: float = EN_FLOOR, max_iter: int = 30, tol: float = 1e-9
         ) -> np.ndarray:
    """Mel-cepstral analysis of one magnitude-spectrum frame.

    spec: one-sided magnitude spectrum [n_freq] (pysptk itype=3 semantics,
    utils.py:10 `mcepInput = 3`), floored at `floor` (utils.py:12 en_floor).
    Returns c [order+1] with log|H|(w) = sum_m c_m cos(m beta(w)).
    """
    spec = np.asarray(spec, np.float64)
    logp = 2.0 * np.log(np.maximum(spec, floor))
    B = _warp_basis(spec.shape[0], order, alpha)
    # init: least-squares fit of the half log-power (exact for in-model spectra)
    c, *_ = np.linalg.lstsq(B, 0.5 * logp, rcond=None)
    nf = float(spec.shape[0])

    def energy(ci):
        r = logp - 2.0 * (B @ ci)
        # clip to keep exp finite on absurd inputs; inactive near the optimum
        return float(np.mean(np.exp(np.minimum(r, 60.0)) - r - 1.0))

    e_prev = energy(c)
    for _ in range(max_iter):
        r = logp - 2.0 * (B @ c)
        er = np.exp(np.minimum(r, 60.0))
        grad = -2.0 * (B.T @ (er - 1.0)) / nf
        hess = 4.0 * (B.T * er) @ B / nf
        hess[np.diag_indices_from(hess)] += 1e-9
        step = np.linalg.solve(hess, grad)
        # damped Newton: halve until the criterion decreases
        t = 1.0
        for _ in range(20):
            e_new = energy(c - t * step)
            if e_new <= e_prev:
                break
            t *= 0.5
        c = c - t * step
        if e_prev - e_new < tol * max(e_prev, 1.0):
            e_prev = e_new
            break
        e_prev = e_new
    return c


def code_harmonic(sp: np.ndarray, order: int) -> np.ndarray:
    """Magnitude spectrogram [T, n_freq] -> mfsc [T, order].

    Exact packing of utils.py:17-28: per-frame mcep(order-1), double the
    first/last coefficients, mirror without the endpoints, rfft, real part.
    """
    mceps = np.apply_along_axis(mcep, 1, np.asarray(sp, np.float64), order - 1)
    scale_mceps = mceps.copy()
    scale_mceps[:, 0] *= 2
    scale_mceps[:, -1] *= 2
    mirror = np.hstack([scale_mceps[:, :-1], scale_mceps[:, -1:0:-1]])
    return np.fft.rfft(mirror).real


def decode_harmonic(mfsc: np.ndarray, fftlen: int = FFT_SIZE) -> np.ndarray:
    """mfsc [T, order] -> smooth magnitude spectrogram [T, fftlen//2+1].

    Exact inverse packing of utils.py:31-39 (irfft, truncate to 60
    coefficients — the reference hardcodes 60 — halve the endpoints), then
    the gamma=0 mgc2sp equivalence |H| = exp(B c).
    """
    mceps_mirror = np.fft.irfft(np.asarray(mfsc, np.float64))
    mceps_back = mceps_mirror[:, :60].copy()
    mceps_back[:, 0] /= 2
    mceps_back[:, -1] /= 2
    B = _warp_basis(fftlen // 2 + 1, mceps_back.shape[1] - 1, ALPHA)
    return np.exp(mceps_back @ B.T)


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Hz -> coarse mel bin in [0, F0_BIN-1]; exact utils.py:47-60.

    f0 == 0 stays bin 0 (the reference's `f0_mel == 0` reset is commented
    out, so exactly-zero mel passes both masks untouched); voiced frames map
    linearly on the mel axis between F0_MIN and F0_MAX into [1, 254], with
    sub-F0_MIN values (negative after scaling) forced to bin 1 and values
    above F0_MAX clamped to 255.
    """
    f0 = np.asarray(f0, np.float64)
    f0_mel = 1127 * np.log(1 + f0 / 700)
    f0_mel_min = 1127 * np.log(1 + F0_MIN / 700)
    f0_mel_max = 1127 * np.log(1 + F0_MAX / 700)
    f0_mel = np.where(
        f0_mel > 0,
        (f0_mel - f0_mel_min) * (F0_BIN - 2) / (f0_mel_max - f0_mel_min) + 1,
        f0_mel)
    f0_mel = np.where(f0_mel < 0, 1.0, f0_mel)
    f0_mel = np.minimum(f0_mel, F0_BIN - 1)
    f0_coarse = np.rint(f0_mel).astype(int)
    assert f0_coarse.size == 0 or (f0_coarse.max() <= 256 and f0_coarse.min() >= 0)
    return f0_coarse
