"""Log-mel frontend in PyTorch (port of covomix_tpu/audio/mel.py).

  1. reflect-pad the waveform by (n_fft - hop) / 2 on each side
  2. STFT (hann window, center=False, onesided) as one matmul of the framed
     signal against a windowed DFT basis
  3. magnitude = sqrt(re^2 + im^2 + 1e-9)
  4. Slaney mel filterbank (norm='slaney', htk=False) @ magnitude
  5. log(clamp(mel, min=1e-5))

CoVoMix config: sr 8000, n_fft 480, hop 160, win 480, fmin 0, fmax 4000, 80 mels.

The STFT and the projection run in full f32 whatever the global TF32 flags
say (the JAX package pins Precision.HIGHEST there); their backward, where a
loss differentiates through the mel, runs under the flags of the caller."""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

log_mel_floor = float(np.log(1e-5))  # ~= -11.5129, the log of the mel floor (silence)


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 8000
    n_fft: int = 480
    num_mels: int = 80
    hop_size: int = 160
    win_size: int = 480
    fmin: float = 0.0
    fmax: float = 4000.0

    @property
    def pad(self) -> int:
        return (self.n_fft - self.hop_size) // 2


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)


def mel_filterbank(sample_rate: int, n_fft: int, num_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [num_mels, 1 + n_fft//2]
    (librosa.filters.mel defaults)."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2, dtype=np.float64)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(fmin)), _hz_to_mel_slaney(np.array(fmax)), num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2: num_mels + 2] - hz_pts[:num_mels]))[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _bases(cfg: MelConfig):
    """(mel basis [M, F], windowed DFT basis [n_fft, 2F]: the cos columns,
    then the -sin ones) in numpy."""
    basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)
    n = np.arange(cfg.win_size, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.win_size)   # periodic hann
    win = np.zeros(cfg.n_fft, np.float64)
    lp = (cfg.n_fft - cfg.win_size) // 2
    win[lp: lp + cfg.win_size] = window.astype(np.float32)
    k = np.arange(cfg.n_fft)[:, None]
    f = np.arange(1 + cfg.n_fft // 2)[None, :]
    ang = 2.0 * np.pi * k * f / cfg.n_fft
    dft = np.concatenate([(np.cos(ang) * win[:, None]).astype(np.float32),
                          (-np.sin(ang) * win[:, None]).astype(np.float32)], axis=1)
    return basis, dft


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions and cuBLAS matmuls in full f32 inside the block."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = prev


def stft_magnitude(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Magnitude STFT of [..., T] -> [..., F, frames] in f32: reflect pad
    (n_fft - hop) / 2, center=False, sqrt(power + 1e-9)."""
    dft = torch.from_numpy(_bases(cfg)[1]).to(y.device)
    lead = y.shape[:-1]
    x = F.pad(y.float().reshape(-1, 1, y.shape[-1]), (cfg.pad, cfg.pad), mode="reflect")[:, 0]
    with _no_tf32():
        z = x.unfold(-1, cfg.n_fft, cfg.hop_size) @ dft                  # [N, frames, 2F]
    re, im = torch.chunk(z, 2, dim=-1)
    mag = torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)          # [N, F, frames]
    return mag.reshape(*lead, *mag.shape[1:])


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """Log-mel of waveform [B, T] in [-1, 1] -> [B, num_mels, frames], in f32."""
    basis = torch.from_numpy(_bases(cfg)[0]).to(y.device)
    mag = stft_magnitude(y, cfg)
    with _no_tf32():
        mel = torch.einsum("mf,bft->bmt", basis, mag)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_frames_for_samples(num_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """Number of mel frames produced for a waveform of num_samples samples."""
    padded = num_samples + 2 * cfg.pad
    return 1 + (padded - cfg.n_fft) // cfg.hop_size
