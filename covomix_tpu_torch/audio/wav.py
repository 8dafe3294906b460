"""Waveform IO built on scipy (librosa/soundfile-free).

Matches the reference loaders' behavior: librosa.load(path, sr=target) returns
float32 in [-1, 1], resampled, mono by default (monologue_generation.py:62-74);
outputs are written as int16 (monologue_generation.py:52-59)."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

MAX_WAV_VALUE = 32768.0


def _to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(wav, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_wav(path, sr: int | None = None, mono: bool = True, channel: int | None = None):
    """Returns (wav float32 [-1,1], sample_rate). Resamples to `sr` if given.

    `channel` selects one channel of a multi-channel file (reference
    extract_mel channel_idx, monologue_generation.py:62-67)."""
    file_sr, data = wavfile.read(path)
    data = _to_float(np.asarray(data))
    if data.ndim == 2:
        if channel is not None:
            data = data[:, channel]
        elif mono:
            data = data.mean(axis=1)
        else:
            data = data.T  # [C, T] like librosa mono=False
    if sr is not None and sr != file_sr:
        data = resample(data, file_sr, sr)
        file_sr = sr
    return np.clip(data, -1.0, 1.0), file_sr


def save_wav(path, wav: np.ndarray, sr: int):
    """Write float waveform in [-1, 1] as int16 (monologue_generation.py:52-59)."""
    wav = np.asarray(wav)
    if wav.dtype in (np.float32, np.float64):
        wav = np.clip(wav, -1.0, 1.0)
        wav = (wav * MAX_WAV_VALUE).astype(np.int16)
    wavfile.write(path, sr, wav)
