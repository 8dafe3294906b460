"""Reference front end of a per-file request: the prompt's log-mel, the text's
ids under the character-level fallback vocabulary, and the per-file packing
of prompt and decoded tokens (monologue, one stream).

Log-mel (8 kHz, n_fft 480, hop 160, hann 480, 80 Slaney mels, 0-4 kHz):
reflect-pad the wave by (n_fft - hop) / 2 a side, frame it, |rfft|
(sqrt(re^2 + im^2 + 1e-9)), mel filterbank, log(max(., 1e-5)).

Fallback vocabulary: [PAD], 99 unused slots, [UNK], [CLS], [SEP], [MASK],
then a-z, 0-9, ' and -, then the same 38 as word continuations. A text of
lowercase words separated by spaces encodes as [CLS], per word its first
letter then each further letter as a continuation, [SEP]."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile

CHARS = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [str(d) for d in range(10)] + ["'", "-"]
FIRST = {ch: 104 + i for i, ch in enumerate(CHARS)}
CONT = {ch: 104 + len(CHARS) + i for i, ch in enumerate(CHARS)}
CLS, SEP = 101, 102
TOKEN_CAP = 501
PROMPT_FRAMES = 400
MEL_PAD = -15.0


def encode(text: str) -> np.ndarray:
    """Ids of a text of lowercase words separated by spaces."""
    ids = [CLS]
    for word in text.split():
        ids += [FIRST[word[0]]] + [CONT[ch] for ch in word[1:]]
    return np.asarray(ids + [SEP], np.int64)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), m * 200.0 / 3)


def mel_basis(sr=8000, n_fft=480, n_mels=80, fmin=0.0, fmax=4000.0) -> np.ndarray:
    """Slaney-normalised triangular filters [n_mels, n_fft / 2 + 1]."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lower = (freqs[None, :] - hz[:-2, None]) / np.diff(hz)[:-1, None]
    upper = (hz[2:, None] - freqs[None, :]) / np.diff(hz)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    return w * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(wav: np.ndarray, n_fft=480, hop=160) -> np.ndarray:
    """[samples] -> [frames, 80] float64."""
    pad = (n_fft - hop) // 2
    x = np.pad(np.asarray(wav, np.float64), (pad, pad), mode="reflect")
    frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    spec = np.fft.rfft(x[idx] * window, axis=-1)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return np.log(np.maximum(mag @ mel_basis(n_fft=n_fft).T, 1e-5))


def read_prompt(code_path: str):
    """(semantic codes [n], mel [n, 80]) of a prompt: the codes file and the
    wav beside it, cut to the shorter and to 400 frames."""
    sr, data = wavfile.read(code_path.replace(".hubert_code.npy", ".wav"))
    if sr != 8000:
        raise ValueError(f"prompt wav at {sr} Hz, expected 8000")
    wav = data.astype(np.float64) / 32768.0 if data.dtype == np.int16 else data.astype(np.float64)
    codes = np.load(code_path).astype(np.int64)
    mel = log_mel(np.clip(wav, -1.0, 1.0))
    n = min(len(codes), len(mel), PROMPT_FRAMES)
    return codes[:n], mel[:n]


def bucket(n: int, size: int) -> int:
    return max(size, -(-n // size) * size)


def monologue_rows(codes, mel, tokens, bucket_size: int):
    """One covosingle file's flow inputs: phonemes [prompt codes ‖ tokens]
    capped at 501 and cond [prompt mel ‖ 0], both padded to the bucket
    (phoneme 501, cond 0); returns (phonemes [Tb], cond [Tb, 80], frames)."""
    ph = np.minimum(np.concatenate([codes, tokens]), TOKEN_CAP)
    t = len(ph)
    tb = bucket(t, bucket_size)
    ph_b = np.full(tb, TOKEN_CAP, np.int64)
    ph_b[:t] = ph
    cond = np.zeros((tb, mel.shape[1]), np.float32)
    cond[:len(mel)] = mel
    return ph_b, cond, t


def vocoder_input(mel: np.ndarray, bucket_size: int) -> np.ndarray:
    """A generated mel [g, 80] padded to its bucket with the pad value -15."""
    g = len(mel)
    out = np.full((bucket(g, bucket_size), mel.shape[1]), MEL_PAD, np.float32)
    out[:g] = mel
    return out
