"""The parts of covomix_tpu/pipeline.py that batched serving needs:
checkpoint loading (`.npz` + `.json` config sidecar) and prompt preparation
(semantic codes + mel of the sibling wav, equal length, capped at 400 frames).
The per-file Synthesizer modes are not ported yet."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram
from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.data.tokenizer import remove_punctuation

PROMPT_MAX_FRAMES = 400      # 8 s at 20 ms hop


def _tupled(v):
    """JSON lists -> tuples (nested), so frozen configs stay hashable."""
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def load_checkpoint(path: str, cfg_cls):
    """(numpy parameter tree, config) from a `.npz` checkpoint whose `.json`
    sidecar carries the model config under "config"."""
    params = cio.load_params(path)
    meta = cio.load_meta(path)
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    cfg = cfg_cls(**{k: _tupled(v) for k, v in meta.get("config", {}).items() if k in fields})
    return params, cfg


def extract_mel(wav_path: str, mel_cfg: MelConfig = MelConfig(), device=None,
                channel: Optional[int] = None) -> np.ndarray:
    """[T, 80] mel of a wav, computed on `device` (None -> cuda); a sibling
    `.mel.npy` cache ([80, T]) wins when present. `channel` picks one channel
    of a multi-channel wav (default: the mean of the channels)."""
    device = resolve_device(device)
    cache = wav_path.replace(".wav", ".mel.npy")
    if os.path.exists(cache):
        return np.load(cache).T
    wav, _ = load_wav(wav_path, sr=mel_cfg.sample_rate, channel=channel)
    y = torch.as_tensor(wav, dtype=torch.float32, device=device)[None]
    return mel_spectrogram(y, mel_cfg)[0].cpu().numpy().T


def prepare_prompt(hubert_code_path: str, mel_cfg: MelConfig = MelConfig(),
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(semantic tokens [T], mel [T, 80]) of equal length, capped at 400
    frames; the mel is computed on `device` (None -> cuda). Code files may
    store strings; they are cast to int."""
    codes = np.load(hubert_code_path).astype(int)
    mel = extract_mel(hubert_code_path.replace(".hubert_code.npy", ".wav"), mel_cfg, device)
    n = min(len(codes), len(mel), PROMPT_MAX_FRAMES)
    return codes[:n], mel[:n]


def clean_text(text: str) -> str:
    return remove_punctuation(text).lower()
