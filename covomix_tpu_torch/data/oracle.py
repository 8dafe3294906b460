"""Oracle prompt pairing for training-time evals and prompt-conditioned
examples (the port's own copy of covomix_tpu/data/oracle.py, numpy and
`random` only: the same `random.Random` seed picks the same prompt, partner
and crop in both packages).

File convention: `<utt>.mel.npy` [80, T] with a sibling
`<utt>.hubert_code.npy` (string-array token ids). Speaker identity is the
filename prefix before the first '-' (Fisher slice naming): `choose_prompt`
picks a same-speaker neighbour and `choose_different_spk` a
different-speaker one."""

from __future__ import annotations

import os
import random
from typing import List, Optional, Tuple

import numpy as np

from covomix_tpu_torch.data.datasets import load_codes


def _spk(path: str) -> str:
    return os.path.basename(path).split("-")[0]


def choose_prompt(mel_files: List[str], i: int, rng: Optional[random.Random] = None) -> int:
    """Index of a same-speaker neighbour within +-30 files: up to 10 retries,
    then the mismatch is accepted."""
    rng = rng or random
    j = rng.randint(max(i - 30, 0), min(i + 30, len(mel_files) - 1))
    tries = 0
    while _spk(mel_files[i]) != _spk(mel_files[j]) and tries < 10:
        j = rng.randint(max(i - 30, 0), min(i + 30, len(mel_files) - 1))
        tries += 1
    return j


def choose_different_spk(mel_files: List[str], i: int, rng: Optional[random.Random] = None) -> int:
    """Index of a different-speaker utterance: first within +-150 files, the
    retries within +-500."""
    rng = rng or random
    j = rng.randint(max(i - 150, 0), min(i + 150, len(mel_files) - 1))
    tries = 0
    while _spk(mel_files[i]) == _spk(mel_files[j]) and tries < 10:
        j = rng.randint(max(i - 500, 0), min(i + 500, len(mel_files) - 1))
        tries += 1
    return j


def _load_pair(mel_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mel [T, 80] f32, codes [T] int32) cut to a common length."""
    mel = np.load(mel_path)
    codes = load_codes(mel_path.replace(".mel.npy", ".hubert_code.npy"))
    n = min(codes.shape[0], mel.shape[1])
    return mel[:, :n].T.astype(np.float32), codes[:n].astype(np.int32)


def _crop(mel, codes, lo, hi, rng, shuffle_spec):
    """Crop to a random length in [lo, hi - 1]: centred, or at a random start
    with `shuffle_spec`."""
    max_len = rng.randint(lo, hi - 1)
    cur = mel.shape[0]
    if cur > max_len:
        start = int(rng.uniform(0, cur - max_len)) if shuffle_spec else (cur - max_len) // 2
        mel = mel[start: start + max_len]
        codes = codes[start: start + max_len]
    return mel, codes


def prepare_oracle_example_with_prompt(mel_files: List[str], i: int, *, rng: Optional[random.Random] = None,
                                       shuffle_spec: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One prompt-conditioned example: the target cropped to 300-700 frames, a
    same-speaker prompt cropped to 100-200 frames, concatenated
    [prompt | target]; mask False on the prompt and True on the target (the
    region to infill and score)."""
    rng = rng or random
    mel, codes = _load_pair(mel_files[i])
    mel, codes = _crop(mel, codes, 300, 700, rng, shuffle_spec)

    j = choose_prompt(mel_files, i, rng)
    pmel, pcodes = _load_pair(mel_files[j])
    pmel, pcodes = _crop(pmel, pcodes, 100, 200, rng, shuffle_spec)

    full_mel = np.concatenate([pmel, mel], axis=0)
    full_codes = np.concatenate([pcodes, codes], axis=0)
    mask = np.ones(full_codes.shape[0], bool)
    mask[: pcodes.shape[0]] = False
    return full_mel, full_codes, mask


def load_two_stream_example(mel_path_a: str, *, rng: Optional[random.Random] = None,
                            random_partner: Optional[List[str]] = None):
    """A VoMix-style pair. `mel_path_a` is the '-A.mel.npy' file; the partner
    stream is the same utterance's '-B' (two input, one output), or with
    `random_partner` a random other file's '-A' (two input, two output).
    Returns (mel [T, 160], codes [T, 2], mixed mel [T, 80] or None)."""
    rng = rng or random
    mel_a, codes_a = _load_pair_suffix(mel_path_a)
    if random_partner is not None:
        other = rng.choice(random_partner)
        mel_b, codes_b = _load_pair_suffix(other.replace(".mel.npy", "-A.mel.npy"))
        mixed = None
    else:
        # the suffix is rewritten in the basename only: a '-A' in a directory
        # name stays as it is
        d, base = os.path.split(mel_path_a)
        mel_b, codes_b = _load_pair_suffix(os.path.join(d, base.replace("-A.mel.npy", "-B.mel.npy")))
        mixed_path = os.path.join(d, base.replace("-A.mel.npy", ".mel.npy"))
        mixed = np.load(mixed_path).T.astype(np.float32) if os.path.isfile(mixed_path) else None
    n = min(len(codes_a), len(codes_b))
    mel = np.concatenate([mel_a[:n], mel_b[:n]], axis=1)
    codes = np.stack([codes_a[:n], codes_b[:n]], axis=-1)
    if mixed is not None:
        mixed = mixed[:n]
    return mel, codes, mixed


def _load_pair_suffix(mel_path: str):
    """_load_pair with the VoMix layout's '-16k.hubert_code.npy' codes
    sibling, or '.hubert_code.npy' where that is absent."""
    mel = np.load(mel_path)
    code_path = mel_path.replace(".mel.npy", "-16k.hubert_code.npy")
    if not os.path.isfile(code_path):
        code_path = mel_path.replace(".mel.npy", ".hubert_code.npy")
    codes = load_codes(code_path)
    n = min(codes.shape[0], mel.shape[1])
    return mel[:, :n].T.astype(np.float32), codes[:n].astype(np.int32)
