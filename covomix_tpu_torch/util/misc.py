"""Small utilities (the port's own numpy copy of covomix_tpu/util/misc.py:
directories, mean / std, padding, a name registry, the f0 and length-mask
helpers) and the parameter-tree walk shared by checkpoints and training."""

from __future__ import annotations

import os

import numpy as np


def ensure_dir(file_path: str) -> None:
    os.makedirs(file_path, exist_ok=True)


def mean_std(data: np.ndarray):
    """(mean, std) of the non-NaN entries, as Python floats."""
    data = data[~np.isnan(data)]
    return float(np.mean(data)), float(np.std(data))


def pad_spec(spec: np.ndarray, multiple: int = 64, pad_value: float = 0.0) -> np.ndarray:
    """Pad the time axis (last) of a spectrogram up to a multiple."""
    rem = (-spec.shape[-1]) % multiple
    if rem == 0:
        return spec
    return np.pad(spec, [(0, 0)] * (spec.ndim - 1) + [(0, rem)], constant_values=pad_value)


class Registry:
    """Name -> class registry."""

    def __init__(self, managed_thing: str):
        self.managed_thing = managed_thing
        self._registry = {}

    def register(self, name: str):
        def inner(cls):
            self._registry[name] = cls
            return cls

        return inner

    def get_by_name(self, name: str):
        if name not in self._registry:
            raise ValueError(f"unknown {self.managed_thing}: {name!r}; have {sorted(self._registry)}")
        return self._registry[name]

    def get_all_names(self):
        return sorted(self._registry)


def batch_broadcast(x, array):
    """A scalar as it is; a 1-d x (one entry per row of `array`) reshaped to
    broadcast against `array`."""
    x = np.asarray(x)
    if x.ndim == 0:
        return x
    assert x.ndim == 1 and len(x) == array.shape[0]
    return x.reshape(-1, *([1] * (array.ndim - 1)))


def round_up(n: int, m: int) -> int:
    """Smallest multiple of m >= n (shared bucketing helper)."""
    return ((n + m - 1) // m) * m


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict/list tree in a fixed order; paths are
    '/'-joined keys, the names the `.npz` checkpoints use."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree, in `named_leaves` order."""
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn, tree):
    """The same nested dict/list structure with `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# f0 / pitch and length-mask helpers (numpy)


def process_f0(f0: np.ndarray, hparams: dict):
    """Standardize f0 by the corpus mean / std (hparams 'f0_mean', 'f0_std')
    and interpolate through the unvoiced (f0 == 0) gaps. Returns
    (f0_standardized, uv) with uv 1.0 on the unvoiced input frames."""
    f0 = np.asarray(f0, np.float32)
    f0_ = (f0 - hparams["f0_mean"]) / hparams["f0_std"]
    zeros = np.where(f0 == 0)[0]
    voiced = np.where(f0 > 0)[0]
    if zeros.size and voiced.size:
        f0_[zeros] = np.interp(zeros, voiced, f0_[voiced])
    uv = (f0 == 0).astype(np.float32)
    return f0_.astype(np.float32), uv


def restore_pitch(pitch: np.ndarray, uv, hparams: dict, pitch_padding=None,
                  min=None, max=None):  # noqa: A002 — the reference's argument names
    """Invert process_f0's standardization, clamp to [min, max]; unvoiced
    frames give 1 and padded frames (pitch == -200 by default) 0."""
    pitch = np.asarray(pitch, np.float32)
    if pitch_padding is None:
        pitch_padding = pitch == -200
    pitch = pitch * hparams["f0_std"] + hparams["f0_mean"]
    if min is not None:
        pitch = np.maximum(pitch, min)
    if max is not None:
        pitch = np.minimum(pitch, max)
    if uv is not None:
        pitch = np.where(np.asarray(uv) > 0, 1.0, pitch)
    return np.where(pitch_padding, 0.0, pitch).astype(np.float32)


def make_pad_mask(lengths, xs: np.ndarray = None, length_dim: int = -1) -> np.ndarray:
    """True where a position is padding (>= its row's length): [B, maxlen],
    or with `xs` broadcast to xs's shape along `length_dim`."""
    if length_dim == 0:
        raise ValueError(f"length_dim cannot be 0: {length_dim}")
    lengths = list(lengths)
    bs = len(lengths)
    maxlen = int(max(lengths)) if xs is None else xs.shape[length_dim]
    mask = np.arange(maxlen)[None, :] >= np.asarray(lengths, np.int64)[:, None]
    if xs is not None:
        assert xs.shape[0] == bs, (xs.shape[0], bs)
        if length_dim < 0:
            length_dim = xs.ndim + length_dim
        ind = tuple(slice(None) if i in (0, length_dim) else None for i in range(xs.ndim))
        mask = np.broadcast_to(mask[ind], xs.shape)
    return mask


def make_non_pad_mask(lengths, xs: np.ndarray = None, length_dim: int = -1) -> np.ndarray:
    """True on the valid positions (the inverse of make_pad_mask)."""
    return ~make_pad_mask(lengths, xs, length_dim)


def get_mask_from_lengths(lengths) -> np.ndarray:
    """[B, max(lengths)] bool, True on the valid positions."""
    lengths = np.asarray(lengths, np.int64)
    return np.arange(int(lengths.max()))[None, :] < lengths[:, None]
