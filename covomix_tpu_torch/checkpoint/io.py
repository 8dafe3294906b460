"""Plain-parameter checkpoints: the `.npz` + `.json` format that
covomix_tpu/checkpoint/io.py reads and writes, without JAX.

Keys are `/`-joined paths into the parameter tree; a level whose keys are all
digits is a list. `save_params` writes a tree of tensors or arrays (and an
optional `.json` sidecar), `load_params` returns the tree as numpy arrays and
`params_from_numpy` carries it (or the JAX package's own parameter pytree
after `np.asarray`) onto a torch device under the same names."""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict) -> Any:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(path: str, params: Any, meta: dict | None = None) -> None:
    """Save a parameter tree as .npz (+ a .json sidecar with `meta`). The
    '.npz' suffix is added up front, so the sidecar sits beside the file
    np.savez writes."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    flat = _flatten(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **flat)
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_params(path: str) -> Any:
    """Read a `.npz` parameter tree as numpy arrays (nested dicts/lists)."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def load_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def params_from_numpy(tree: Any, device, dtype=torch.float32) -> Any:
    """The weight carry: a tree of numpy arrays (or tensors on any device) ->
    the same tree of torch tensors on `device`. Floating arrays become `dtype` (parameters are kept
    in f32, compute casts per op as the JAX package does); integer and bool
    arrays keep their type."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree
    else:
        t = torch.from_numpy(np.array(tree, copy=True))   # own, writable, contiguous
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
