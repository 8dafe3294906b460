"""Plain-parameter checkpoints: the `.npz` + `.json` format that
covomix_tpu/checkpoint/io.py writes, read without JAX.

Keys are `/`-joined paths into the parameter tree; a level whose keys are all
digits is a list. `load_params` returns that tree of numpy arrays and
`params_from_numpy` carries it (or the JAX package's own parameter pytree
after `np.asarray`) onto a torch device under the same names."""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


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
