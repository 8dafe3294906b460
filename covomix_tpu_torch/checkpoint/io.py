"""Plain-parameter checkpoints: the `.npz` + `.json` format that
covomix_tpu/checkpoint/io.py reads and writes, without JAX.

Keys are `/`-joined paths into the parameter tree; a level whose keys are all
digits is a list. `save_params` writes a tree of tensors or arrays (and an
optional `.json` sidecar), `load_params` returns the tree as numpy arrays and
`params_from_numpy` carries it (or the JAX package's own parameter pytree
after `np.asarray`) onto a torch device under the same names.

Training state (parameters, Adam moments, EMA, counters) is saved per step
by `save_train_state` / `TopKCheckpointer` and read back by
`load_train_state`."""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from covomix_tpu_torch.util.misc import named_leaves


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(tree: Any) -> dict:
    return {name: _numpy(leaf) for name, leaf in named_leaves(tree)}


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


# ---------------------------------------------------------------------------
# train-state checkpoints: one `state.npz` per `step_XXXXXXXX/` directory
# (the port's format in place of the JAX package's orbax directories)

STATE_FILE = "state.npz"


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_train_state(ckpt_dir: str, state, step: int) -> None:
    """Write a `train.loop.TrainState` to `<ckpt_dir>/step_<step>/state.npz`:
    params/..., ema_params/..., adam_m/..., adam_v/... under the parameter
    tree's names, and the counters step, ema_num_updates and adam_step. The
    directory appears whole (written beside it, then renamed); an existing
    one for the same step is replaced."""
    flat = {}
    adam_step = 0
    for (name, p), (_, e) in zip(named_leaves(state.params), named_leaves(state.ema_params)):
        st = state.optimizer.state.get(p, {})
        flat[f"params/{name}"], flat[f"ema_params/{name}"] = _numpy(p), _numpy(e)
        for key, slot in (("adam_m", "exp_avg"), ("adam_v", "exp_avg_sq")):
            flat[f"{key}/{name}"] = _numpy(st[slot]) if slot in st else np.zeros(p.shape, np.float32)
        if "step" in st:
            adam_step = int(st["step"])
    flat.update(step=np.int64(state.step), ema_num_updates=np.int64(state.ema_num_updates),
                adam_step=np.int64(adam_step))
    final = _step_path(ckpt_dir, step)
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, STATE_FILE), **flat)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def load_train_state(ckpt_dir: str, step: int, state) -> Any:
    """Read `step_<step>/state.npz` into `state` (a TrainState of the same
    model, on any device) in place and return it."""
    with np.load(os.path.join(_step_path(ckpt_dir, step), STATE_FILE)) as z:
        flat = {k: z[k] for k in z.files}
    adam_step = int(flat["adam_step"])
    with torch.no_grad():
        for (name, p), (_, e) in zip(named_leaves(state.params), named_leaves(state.ema_params)):
            p.copy_(torch.from_numpy(flat[f"params/{name}"]))
            e.copy_(torch.from_numpy(flat[f"ema_params/{name}"]))
            state.optimizer.state.pop(p, None)
            if adam_step > 0:
                state.optimizer.state[p] = {
                    "step": torch.tensor(float(adam_step), dtype=torch.float32),
                    "exp_avg": torch.from_numpy(flat[f"adam_m/{name}"]).to(p.device),
                    "exp_avg_sq": torch.from_numpy(flat[f"adam_v/{name}"]).to(p.device)}
    state.step = int(flat["step"])
    state.ema_num_updates = int(flat["ema_num_updates"])
    return state


def _step_dirs(ckpt_dir: str):
    """The steps of the complete step_NNNNNNNN directories (a save in flight
    or interrupted leaves a '.tmp-' directory, which is not one)."""
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m:
            out.append(int(m.group(1)))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    """The newest saved step under `ckpt_dir` (auto-resume), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _step_dirs(ckpt_dir)
    return max(steps) if steps else None


class TopKCheckpointer:
    """save_last + keep-top-K-by-metric checkpoint policy (the reference's
    ModelCheckpoint(save_last=True, save_top_k=10, monitor='l2'), lower is
    better with mode 'min').

    * `save(state, step)`: rolling "last" save; the previous unranked last
      is pruned.
    * `save(state, step, metric=l2)`: ranked save; only the best `top_k`
      ranked checkpoints survive (plus the rolling last).
    The ranking persists in topk.json for resume; `best_step()` returns the
    current best ranked step."""

    def __init__(self, ckpt_dir: str, top_k: int = 10, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.ckpt_dir = ckpt_dir
        self.top_k = top_k
        self.mode = mode
        self._index_path = os.path.join(ckpt_dir, "topk.json")
        self.ranked: dict[int, float] = {}
        self.last_step: int | None = None
        if os.path.isfile(self._index_path):
            with open(self._index_path) as f:
                idx = json.load(f)
            self.ranked = {int(k): float(v) for k, v in idx.get("ranked", {}).items()}
            self.last_step = idx.get("last_step")

    def _persist(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(self._index_path, "w") as f:
            json.dump({"ranked": {str(k): v for k, v in self.ranked.items()},
                       "last_step": self.last_step,
                       "best_step": self.best_step()}, f, indent=2)

    def _delete(self, step: int):
        shutil.rmtree(_step_path(self.ckpt_dir, step), ignore_errors=True)

    def _kept_steps(self) -> set:
        keep = set(self.ranked.keys())
        if self.last_step is not None:
            keep.add(self.last_step)
        return keep

    def save(self, state: Any, step: int, metric: float | None = None) -> None:
        prev_last = self.last_step
        save_train_state(self.ckpt_dir, state, step)
        self.last_step = step
        if metric is not None:
            self.ranked[step] = float(metric)
            if len(self.ranked) > self.top_k:
                order = sorted(self.ranked.items(), key=lambda kv: kv[1],
                               reverse=(self.mode == "max"))
                for s, _ in order[self.top_k:]:
                    del self.ranked[s]
        keep = self._kept_steps()
        if prev_last is not None and prev_last != step and prev_last not in keep:
            self._delete(prev_last)
        for s in _step_dirs(self.ckpt_dir):
            if s not in keep:
                self._delete(s)
        self._persist()

    def best_step(self) -> int | None:
        if not self.ranked:
            return None
        order = sorted(self.ranked.items(), key=lambda kv: kv[1],
                       reverse=(self.mode == "max"))
        return order[0][0]


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
        t = torch.from_numpy(np.array(tree, copy=True, order="C"))   # own, writable, contiguous
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
