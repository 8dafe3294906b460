"""Plain-parameter checkpoints: the `.npz` + `.json` format that
covomix_tpu/checkpoint/io.py reads and writes, without JAX.

Keys are `/`-joined paths into the parameter tree; a level whose keys are all
digits is a list. `save_params` writes a tree of tensors or arrays (and an
optional `.json` sidecar), `load_params` returns the tree as numpy arrays and
`params_from_numpy` carries it (or the JAX package's own parameter pytree
after `np.asarray`) onto a torch device under the same names.

Training state (parameters, Adam moments, EMA, counters; or a GAN state:
generator, MPD, MSD with the spectral buffers, both AdamW moments and
counts; or a --bmuf_sync run's every rank, stacked) is saved per step by
`save_train_state` / `TopKCheckpointer` and read back by
`load_train_state`. `train_state_from_numpy` carries a JAX package train
state (numpy trees: a `train.loop.TrainState`, a --pp one, a --bmuf_sync
{'train', 'bmuf'} stack or a GanState) into the port's; the repo root's
`convert_jax_train_state.py` uses it to turn a JAX run's orbax step
directory into the port's state.npz."""

from __future__ import annotations

import json
import os
import re
import shutil
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from covomix_tpu_torch.train.gan import GanConfig, make_gan_state, opt_count, trainable_leaves
from covomix_tpu_torch.util.misc import named_leaves, tree_leaves


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


class StackedTrainState(dict):
    """A --bmuf_sync run's train state of every dp rank, as state.npz holds
    it: {name: array} with the names of a TrainState's file plus
    bmuf/global/..., bmuf/smoothed/... and bmuf/t, every array with a
    leading [dp] axis (JAX's stacked {'train', 'bmuf'} layout; made by
    `parallel/bmuf.stack_states` or `stack_rank_states`)."""


def save_train_state(ckpt_dir: str, state, step: int) -> None:
    """Write a `train.loop.TrainState` to `<ckpt_dir>/step_<step>/state.npz`:
    params/..., ema_params/..., adam_m/..., adam_v/... under the parameter
    tree's names, and the counters step, ema_num_updates and adam_step. A
    `train.gan.GanState` is written as gen_params/..., mpd_params/...,
    msd_params/... (the spectral u, v included), opt_g|opt_d/mu|nu/... over
    the trained leaves, and step, opt_g_count, opt_d_count; a
    `StackedTrainState` as it is. The directory appears whole (written
    beside it, then renamed); an existing one for the same step is
    replaced."""
    flat = state_arrays(state)
    final = _step_path(ckpt_dir, step)
    tmp = f"{final}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, STATE_FILE), **flat)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def state_arrays(state) -> dict:
    """{name: array} of a train state, GanState or StackedTrainState: what
    its state.npz holds."""
    if isinstance(state, StackedTrainState):
        return dict(state)
    return _gan_flat(state) if hasattr(state, "opt_d") else _train_flat(state)


def _train_flat(state) -> dict:
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
    return flat


def _gan_params(state):
    """(key, tree) of a GanState's three parameter trees."""
    return ("gen_params", state.gen_params), ("mpd_params", state.mpd_params), ("msd_params", state.msd_params)


def _gan_opts(state):
    """(key, optimizer, the tree it trains) of a GanState's two optimizers."""
    return ("opt_g", state.opt_g, state.gen_params), ("opt_d", state.opt_d, state.d_params)


def _gan_flat(state) -> dict:
    flat = {f"{key}/{name}": _numpy(p) for key, tree in _gan_params(state) for name, p in named_leaves(tree)}
    for key, opt, tree in _gan_opts(state):
        for name, p in trainable_leaves(tree):
            st = opt.state.get(p, {})
            for slot, src in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                flat[f"{key}/{slot}/{name}"] = _numpy(st[src]) if src in st else np.zeros(p.shape, np.float32)
        flat[f"{key}_count"] = np.int64(opt_count(opt))
    flat["step"] = np.int64(state.step)
    return flat


def _set_adam(opt, leaves, count: int, mu: dict, nu: dict) -> None:
    """Adam moments (by leaf name) and the update count into `opt`'s state;
    count 0 leaves it empty, as a fresh optimizer's. A capturable or fused
    optimizer (train.loop's on CUDA) keeps its count on the parameter's
    device."""
    with torch.no_grad():
        for name, p in leaves:
            opt.state.pop(p, None)
            if count > 0:
                step_device = p.device if opt.defaults.get("capturable") or opt.defaults.get("fused") else "cpu"
                opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32, device=step_device),
                                "exp_avg": torch.tensor(np.asarray(mu[name]), dtype=p.dtype, device=p.device),
                                "exp_avg_sq": torch.tensor(np.asarray(nu[name]), dtype=p.dtype, device=p.device)}


# what the JAX package's orbax saver writes into a step directory
ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")
CONVERTER = "convert_jax_train_state.py"


def _layout(names, dp=None) -> str:
    """The layout a parameter tree's leaf names are in (`dp`: the ranks of a
    --bmuf_sync stack)."""
    if dp is not None:
        return f"BMUF stacked {{'train', 'bmuf'}} layout of dp={dp} (a --bmuf_sync run's)"
    if any(n.startswith("stacked/") for n in names):
        return "pipeline {'stacked', 'rest'} layout (a --pp run's)"
    return "canonical layout"


def load_train_state(ckpt_dir: str, step: int, state, bmuf=None) -> Any:
    """Read `step_<step>/state.npz` into `state` (a TrainState or GanState of
    the same model, on any device) in place and return it. `bmuf`: (the
    rank's BMUF state, dp, dp index) of a --bmuf_sync rank, which takes its
    own row of a stacked checkpoint (its `global`, `smoothed` and `t` into
    the BMUF state). A step directory that the JAX package wrote (orbax, no
    state.npz) raises ValueError naming the converter's command, and so does
    a train state in another layout than the run's (a --pp checkpoint into a
    canonical state, a --bmuf_sync one outside BMUF at its dp, or the
    reverse: the error names both layouts)."""
    path = _step_path(ckpt_dir, step)
    if (not os.path.isfile(os.path.join(path, STATE_FILE))
            and any(os.path.exists(os.path.join(path, f)) for f in ORBAX_FILES)):
        raise ValueError(f"{path} is a JAX (orbax) train-state checkpoint, not the port's {STATE_FILE}: convert it "
                         f"first with `python {CONVERTER} {path}` (writes {STATE_FILE} into it; needs jax and orbax)")
    with np.load(os.path.join(path, STATE_FILE)) as z:
        flat = {k: z[k] for k in z.files}
    if hasattr(state, "opt_d"):
        return _load_gan(flat, state)
    names = [n for n, _ in named_leaves(state.params)]
    held = [k[len("params/"):] for k in flat if k.startswith("params/")]
    held_dp = len(flat["bmuf/t"]) if "bmuf/t" in flat else None
    run_dp = None if bmuf is None else bmuf[1]
    if sorted(held) != sorted(names) or held_dp != run_dp:
        raise ValueError(f"{path} holds a train state in the {_layout(held, held_dp)}, this run's state is in the "
                         f"{_layout(names, run_dp)} ({len(held)} against {len(names)} parameter leaves): a --pp "
                         "checkpoint resumes only under --pp, a --bmuf_sync one only under --bmuf_sync at the same "
                         "dp, and a canonical one only without either, as in JAX")
    if bmuf is not None:
        bstate, _, index = bmuf
        flat = {k: v[index] for k, v in flat.items()}
        with torch.no_grad():
            for kind in ("global", "smoothed"):
                for name, t in named_leaves(bstate[kind]):
                    t.copy_(torch.from_numpy(flat[f"bmuf/{kind}/{name}"]))
        bstate["t"] = int(flat["bmuf/t"])
    adam_step = int(flat["adam_step"])
    with torch.no_grad():
        for (name, p), (_, e) in zip(named_leaves(state.params), named_leaves(state.ema_params)):
            p.copy_(torch.from_numpy(flat[f"params/{name}"]))
            e.copy_(torch.from_numpy(flat[f"ema_params/{name}"]))
        _set_adam(state.optimizer, named_leaves(state.params), adam_step,
                  {n: flat[f"adam_m/{n}"] for n, _ in named_leaves(state.params)},
                  {n: flat[f"adam_v/{n}"] for n, _ in named_leaves(state.params)})
    state.step = int(flat["step"])
    state.ema_num_updates = int(flat["ema_num_updates"])
    return state


def _load_gan(flat: dict, state):
    with torch.no_grad():
        for key, tree in _gan_params(state):
            for name, p in named_leaves(tree):
                p.copy_(torch.from_numpy(flat[f"{key}/{name}"]))
    for key, opt, tree in _gan_opts(state):
        mu, nu = ({n: flat[f"{key}/{slot}/{n}"] for n, _ in trainable_leaves(tree)} for slot in ("mu", "nu"))
        _set_adam(opt, trainable_leaves(tree), int(flat[f"{key}_count"]), mu, nu)
    state.step = int(flat["step"])
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


def params_from_numpy(tree: Any, device, dtype=torch.float32, gan_cfg=None) -> Any:
    """The weight carry: a tree of numpy arrays (or tensors on any device) ->
    the same tree of torch tensors on `device`. Floating arrays become `dtype` (parameters are kept
    in f32, compute casts per op as the JAX package does); integer and bool
    arrays keep their type.

    A JAX package GanState after `jax.device_get` (numpy trees, the optax
    AdamW states and the step) becomes the port's `train.gan.GanState`: the
    same leaves, each optimizer's moments and count carried over, the
    optimizers set up from `gan_cfg` (default GanConfig())."""
    if hasattr(tree, "opt_d"):
        return _gan_state_from_numpy(tree, device, gan_cfg)
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


def _adam_moments(opt_state):
    """(count, mu, nu) of an optax Adam state in numpy: the first node of the
    chain / masked (named)tuples with `mu` and `nu` fields (a dict with them
    where orbax restored the tree without its types, tuples then lists). A
    masked-out leaf's moment is an empty tuple (optax's MaskedNode) and
    names no leaf."""
    if isinstance(opt_state, dict) and {"count", "mu", "nu"} <= set(opt_state):
        return int(np.asarray(opt_state["count"])), opt_state["mu"], opt_state["nu"]
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return int(np.asarray(opt_state.count)), opt_state.mu, opt_state.nu
    if isinstance(opt_state, (tuple, list, dict)):
        for s in (opt_state.values() if isinstance(opt_state, dict) else opt_state):
            found = _adam_moments(s)
            if found is not None:
                return found
    return None


def _fields(tree, names) -> SimpleNamespace:
    """A JAX NamedTuple's fields by name, from the NamedTuple itself, from
    the dict orbax restores it as, or from a list of its fields in order."""
    if isinstance(tree, dict):
        return SimpleNamespace(**{n: tree[n] for n in names})
    if hasattr(tree, "_fields"):
        return SimpleNamespace(**{n: getattr(tree, n) for n in names})
    return SimpleNamespace(**dict(zip(names, tree)))


_TRAIN_FIELDS = ("params", "opt_state", "ema_params", "ema_num_updates", "step")
_GAN_FIELDS = ("gen_params", "mpd_params", "msd_params", "opt_g", "opt_d", "step")


def _train_state_from_fields(js: SimpleNamespace, device):
    """A port TrainState from a JAX TrainState's fields (numpy trees): the
    parameters, EMA and counters; Adam's moments and count from optax's
    ScaleByAdamState (with or without the clip link), the count being the
    one the schedule reads (after a BMUF warmup it differs from the step)."""
    from covomix_tpu_torch.train import loop

    count, mu, nu = _adam_moments(js.opt_state)
    state = loop.init_train_state(params_from_numpy(js.params, device), loop.TrainConfig())
    with torch.no_grad():
        for e, src in zip(tree_leaves(state.ema_params), tree_leaves(params_from_numpy(js.ema_params, device))):
            e.copy_(src)
    _set_adam(state.optimizer, named_leaves(state.params), count, dict(named_leaves(mu)), dict(named_leaves(nu)))
    state.ema_num_updates, state.step = int(np.asarray(js.ema_num_updates)), int(np.asarray(js.step))
    return state


def train_state_from_numpy(tree, device="cpu", gan_cfg=None):
    """Carry a JAX package train state, given as numpy trees (after
    `jax.device_get`, or as orbax restores it without an abstract state:
    NamedTuples as dicts, tuples as lists), into the port:

      * a `train.loop.TrainState` (canonical, or a --pp run's {'stacked',
        'rest'} parameters: the names carry over) -> `loop.TrainState` on
        `device` with Adam's moments and count (a default TrainConfig: the
        run's optimizer settings come from its own flags);
      * a --bmuf_sync stack {'train': TrainState fields, 'bmuf': {'global',
        'smoothed', 't'}} whose leaves lead with [dp] -> `StackedTrainState`,
        the port's checkpoint of every rank;
      * a `train.gan.GanState` -> `train.gan.GanState` (`params_from_numpy`).
    """
    if isinstance(tree, dict) and {"train", "bmuf"} <= set(tree):
        ts = np.asarray(tree["bmuf"]["t"])
        rows = []
        for r in range(len(ts)):
            state = _train_state_from_fields(_fields(_pick_rows(tree["train"], r), _TRAIN_FIELDS), "cpu")
            bmuf = {kind: params_from_numpy(_pick_rows(tree["bmuf"][kind], r), "cpu")
                    for kind in ("global", "smoothed")}
            rows.append((state, dict(bmuf, t=int(ts[r]))))
        return stack_rank_states(rows)
    if hasattr(tree, "opt_d") or (isinstance(tree, dict) and "opt_d" in tree):
        return _gan_state_from_numpy(_fields(tree, _GAN_FIELDS), device, gan_cfg)
    return _train_state_from_fields(_fields(tree, _TRAIN_FIELDS), device)


def _pick_rows(tree, r):
    """Row r of every array leaf of an optax state (None and empty nodes kept;
    a NamedTuple becomes a dict of its fields)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _pick_rows(v, r) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: _pick_rows(getattr(tree, k), r) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return [_pick_rows(v, r) for v in tree]
    return np.asarray(tree)[r]


def bmuf_rank_arrays(state, bmuf) -> dict:
    """One dp rank's row of a `StackedTrainState`: its train state's arrays
    (as state.npz names them) and its BMUF state's global, smoothed and t."""
    flat = _train_flat(state)
    for kind in ("global", "smoothed"):
        flat.update({f"bmuf/{kind}/{n}": _numpy(t) for n, t in named_leaves(bmuf[kind])})
    flat["bmuf/t"] = np.int64(bmuf["t"])
    return {k: np.asarray(v) for k, v in flat.items()}


def stack_rank_states(rows) -> StackedTrainState:
    """[(TrainState, BMUF state)] of each dp rank, in rank order -> the
    stacked checkpoint (`StackedTrainState`); the single-process counterpart
    of `parallel/bmuf.stack_states`."""
    flats = [bmuf_rank_arrays(state, bmuf) for state, bmuf in rows]
    return StackedTrainState({k: np.stack([f[k] for f in flats]) for k in flats[0]})


def _gan_state_from_numpy(js, device, gan_cfg):
    state = make_gan_state(*(params_from_numpy(t, device) for t in (js.gen_params, js.mpd_params, js.msd_params)),
                           gan_cfg or GanConfig(), step=int(np.asarray(js.step)))
    for (_, opt, tree), opt_np in zip(_gan_opts(state), (js.opt_g, js.opt_d)):
        count, mu, nu = _adam_moments(opt_np)
        _set_adam(opt, trainable_leaves(tree), count, dict(named_leaves(mu)), dict(named_leaves(nu)))
    return state
