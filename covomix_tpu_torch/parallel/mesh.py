"""The dp x tp mesh and the parameter layout (port of covomix_tpu/parallel/mesh.py).

JAX builds one `Mesh` over every device and lets XLA emit the collectives.
The port runs one process per device over `torch.distributed` (the usual
PyTorch layout; the parameter trees are functional, so there is no module
to wrap in DistributedDataParallel or torch's FSDP): a `Mesh` is this
process's view of the `dp x tp` grid, its rank, its device, and the process
groups of its two axes. Rank r sits at (r // tp, r % tp), the order of JAX's
`devices.reshape(dp, tp)`.

`param_shardings` gives each leaf's path JAX's spec, a tuple of None /
"tp" / "dp" per axis, from the same regexes on the same flattened paths.
`shard_params` keeps this rank's part of each leaf and `gather_params`
gives the full tree back, bit for bit. A "dp" axis is split in contiguous blocks. A "tp" axis is
too, except where the axis concatenates groups that a rank computes with
locally (`tp_groups`: q | k | v of `qkv`, k | v of `kv`, value | gate of a
GEGLU `w1`) and each group divides by tp: the rank's shard then holds block
r of every group, in group order (its heads' q, k and v columns; its
(value, gate) pairs). The shard keeps JAX's element count on JAX's axis.

The collectives (`all_gather`, `reduce_scatter`) are chosen by the group's
backend name: NCCL's all_gather_into_tensor / reduce_scatter_tensor; over
gloo an all_reduce, of a buffer holding -0.0 outside the rank's block for
the gather (x + -0.0 == x for every x, so the gather is exact) and of the
whole tensor, then the rank's block, for the scatter. Under gloo, 16-bit
tensors travel as f32."""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from covomix_tpu_torch.util.misc import named_leaves, tree_map


def process_group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`dp x tp` ranks, one process each; this process is `rank` on `device`.
    `collective`: a process group is up. `dp_group` / `tp_group`: the
    process groups of this rank's two axes (None: the default group, for
    the axis that spans the world)."""
    dp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    collective: bool = False
    tp: int = 1
    dp_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    tp_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def syncs_dp(self) -> bool:
        """The data axis has a collective: a group is up and dp > 1, or the
        world is the data axis (tp 1; at world 1 too, where the sum is the
        value itself)."""
        return self.collective and (self.dp > 1 or self.tp == 1)

    @property
    def syncs_tp(self) -> bool:
        return self.collective and self.tp > 1

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of `dp * b` rows: the rows of
        its dp index, the same on every tp rank."""
        return slice(self.dp_rank * b, (self.dp_rank + 1) * b)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data axis, in place; the value itself without a
        collective on that axis."""
        if self.syncs_dp:
            dist.all_reduce(t, group=self.dp_group)
        return t


def _groups(dp: int, tp: int):
    """(dp group, tp group) of this rank. Every rank creates every subgroup,
    in the same order (new_group requires it); an axis that spans the world
    uses the default group, an axis of 1 none."""
    if dp > 1 and tp > 1:
        rank = dist.get_rank()
        along_dp = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
        along_tp = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
        return along_dp[rank % tp], along_tp[rank // tp]
    return None, None


def make_mesh(dp: Optional[int] = 0, device="cuda", devices: Optional[Sequence[torch.device]] = None,
              tp: int = 1) -> Mesh:
    """JAX's make_mesh(dp, tp) on devices of `device`'s type. Inside a
    process group the group is the mesh: dp x tp must be its size (dp 0:
    world // tp), and the rank runs on the current CUDA device
    (`multihost.initialize` set it) or on the CPU. Without one, the mesh
    over `devices`: by default every visible CUDA card, or for the CPU as
    many as dp x tp asks (CPU ranks share the host's cores, as JAX's forced
    host devices do). dp 0 takes n // tp; a tp beyond the devices or a mesh
    larger than them raises with the count, a smaller one prints JAX's note;
    the mesh returned is rank 0's on `devices[0]`, and `multihost.spawn`
    starts the ranks when dp x tp > 1."""
    device = torch.device(device)
    if tp < 1:
        raise ValueError(f"tp={tp}: the tensor-parallel axis needs at least one device")
    if process_group_ready():
        world = dist.get_world_size()
        if world // tp == 0:
            raise ValueError(f"tp={tp} exceeds the {world} processes of the group (dp would be 0)")
        dp = dp or world // tp
        if dp * tp != world:
            raise ValueError(f"mesh {dp}x{tp} in a process group of {world}: the port runs one process per "
                             f"device, so dp x tp is the world size (pass dp 0 or {world // tp})")
        here = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
        dp_group, tp_group = _groups(dp, tp)
        return Mesh(dp, dist.get_rank(), here, collective=True, tp=tp, dp_group=dp_group, tp_group=tp_group)
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
                   else [device] * (max(1, dp or 0) * tp))
    devices = list(devices)
    n = len(devices)
    dp = dp or n // tp
    if dp < 1:
        raise ValueError(f"tp={tp} exceeds the {n} available devices (dp would be 0)")
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs more than the {n} available devices")
    if dp * tp < n:
        print(f"note: mesh dp={dp} x tp={tp} uses {dp * tp} of {n} available devices")
    return Mesh(dp, 0, devices[0], tp=tp)


@torch.no_grad()
def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Every rank takes rank 0's values, in place: one broadcast of a flat
    bucket per dtype. Nothing to do without a process group."""
    if not mesh.collective:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        offset = 0
        for t in group:
            t.copy_(flat[offset: offset + t.numel()].view_as(t))
            offset += t.numel()


# ---------------------------------------------------------------------------
# rule-based parameter layout: regex on the flattened path -> spec
# (the port's own copy of the JAX package's _TP_RULES)

# Shard big matmul weights over 'tp':
#  - qkv/attn projections: output dim (heads)   [d, h*dh] -> (fsdp, 'tp')
#  - attn out:             input dim            [h*dh, d] -> ('tp', fsdp)
#  - ff in  (w1/ff1/fc1/kv/q):                  [d, ff]   -> (fsdp, 'tp')
#  - ff out (w2/ff2/fc2/out):                   [ff, d]   -> ('tp', fsdp)
#  - embeddings / logit weights: vocab          [V, d]    -> ('tp', fsdp)
_LAST = lambda nd: (None,) * (nd - 1) + ("tp",)
_FIRST = lambda nd: ("tp",) + (None,) * (nd - 1)
_TP_RULES = [
    (re.compile(r"(qkv|/q|/kv|ff1|fc1|w1|time_mlp)/w$"), _LAST),
    (re.compile(r"(attn_out|/out|ff2|fc2|w2)/w$"), _FIRST),
    (re.compile(r"(phoneme_emb|text_emb|sem_emb)/w$"), _FIRST),
    # hubert's kmeans centroids are a BARE leaf (no /w child): match the path end
    (re.compile(r"(^|/)kmeans$"), _FIRST),
    (re.compile(r"(ff1|fc1|w1|qkv|/q|/kv|time_mlp)/b$"), lambda nd: ("tp",)),
]

# the leaves whose tp axis concatenates groups computed with locally
_TP_GROUPS = [(re.compile(r"(^|/)qkv/w$"), 3), (re.compile(r"/kv/w$"), 2), (re.compile(r"(^|/)w1/(w|b)$"), 2)]


def tp_groups(path: str) -> int:
    """How many groups the leaf's tp axis concatenates (1: none)."""
    for rx, n in _TP_GROUPS:
        if rx.search(path):
            return n
    return 1


def _spec(path: str, shape, tp: int, dp: int, use_tp: bool, fsdp: bool) -> tuple:
    nd = len(shape)
    spec = None
    if use_tp and tp > 1:
        for rx, make in _TP_RULES:
            if rx.search(path):
                cand = make(nd)
                # only shard if the dim divides evenly
                if all(name != "tp" or shape[ax] % tp == 0 for ax, name in enumerate(cand)):
                    spec = cand
                break
    if spec is None:
        spec = (None,) * nd
    if fsdp and dp > 1 and nd >= 1:
        # shard the first un-sharded axis divisible by dp
        dims = list(spec)
        for ax in range(nd):
            if dims[ax] is None and shape[ax] % dp == 0 and shape[ax] >= dp:
                dims[ax] = "dp"
                break
        spec = tuple(dims)
    return spec


def param_shardings(mesh: Mesh, params: Any, *, tp: bool = True, fsdp: bool = False) -> dict:
    """{path: spec} of a parameter tree (any leaves with a `.shape`), in its
    leaves' order: JAX's `param_shardings(...).spec` of each leaf as a
    tuple. tp shards matmul weights, embeddings and the k-means leaf over
    'tp' where the axis divides; fsdp also shards the first free axis that
    dp divides over 'dp'."""
    return {path: _spec(path, tuple(leaf.shape), mesh.tp, mesh.dp, tp, fsdp) for path, leaf in named_leaves(params)}


def is_sharded(spec) -> bool:
    return any(name is not None for name in spec)


# ---------------------------------------------------------------------------
# a leaf's blocks


def block(x: torch.Tensor, axis: int, n: int, index: int, groups: int = 1) -> torch.Tensor:
    """Block `index` of `n` along `axis`: with `groups` > 1 that divide the
    axis into groups each divisible by n, block `index` of every group, in
    group order; otherwise the contiguous block."""
    size = x.shape[axis]
    if groups > 1 and size % groups == 0 and (size // groups) % n == 0:
        return x.unflatten(axis, (groups, n, size // groups // n)).select(axis + 1, index).flatten(axis, axis + 1)
    k = size // n
    return x.narrow(axis, index * k, k)


def unblock(x: torch.Tensor, axis: int, n: int, groups: int = 1) -> torch.Tensor:
    """The inverse of `block` on the concatenation of the n blocks along
    `axis` (block 0 first)."""
    size = x.shape[axis]
    if groups > 1 and size % groups == 0 and (size // groups) % n == 0:
        return x.unflatten(axis, (n, groups, size // groups // n)).transpose(axis, axis + 1).flatten(axis, axis + 2)
    return x


def shard_leaf(mesh: Mesh, x: torch.Tensor, spec, groups: int = 1) -> torch.Tensor:
    """This rank's part of a full leaf (a new contiguous tensor)."""
    for ax, name in enumerate(spec):
        if name == "tp":
            x = block(x, ax, mesh.tp, mesh.tp_rank, groups)
        elif name == "dp":
            x = block(x, ax, mesh.dp, mesh.dp_rank)
    return x.contiguous().clone()


def shard_params(mesh: Mesh, tree: Any, specs: dict) -> Any:
    """This rank's part of every leaf of a full tree (no collective)."""
    parts = iter([shard_leaf(mesh, leaf.detach(), specs[path], tp_groups(path)) for path, leaf in named_leaves(tree)])
    return tree_map(lambda _: next(parts), tree)


@torch.no_grad()
def gather_leaf(mesh: Mesh, x: torch.Tensor, spec, groups: int = 1) -> torch.Tensor:
    """The full leaf from every rank's part (a collective of the leaf's
    axes' groups): over dp, then over tp with its blocks undone."""
    x = x.detach()
    for ax, name in enumerate(spec):
        if name == "dp":
            x = all_gather(x, ax, mesh.dp_group, mesh.dp, mesh.dp_rank)
    for ax, name in enumerate(spec):
        if name == "tp":
            x = unblock(all_gather(x, ax, mesh.tp_group, mesh.tp, mesh.tp_rank), ax, mesh.tp, groups)
    return x.contiguous().clone()


def gather_params(mesh: Mesh, tree: Any, specs: dict) -> Any:
    """The full tree, bit for bit, from every rank's parts; every rank calls
    it (the leaves in the same order) and every rank gets the tree."""
    full = iter([gather_leaf(mesh, leaf, specs[path], tp_groups(path)) if is_sharded(specs[path])
                 else leaf.detach().clone() for path, leaf in named_leaves(tree)])
    return tree_map(lambda _: next(full), tree)


# ---------------------------------------------------------------------------
# collectives over one axis's group, by backend name


def backend(group) -> str:
    return dist.get_backend(group)


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """What a tensor travels as: 16-bit floats as f32 under gloo."""
    if t.dtype in (torch.bfloat16, torch.float16) and backend(group) == "gloo":
        return t.float()
    return t


def all_gather(t: torch.Tensor, dim: int, group, size: int, rank: int) -> torch.Tensor:
    """The concatenation along `dim` of the group's tensors, in rank order
    (every rank's of the same shape)."""
    if size == 1:
        return t
    if backend(group) == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)
    w = _wire(t, group)
    shape = list(w.shape)
    shape[dim] *= size
    out = torch.full(shape, -0.0, dtype=w.dtype, device=w.device)
    out.narrow(dim, rank * w.shape[dim], w.shape[dim]).copy_(w)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def reduce_scatter(t: torch.Tensor, dim: int, group, size: int, rank: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the group's tensors."""
    if size == 1:
        return t
    if backend(group) == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // size,) + tuple(src.shape[1:]), dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)
    w = _wire(t, group).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(w, group=group)
    k = w.shape[dim] // size
    return w.narrow(dim, rank * k, k).to(t.dtype)
