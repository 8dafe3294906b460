"""The dp x tp, dp x pp and dp x sp meshes and the parameter layout (port
of covomix_tpu/parallel/mesh.py, and of the meshes of pipeline.py and
ring.py).

JAX builds one `Mesh` over every device and lets XLA emit the collectives.
The port runs one process per device over `torch.distributed` (the usual
PyTorch layout; the parameter trees are functional, so there is no module
to wrap in DistributedDataParallel or torch's FSDP): a `Mesh` is this
process's view of the grid, its rank, its device, and the process groups
of its two axes. The second axis is tp, pp or sp (JAX's pp and sp meshes
have no tp axis). Rank r sits at (r // n, r % n) for a second axis of n,
the order of JAX's `devices.reshape(dp, n)`.

`param_shardings` gives each leaf's path JAX's spec, a tuple of None /
"tp" / "dp" per axis, from the same regexes on the same flattened paths
(`pipeline.pp_param_shardings` adds "pp" on a stacked leaf's [depth]
axis).
`shard_params` keeps this rank's part of each leaf and `gather_params`
gives the full tree back, bit for bit. A "dp" or "pp" axis is split in
contiguous blocks. A "tp" axis is
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


def second_axis(tp: int = 1, pp: int = 1, sp: int = 1) -> tuple:
    """(name, size) of a mesh's second axis from its three possible sizes:
    at most one above 1 (JAX's pp and sp meshes have no tp axis); all 1
    gives ("tp", 1)."""
    sizes = {"tp": tp, "pp": pp, "sp": sp}
    for name, size in sizes.items():
        if size < 1:
            raise ValueError(f"{name}={size}: a mesh axis needs at least one device")
    if sum(size > 1 for size in sizes.values()) > 1:
        raise ValueError(f"one second mesh axis at a time: {sizes}")
    return max(sizes.items(), key=lambda kv: kv[1])


@dataclasses.dataclass(frozen=True, init=False)
class Mesh:
    """`dp x n` ranks, one process each; the second axis `axis` (tp, pp or
    sp) of size `n`; this process is `rank` on `device`. `collective`: a
    process group is up. `dp_group` and `group`: the process groups of this
    rank's two axes (None: the default group, for the axis that spans the
    world). Built as Mesh(dp, rank, device, collective, tp= | pp= | sp=);
    `axis_info` is the one place that tells the axes apart."""
    dp: int
    rank: int
    device: torch.device
    collective: bool
    axis: str
    n: int
    dp_group: Any = dataclasses.field(compare=False, repr=False)
    group: Any = dataclasses.field(compare=False, repr=False)

    def __init__(self, dp: int = 1, rank: int = 0, device: torch.device = torch.device("cpu"),
                 collective: bool = False, *, tp: int = 1, pp: int = 1, sp: int = 1, dp_group=None, group=None):
        axis, n = second_axis(tp, pp, sp)
        for name, value in (("dp", dp), ("rank", rank), ("device", device), ("collective", collective),
                            ("axis", axis), ("n", n), ("dp_group", dp_group), ("group", group)):
            object.__setattr__(self, name, value)

    def axis_info(self, name: str) -> tuple:
        """(group, size, index of this rank) on the axis `name`: "dp", the
        second axis, or an axis this mesh lacks (None, 1, 0)."""
        if name == "dp":
            return self.dp_group, self.dp, self.rank // self.n
        if name == self.axis:
            return self.group, self.n, self.rank % self.n
        return None, 1, 0

    tp = property(lambda self: self.axis_info("tp")[1])
    pp = property(lambda self: self.axis_info("pp")[1])
    sp = property(lambda self: self.axis_info("sp")[1])
    dp_rank = property(lambda self: self.axis_info("dp")[2])
    tp_rank = property(lambda self: self.axis_info("tp")[2])
    pp_rank = property(lambda self: self.axis_info("pp")[2])
    sp_rank = property(lambda self: self.axis_info("sp")[2])
    tp_group = property(lambda self: self.axis_info("tp")[0])

    @property
    def syncs_dp(self) -> bool:
        """The data axis has a collective: a group is up and dp > 1, or the
        world is the data axis (no second axis; at world 1 too, where the
        sum is the value itself)."""
        return self.collective and (self.dp > 1 or self.n == 1)

    @property
    def syncs_tp(self) -> bool:
        return self.collective and self.tp > 1

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of `dp * b` rows: the rows of
        its dp index, the same on every tp rank."""
        return slice(self.dp_rank * b, (self.dp_rank + 1) * b)

    def frames(self, t: int) -> slice:
        """This rank's frames of a sequence of `sp * t` frames (every frame
        without an sp axis)."""
        return slice(self.sp_rank * t, (self.sp_rank + 1) * t)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data axis, in place; the value itself without a
        collective on that axis."""
        if self.syncs_dp:
            dist.all_reduce(t, group=self.dp_group)
        return t


def _groups(dp: int, n: int):
    """(dp group, second axis's group) of this rank. Every rank creates
    every subgroup, in the same order (new_group requires it); an axis that
    spans the world uses the default group, an axis of 1 none."""
    if dp > 1 and n > 1:
        rank = dist.get_rank()
        along_dp = [dist.new_group([d * n + t for d in range(dp)]) for t in range(n)]
        along_n = [dist.new_group([d * n + t for t in range(n)]) for d in range(dp)]
        return along_dp[rank % n], along_n[rank // n]
    return None, None


def make_mesh(dp: Optional[int] = 0, device="cuda", devices: Optional[Sequence[torch.device]] = None,
              tp: int = 1, pp: int = 1, sp: int = 1) -> Mesh:
    """JAX's make_mesh(dp, tp), make_pp_mesh(dp, pp) or make_sp_mesh(dp, sp)
    on devices of `device`'s type; at most one of tp, pp, sp above 1 (the
    second axis, n). Inside a process group the group is the mesh: dp x n
    must be its size (dp 0: world // n), and the rank runs on the current
    CUDA device (`multihost.initialize` set it) or on the CPU. Without one,
    the mesh over `devices`: by default every visible CUDA card, or for the
    CPU as many as dp x n asks (CPU ranks share the host's cores, as JAX's
    forced host devices do). dp 0 takes the devices // n; an n beyond the
    devices or a mesh larger than them raises with the count, a smaller one
    prints JAX's note; the mesh returned is rank 0's on `devices[0]`, and
    `multihost.spawn` starts the ranks when dp x n > 1."""
    device = torch.device(device)
    axis, n = second_axis(tp, pp, sp)
    if process_group_ready():
        world = dist.get_world_size()
        if world // n == 0:
            raise ValueError(f"{axis}={n} exceeds the {world} processes of the group (dp would be 0)")
        dp = dp or world // n
        if dp * n != world:
            raise ValueError(f"mesh {dp}x{n} in a process group of {world}: the port runs one process per "
                             f"device, so dp x {axis} is the world size (pass dp 0 or {world // n})")
        here = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
        dp_group, group = _groups(dp, n)
        return Mesh(dp, dist.get_rank(), here, collective=True, tp=tp, pp=pp, sp=sp, dp_group=dp_group,
                    group=group)
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
                   else [device] * (max(1, dp or 0) * n))
    devices = list(devices)
    count = len(devices)
    dp = dp or count // n
    if dp < 1:
        raise ValueError(f"{axis}={n} exceeds the {count} available devices (dp would be 0)")
    if dp * n > count:
        raise ValueError(f"mesh {dp}x{n} needs more than the {count} available devices")
    if dp * n < count:
        print(f"note: mesh dp={dp} x {axis}={n} uses {dp * n} of {count} available devices")
    return Mesh(dp, 0, devices[0], tp=tp, pp=pp, sp=sp)


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
    dp divides over 'dp'. (A pp mesh's layout is the pipeline's own:
    `pipeline.pp_param_shardings`.)"""
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
    """This rank's part of a full leaf (a new contiguous tensor); `groups`
    applies to a tp axis."""
    for ax, name in enumerate(spec):
        if name is not None:
            _, n, i = mesh.axis_info(name)
            x = block(x, ax, n, i, groups if name == "tp" else 1)
    return x.contiguous().clone()


def shard_params(mesh: Mesh, tree: Any, specs: dict) -> Any:
    """This rank's part of every leaf of a full tree (no collective)."""
    parts = iter([shard_leaf(mesh, leaf.detach(), specs[path], tp_groups(path)) for path, leaf in named_leaves(tree)])
    return tree_map(lambda _: next(parts), tree)


@torch.no_grad()
def gather_leaf(mesh: Mesh, x: torch.Tensor, spec, groups: int = 1) -> torch.Tensor:
    """The full leaf from every rank's part (a collective of the leaf's
    axes' groups): over dp and pp, then over tp with its blocks undone."""
    x = x.detach()
    for ax, name in enumerate(spec):
        if name not in (None, "tp"):
            x = all_gather(x, ax, *mesh.axis_info(name))
    for ax, name in enumerate(spec):
        if name == "tp":
            x = unblock(all_gather(x, ax, *mesh.axis_info("tp")), ax, mesh.tp, groups)
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
