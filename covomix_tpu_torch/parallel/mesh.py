"""The data-parallel mesh (port of the dp part of covomix_tpu/parallel/mesh.py).

JAX builds one `Mesh` over every device and lets XLA emit the collectives.
The port runs one process per device over `torch.distributed` (the usual
PyTorch layout; the parameter trees are functional, so there is no module
to wrap in DistributedDataParallel): a `Mesh` is this process's view of
the dp axis, its rank, its device and whether a process group carries the
collectives. Parameters are replicated by one broadcast from rank 0
(`replicate`); the batch is split over the ranks by the caller
(`train_step.shard_batch`, `multihost.reconcile_batch`).

`param_shardings` and the tp rules belong to `--tp` / `--fsdp` (ROADMAP
section 1 item 4b) and are not here."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def process_group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`dp` ranks, one process each; this process is `rank` on `device`.
    `collective`: a process group is up, so the ranks' gradients and loss
    are all-reduced (at world 1 too, where the sum is the value itself)."""
    dp: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    collective: bool = False

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of `dp * b` rows."""
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, in place; the value itself without a
        process group."""
        if self.collective:
            dist.all_reduce(t)
        return t


def make_mesh(dp: Optional[int] = 0, device="cuda", devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """JAX's make_mesh for the dp axis, on devices of `device`'s type.
    Inside a process group the group is the mesh: `dp` must be 0 or its
    size, and the rank runs on the current CUDA device (`multihost.
    initialize` set it) or on the CPU. Without one, `dp` ranks over
    `devices`: by default every visible CUDA card, or for the CPU as many as
    `dp` asks (CPU ranks share the host's cores, as JAX's forced host
    devices do). 0 takes every device, more than there are raises with the
    count, fewer prints JAX's note; the mesh returned is rank 0's on
    `devices[0]`, and `multihost.spawn` starts the ranks when dp > 1."""
    device = torch.device(device)
    if process_group_ready():
        world = dist.get_world_size()
        if dp and dp != world:
            raise ValueError(f"dp={dp} in a process group of {world}: the port runs one process per device, "
                             f"so dp is the world size (pass 0 or {world})")
        here = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
        return Mesh(world, dist.get_rank(), here, collective=True)
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())] if device.type == "cuda"
                   else [device] * max(1, dp or 0))
    devices = list(devices)
    n = len(devices)
    dp = dp or n
    if dp > n:
        raise ValueError(f"mesh dp={dp} needs more than the {n} available devices")
    if dp < n:
        print(f"note: mesh dp={dp} x tp=1 uses {dp} of {n} available devices")
    return Mesh(dp, 0, devices[0])


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
