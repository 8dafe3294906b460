"""Multi-process start-up and process-aware data feeding (port of
covomix_tpu/parallel/multihost.py).

JAX calls `jax.distributed.initialize()` once per host process and then
sees every host's devices as one mesh. The port runs one process per
device: `initialize` brings up a `torch.distributed` process group (an
explicit `tcp://` coordinator, torchrun's `env://` variables, or SLURM's),
and each process binds its own card. `spawn` starts one rank per local
device from a single command (the single-host `--dp N`). What remains is
data feeding: `process_batch_slice` / `ProcessShardDataset` give each
process its share of the data, and `reconcile_batch` pads every rank's
batch to the cross-rank shape (each collate buckets its own max length)
and moves it to the rank's device.

Single-process behaviour is the degenerate case: no group, rank 0 of 1,
the slice is the whole batch."""

from __future__ import annotations

import datetime
import os
import re
import socket
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from covomix_tpu_torch.data.datasets import _STACK_PAD
from covomix_tpu_torch.parallel.mesh import process_group_ready


def _slurm_address() -> Optional[str]:
    """host:port of SLURM rank 0: MASTER_ADDR / MASTER_PORT when set, else
    the first host of the step's node list (`node[03-05,9]` -> node03) at
    MASTER_PORT or 29500."""
    host = os.environ.get("MASTER_ADDR")
    if host is None:
        nodes = os.environ.get("SLURM_STEP_NODELIST") or os.environ.get("SLURM_JOB_NODELIST")
        if not nodes:
            return None
        m = re.match(r"([^\[,]+)(?:\[([^\]]+)\])?", nodes)
        host = m.group(1) + (re.split(r"[-,]", m.group(2))[0] if m.group(2) else "")
    return f"{host}:{os.environ.get('MASTER_PORT', '29500')}"


def _bind_device(device, rank: int) -> None:
    """torch.cuda.set_device(local rank) before anything allocates or builds
    on the card: LOCAL_RANK (torchrun), SLURM_LOCALID, else the global rank
    over the visible cards."""
    if torch.device(device).type != "cuda":
        return
    local = os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID"))
    torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, requested: bool = False, *, device="cuda",
               backend: Optional[str] = None, timeout: Optional[float] = None) -> bool:
    """Bring up the process group. Resolution order, as the JAX package's:
      1. an explicit coordinator 'host:port' with num_processes and
         process_id (tcp://host:port);
      2. when multi-process is requested, SLURM runs more than one task, or
         num_processes > 1: torchrun's env:// variables (MASTER_ADDR,
         WORLD_SIZE, RANK), else SLURM's (SLURM_PROCID, SLURM_NTASKS);
         with neither, a visible note and one process.
    The backend defaults to NCCL for CUDA and gloo for the CPU; on CUDA each process
    binds its local card first. `timeout`: seconds a collective may wait
    before it fails (torch's default when None: 30 minutes under gloo), so
    ranks whose collectives are out of step raise instead of hanging.
    Returns True when a group is up (at world 1 too), False for the
    single-process case."""
    if process_group_ready():
        return True
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    opts = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        _bind_device(device, process_id)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id, **opts)
        return True
    slurm_n = int(os.environ.get("SLURM_NTASKS", "1"))
    if not (slurm_n > 1 or requested or (num_processes is not None and num_processes > 1)):
        return False
    if all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        _bind_device(device, int(os.environ["RANK"]))
        dist.init_process_group(backend, init_method="env://", **opts)
        return True
    address = _slurm_address() if "SLURM_PROCID" in os.environ else None
    if address is None:
        print("note: multi-host requested but no cluster detected (no coordinator address, torchrun or SLURM "
              "environment); running single-host")
        return False
    rank = int(os.environ["SLURM_PROCID"])
    _bind_device(device, rank)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=slurm_n, rank=rank, **opts)
    return True


def free_port() -> int:
    """A free local TCP port (bound to 0, then released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank: int, fn: Callable, world: int, port: int, device: str, backend: Optional[str],
             timeout: Optional[float], args) -> None:
    initialize(f"127.0.0.1:{port}", world, rank, device=device, backend=backend, timeout=timeout)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args, device="cuda", backend: Optional[str] = None,
          timeout: Optional[float] = None) -> None:
    """Run fn(*args) in `world` new processes, rank r bound to local card r
    (on CUDA), in one process group at a free local port (`timeout`: as
    `initialize`'s). Joins every rank; a rank that fails ends the others
    and raises here. `fn` must be importable by name (a module-level
    function)."""
    torch.multiprocessing.spawn(_spawned, args=(fn, world, free_port(), str(torch.device(device)), backend, timeout,
                                                args), nprocs=world, join=True)


def process_index() -> int:
    return dist.get_rank() if process_group_ready() else 0


def process_count() -> int:
    return dist.get_world_size() if process_group_ready() else 1


def process_batch_slice(global_batch: int, mesh=None) -> slice:
    """The slice of the global batch this process loads: global batch G over
    P processes -> process i loads rows [i*G/P, (i+1)*G/P). With a
    `mesh` (parallel/mesh.py) over tp too, P is its dp and i its dp index:
    the tp ranks of one dp index load the same rows."""
    p, i = (process_count(), process_index()) if mesh is None else (mesh.dp, mesh.dp_rank)
    if global_batch % p:
        raise AssertionError(f"global batch {global_batch} must divide by process count {p}")
    per = global_batch // p
    return slice(i * per, (i + 1) * per)


class ProcessShardDataset:
    """Rank-strided view: process i of P sees items i, i+P, i+2P, ... (the
    DistributedSampler contract); the identity for one process. With a
    `mesh`, i and P are its dp index and dp, so the tp ranks of one dp
    index see the same items."""

    def __init__(self, dataset, index: Optional[int] = None, count: Optional[int] = None, mesh=None):
        self.dataset = dataset
        if mesh is not None:
            index, count = mesh.dp_rank, mesh.dp
        self.index = process_index() if index is None else index
        self.count = process_count() if count is None else count

    def __len__(self) -> int:
        # the floor on every rank: a rank-dependent length would put the
        # ranks' steps per epoch and learning-rate schedules out of step
        return len(self.dataset) // self.count

    def __getitem__(self, i: int):
        return self.dataset[i * self.count + self.index]


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints (rank 0)."""
    return process_index() == 0


def reconcile_batch(batch: dict, device) -> dict:
    """This process's batch (numpy leaves, batch axis first) as tensors on
    `device`, every leaf padded up to the cross-rank max of each trailing
    dim with its key's training pad (mask False, mel -15, codes 501; 0
    otherwise), so that every rank runs the same shapes. One MAX all-reduce
    of the shapes; the identity on shapes without a process group."""
    keys = sorted(batch)
    leaves = [np.asarray(batch[k]) for k in keys]
    if process_group_ready():
        dims = max([leaf.ndim - 1 for leaf in leaves] + [1])
        shapes = torch.tensor([list(leaf.shape[1:]) + [0] * (dims - len(leaf.shape[1:])) for leaf in leaves],
                              dtype=torch.int64, device=device)
        dist.all_reduce(shapes, op=dist.ReduceOp.MAX)
        target = shapes.tolist()
        for i, (k, leaf) in enumerate(zip(keys, leaves)):
            pad = [(0, 0)] + [(0, t - s) for s, t in zip(leaf.shape[1:], target[i])]
            if any(p[1] for p in pad):
                leaves[i] = np.pad(leaf, pad, constant_values=_STACK_PAD.get(k, 0))
    return {k: torch.as_tensor(leaf).to(device) for k, leaf in zip(keys, leaves)}

