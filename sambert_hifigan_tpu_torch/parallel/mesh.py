"""Data parallelism across processes on `torch.distributed`, the port of the
JAX package's `parallel/mesh.py`.

The JAX package trains data-parallel by sharding the batch's leading axis
over a ('data', 'model') mesh and letting XLA insert the gradient psum.  A
process group has no mesh: each process (rank) owns one replica of the
train state and one contiguous shard of the global batch, and the train
steps reduce explicitly (`all_reduce_`, one collective over one flat f32
buffer).  `create_mesh`, `batch_sharding` and `replicated_sharding` have no
counterpart: the group is the data axis, and a rank's device is its shard.
Tensor parallelism (`sharding_rules.py`, the 'model' axis) is not ported:
every rank holds a whole replica.

* `initialize_distributed` joins a process group from torchrun's
  environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) or from
  explicit arguments (tests pass a `file://` init_method).  Without
  either, nothing is created and every helper below is the identity of a
  single process.  The backend is nccl when each rank of this host owns a
  card of its own, else gloo (the CPU, or ranks sharing one card; nccl
  refuses two ranks on one card).  A gloo group is kept beside an nccl one
  for the small host-side control flags (`any_rank`).
* `shard_batch`: every rank builds the SAME global batch (the host data
  pipeline is seeded) and keeps rows [rank B/n, (rank+1) B/n), on the host
  before the copy to the device.
* `replicate`: broadcast parameters and buffers from rank 0, so that every
  replica starts identical.
* `all_reduce_`: SUM over the ranks, in place, through one flat float32
  buffer.  gloo reduces CUDA tensors itself (it stages them through pinned
  host memory inside ProcessGroupGloo), so the buffer stays on the device.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

_HOST_GROUP = None  # gloo group for host-side flags (the default group when it is gloo)
_LOCAL = False  # inside `local()`: the process computes as if alone
# wall seconds and calls of all_reduce_ (the collective only); with `sync`
# the device is synchronised around it, so the time is the reduction's own
reduce_stats: Dict[str, Any] = {"calls": 0, "seconds": 0.0, "bytes": 0, "sync": False}


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def choose_backend(device: torch.device, local_world_size: int) -> tuple:
    """(backend, why): nccl where each local rank has a card of its own."""
    if device.type != "cuda":
        return "gloo", f"ranks on {device.type}"
    if not dist.is_nccl_available():
        return "gloo", "this torch has no nccl"
    cards = torch.cuda.device_count()
    if local_world_size > cards:
        return "gloo", (f"{local_world_size} ranks share {cards} card(s) on this host, "
                        "and nccl refuses two ranks on one card")
    return "nccl", f"{local_world_size} rank(s) on this host, each on a card of its own"


def initialize_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None, device=None,
                           local_world_size: Optional[int] = None,
                           backend: Optional[str] = None, verbose: bool = True) -> bool:
    """Join a process group; returns whether one exists afterwards.

    Explicit arguments win over torchrun's environment.  With neither
    (no WORLD_SIZE in the environment, no `world_size`) no group is created
    and the caller runs as one process.  `device` is the rank's device (it
    picks the backend); `local_world_size` is the ranks on this host
    (LOCAL_WORLD_SIZE, else the world size)."""
    global _HOST_GROUP
    if dist.is_initialized():
        return True
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world_size is None:
        return False
    rank = rank if rank is not None else (_env_int("RANK") or 0)
    local_world_size = (local_world_size or _env_int("LOCAL_WORLD_SIZE") or world_size)
    device = torch.device(device if device is not None else "cpu")
    why = "asked for"
    if backend is None:
        backend, why = choose_backend(device, local_world_size)
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _HOST_GROUP = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    if verbose and rank == 0:
        print(f"[dist] {world_size} rank(s), backend {backend}: {why}", flush=True)
    return True


def is_distributed() -> bool:
    return not _LOCAL and dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def local():
    """Inside, this rank computes as a single process (no collective, world
    size 1, rank 0): a rank's own single-process check of a step."""
    global _LOCAL
    prev, _LOCAL = _LOCAL, True
    try:
        yield
    finally:
        _LOCAL = prev


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_main() -> bool:
    """Rank 0 writes checkpoints and metrics."""
    return rank() == 0


def local_device(device) -> torch.device:
    """The rank's device: launched as a rank, `cuda` becomes
    cuda:(LOCAL_RANK % cards), so that ranks spread over the host's cards and
    share them when there are fewer; otherwise `device` as it is."""
    device = torch.device(device)
    local = _env_int("LOCAL_RANK")
    if local is None and _env_int("WORLD_SIZE") is not None:
        local = _env_int("RANK")
    if device.type == "cuda" and device.index is None and local is not None:
        device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return device


def setup(device, init_method: Optional[str] = None) -> Tuple[torch.device, bool]:
    """A trainer's start: (the rank's device, whether this call created the
    group).  Launched as ranks (torchrun's environment, or WORLD_SIZE and
    RANK with an explicit `init_method`), the process joins the group on
    its own device; otherwise the device is `device` and nothing changes."""
    device = local_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    existed = is_distributed()
    if init_method is not None and _env_int("WORLD_SIZE") is None:
        raise ValueError("--dist-init-method needs WORLD_SIZE and RANK in the environment")
    return device, initialize_distributed(init_method, device=device) and not existed


def add_dist_flags(p) -> None:
    """The trainers' --dist-init-method."""
    p.add_argument("--dist-init-method", type=str, default=None,
                   help="process-group init method (default env://, as torchrun sets it); "
                        "e.g. file:///tmp/rdv with WORLD_SIZE and RANK in the environment")


def round_batch(batch_size: int, name: str) -> int:
    """The global batch rounded down to a multiple of the world size, as the
    JAX scripts round it to the data axis (with their message)."""
    n = world_size()
    if batch_size % n:
        batch_size = max(n, batch_size - batch_size % n)
        print(f"[{name}] batch rounded to {batch_size} for {n} devices")
    return batch_size


def shard_rows(x, n: Optional[int] = None, r: Optional[int] = None):
    """Rows [r B/n, (r+1) B/n) of an array or tensor's leading axis."""
    n = world_size() if n is None else n
    r = rank() if r is None else r
    if n == 1:
        return x
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} rows does not split over {n} ranks")
    per = b // n
    return x[r * per:(r + 1) * per]


def shard_batch(batch, n: Optional[int] = None, r: Optional[int] = None):
    """This rank's contiguous rows of every array of a global batch (a dict,
    a tuple or list, or one array), on the host."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, n, r) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_rows(v, n, r) for v in batch)
    return shard_rows(batch, n, r)


def _tensors(tree) -> List[torch.Tensor]:
    """Every parameter and buffer of a module, or of the modules of a train
    state (model, EMA), in order."""
    modules = [tree] if isinstance(tree, nn.Module) else [
        m for m in vars(tree).values() if isinstance(m, nn.Module)]
    return [t for m in modules for t in list(m.parameters()) + list(m.buffers())]


@torch.no_grad()
def replicate(tree):
    """Broadcast every parameter and buffer of a module, or of the modules
    of a train state (model, EMA), from rank 0; one collective per dtype.
    Returns `tree`."""
    if not is_distributed():
        return tree
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in _tensors(tree):
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        for t, chunk in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(chunk.view_as(t))
    return tree


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """SUM each tensor over the ranks, in place, through one flat float32
    buffer (one collective a call).  The tensors must be float32 and on one
    device.  The identity without a group."""
    tensors = list(tensors)
    if not is_distributed() or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.dtype != torch.float32:
        raise TypeError(f"all_reduce_ takes float32 tensors, got {flat.dtype}")
    sync = reduce_stats["sync"] and flat.is_cuda
    if sync:
        torch.cuda.synchronize(flat.device)
    t0 = time.perf_counter()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    if sync:
        torch.cuda.synchronize(flat.device)
    reduce_stats["seconds"] += time.perf_counter() - t0
    reduce_stats["calls"] += 1
    reduce_stats["bytes"] += flat.numel() * 4
    for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(chunk.view_as(t))
    return tensors


def any_rank(flag: bool) -> bool:
    """Whether `flag` is set on any rank (a MAX over the host group), so that
    every rank takes the same branch."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def barrier() -> None:
    """Every rank waits here for every other (on the host group)."""
    if is_distributed():
        dist.barrier(group=_HOST_GROUP)


def fold_rank(seed: int) -> int:
    """A per-rank seed from one drawn in lockstep on every rank: rank 0 keeps
    it, so a single process draws what it drew before."""
    return (seed + rank() * 0x9E3779B97F4A7C15) % (2 ** 62)


def destroy(wait: bool = True) -> None:
    """Leave the group, after a final barrier when `wait` (not on an error
    path, where a peer may never reach it)."""
    global _HOST_GROUP
    if dist.is_initialized():
        if wait:
            barrier()
        dist.destroy_process_group()
    _HOST_GROUP = None


def params_digest(tree) -> str:
    """A sha256 of every parameter and buffer's bytes, in order: equal
    digests on every rank mean bit-equal replicas."""
    h = hashlib.sha256()
    for t in _tensors(tree):
        h.update(np.ascontiguousarray(t.detach().cpu().float().numpy()).tobytes())
    return h.hexdigest()
