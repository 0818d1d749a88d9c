"""Data and tensor parallelism across processes on `torch.distributed`, the
port of the JAX package's `parallel/mesh.py` and of its 'model' mesh axis.

The JAX package trains over a ('data', 'model') mesh: the batch's leading
axis is sharded over 'data', and under `--model-parallel N` the train state
is stored sharded over 'model' (`sharding_rules.py`), with XLA inserting
the weight gathers and the gradient psum.  A process group has no mesh: the
ranks are laid out as a data x model grid by hand (`set_model_parallel`,
JAX `create_mesh`'s reshape(data, model): rank r at data index r // model
and model index r % model), and the train steps call the collectives
explicitly.

* `initialize_distributed` joins a process group from torchrun's
  environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT) or from
  explicit arguments (tests pass a `file://` init_method).  Without
  either, nothing is created and every helper below is the identity of a
  single process.  The backend is nccl when each rank of this host owns a
  card of its own, else gloo (the CPU, or ranks sharing one card; nccl
  refuses two ranks on one card).  A gloo group is kept beside an nccl one
  for the small host-side control flags (`any_rank`).
* `set_model_parallel(m)`: the grid, with one group per data index (the
  m ranks that hold the same rows, over which the weights are gathered)
  and one per model index (the ranks that hold the same shard, over which
  the gradients are reduced).  m = 1, the default, is pure data
  parallelism: the data axis is the whole world.
* `shard_batch`: every rank builds the SAME global batch (the host data
  pipeline is seeded) and keeps the rows of its data index,
  [d B/D, (d+1) B/D) of D data ranks, on the host before the copy to the
  device.  The ranks of one model group keep the same rows.
* `replicate`: broadcast parameters and buffers from rank 0, so that every
  replica starts identical.
* `all_reduce_`: SUM over the data axis, in place, through one flat float32
  buffer.  `all_gather_`: the whole tensors whose model-axis slices the
  ranks of a model group hold, through one flat float32 buffer.
  `broadcast_model_`: a model group's first rank's tensors on every rank
  of the group.  gloo takes CUDA tensors in all three (ProcessGroupGloo
  stages them through pinned host memory itself), so the buffers stay on
  the device.
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
_MODEL = 1  # the model axis's size (set_model_parallel)
# model size -> (this rank's model group, its data group); None for the world
_GRID_GROUPS: Dict[int, tuple] = {}
# wall seconds and calls of all_reduce_ and all_gather_ (the collective
# only); with `sync` the device is synchronised around it, so the time is
# the collective's own
reduce_stats: Dict[str, Any] = {"calls": 0, "seconds": 0.0, "bytes": 0, "sync": False}
gather_stats: Dict[str, Any] = {"calls": 0, "seconds": 0.0, "bytes": 0, "sync": False}


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


def set_model_parallel(model: int) -> None:
    """Lay the ranks out as a data x model grid (every rank calls this, in
    the same order: it creates the groups).  A world that `model` does not
    divide raises, as JAX `create_mesh` does; so does model > 1 without a
    process group."""
    global _MODEL
    if model < 1:
        raise ValueError(f"model parallelism must be >= 1, got {model}")
    if model > 1 and not is_distributed():
        raise ValueError(f"--model-parallel {model} needs a process group of a multiple of "
                         f"{model} ranks (torchrun --nproc-per-node); this is one process")
    n = world_size()
    if n % model:
        raise ValueError(f"{n} ranks not divisible by model={model}")
    if model > 1 and model not in _GRID_GROUPS:
        data, r = n // model, rank()
        mine = [None, None]
        for d in range(data):  # the ranks of one data index: one model group
            g = dist.new_group([d * model + j for j in range(model)])
            if d == r // model:
                mine[0] = g
        for j in range(model):  # the ranks of one model index: one data group
            g = dist.new_group([d * model + j for d in range(data)])
            if j == r % model:
                mine[1] = g
        _GRID_GROUPS[model] = tuple(mine)
    _MODEL = model


def model_size() -> int:
    return _MODEL if is_distributed() else 1


def data_size() -> int:
    return world_size() // model_size()


def model_index() -> int:
    return rank() % model_size()


def data_index() -> int:
    return rank() // model_size()


def _model_group():
    return _GRID_GROUPS[_MODEL][0]


def _data_group():
    return _GRID_GROUPS[_MODEL][1] if model_size() > 1 else None


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
    """The trainers' --dist-init-method and --model-parallel."""
    p.add_argument("--dist-init-method", type=str, default=None,
                   help="process-group init method (default env://, as torchrun sets it); "
                        "e.g. file:///tmp/rdv with WORLD_SIZE and RANK in the environment")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="size of the 'model' axis (shape-rule tensor parallelism: the "
                        "params, moments and EMA stored sharded over it; ranks/model must "
                        "divide evenly)")


def round_batch(batch_size: int, name: str) -> int:
    """The global batch rounded down to a multiple of the data axis's size,
    as the JAX scripts round it (with their message)."""
    n = data_size()
    if batch_size % n:
        batch_size = max(n, batch_size - batch_size % n)
        print(f"[{name}] batch rounded to {batch_size} for {n} devices")
    return batch_size


def shard_rows(x, n: Optional[int] = None, r: Optional[int] = None):
    """Rows [r B/n, (r+1) B/n) of an array or tensor's leading axis; by
    default n, r are the data axis's size and this rank's data index."""
    n = data_size() if n is None else n
    r = data_index() if r is None else r
    if n == 1:
        return x
    b = x.shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} rows does not split over {n} ranks")
    per = b // n
    return x[r * per:(r + 1) * per]


def shard_batch(batch, n: Optional[int] = None, r: Optional[int] = None):
    """This rank's contiguous rows (those of its data index) of every array
    of a global batch (a dict, a tuple or list, or one array), on the host."""
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


def _flat_f32(tensors: Sequence[torch.Tensor], what: str) -> torch.Tensor:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 tensors, got {flat.dtype}")
    return flat


@contextlib.contextmanager
def _timed(stats: Dict[str, Any], flat: torch.Tensor, nbytes: int):
    sync = stats["sync"] and flat.is_cuda
    if sync:
        torch.cuda.synchronize(flat.device)
    t0 = time.perf_counter()
    yield
    if sync:
        torch.cuda.synchronize(flat.device)
    stats["seconds"] += time.perf_counter() - t0
    stats["calls"] += 1
    stats["bytes"] += nbytes


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """SUM each tensor over the data axis (the ranks of this rank's model
    index), in place, through one flat float32 buffer (one collective a
    call).  The tensors must be float32 and on one device.  The identity
    without a group and on a data axis of one rank."""
    tensors = list(tensors)
    if data_size() == 1 or not tensors:
        return tensors
    flat = _flat_f32(tensors, "all_reduce_")
    with _timed(reduce_stats, flat, flat.numel() * 4):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_data_group())
    for t, chunk in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(chunk.view_as(t))
    return tensors


def own_slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's model-axis slice of a whole tensor along `dim` (a view):
    the model index's contiguous 1/m of the dimension."""
    m = model_size()
    n = t.shape[dim] // m
    return t.narrow(dim, model_index() * n, n)


@torch.no_grad()
def all_gather_(shards: Sequence[torch.Tensor], dims: Sequence[int]) -> List[torch.Tensor]:
    """The whole tensors of the model group's slices: each tensor's slices,
    in model-index order, concatenated along its dim (`own_slice`'s
    inverse), from one all_gather of one flat float32 buffer over the model
    group.  New tensors; the identity on a model axis of one rank."""
    shards = list(shards)
    m = model_size()
    if m == 1 or not shards:
        return shards
    flat = _flat_f32(shards, "all_gather_")
    parts = [torch.empty_like(flat) for _ in range(m)]
    with _timed(gather_stats, flat, flat.numel() * 4 * m):
        dist.all_gather(parts, flat, group=_model_group())
    out, at = [], 0
    for s, d in zip(shards, dims):
        n = s.numel()
        out.append(torch.cat([p[at:at + n].view(s.shape) for p in parts], dim=d))
        at += n
    return out


@torch.no_grad()
def broadcast_model_(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The model group's first rank's values of `tensors` on every rank of
    the group, in place, through one flat float32 buffer: the leaves that
    every rank of the group computes whole stay bit-equal on all of them
    even where the device's reductions are not deterministic.  The identity
    on a model axis of one rank."""
    tensors = list(tensors)
    if model_size() == 1 or not tensors:
        return tensors
    flat = _flat_f32(tensors, "broadcast_model_")
    dist.broadcast(flat, src=data_index() * model_size(), group=_model_group())
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
    """A per-shard seed from one drawn in lockstep on every rank: the data
    index is folded in (the ranks of one model group hold the same rows and
    draw the same masks); data index 0 keeps it, so a single process draws
    what it drew before."""
    return (seed + data_index() * 0x9E3779B97F4A7C15) % (2 ** 62)


def destroy(wait: bool = True) -> None:
    """Leave the group, after a final barrier when `wait` (not on an error
    path, where a peer may never reach it)."""
    global _HOST_GROUP, _MODEL
    if dist.is_initialized():
        if wait:
            barrier()
        dist.destroy_process_group()
    _HOST_GROUP = None
    _MODEL = 1
    _GRID_GROUPS.clear()


def params_digest(tree) -> str:
    """A sha256 of every parameter and buffer's bytes, in order: equal
    digests on every rank mean bit-equal replicas."""
    h = hashlib.sha256()
    for t in _tensors(tree):
        h.update(np.ascontiguousarray(t.detach().cpu().float().numpy()).tobytes())
    return h.hexdigest()
