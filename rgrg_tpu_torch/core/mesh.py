"""Data-parallel mesh over torch.distributed: one process per device.

The counterpart of the JAX package's core/mesh.py. There, a mesh is one
SPMD program in one process: parameters are replicated, batches sharded
over the "data" axis, and XLA computes the global batch's math, placing
the collectives itself. Here each device has its own process (a rank),
started by `launch`, and the global math is rebuilt explicitly:

  - `make_mesh` spans the ranks of the process group (`launch` starts
    one per device); outside a launch it is this process alone. As in
    JAX it raises past the available devices and, given a batch size,
    clamps to the largest count that divides it.
  - `replicate_pytree` broadcasts every tensor of a params tree from
    rank 0; `shard_pytree_batch` keeps this rank's contiguous rows.
    `host_mesh` gives the mesh's ranks a gloo group of their own for
    host objects (the train CLI's rank-local loader agrees on unreadable
    samples there).
  - `all_reduce` and `all_gather_rows` carry autograd (the gradient of a
    sum over ranks is all-reduced by sum; a gathered row's gradient
    returns to its rank). `all_gather_rows` is an all_reduce of a
    zero-filled global buffer, since gloo carries CUDA tensors only for
    broadcast and all_reduce.
  - `active(mesh)` marks a forward (and its backward) as one rank's share
    of a global batch, and `current()` reads it: train-mode BatchNorm
    takes the global batch's statistics (models/layers.py),
    train/assign.uniform draws at the global shape and keeps this rank's
    rows, and the training losses divide by global counts
    (train/losses.py). Without an active mesh `current()` is the mesh of
    this process alone, whose collectives are the identity: one device
    runs the same code as a rank.

Backends: NCCL on cards, gloo on the CPU. A caller may name gloo with
CUDA devices, also several ranks on one card (NCCL refuses two ranks on
one device); nothing switches backends or devices on its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import pickle
import queue as queue_lib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# the device `launch` gave this process (None outside a launch)
_RANK_DEVICE: Optional[torch.device] = None
# the mesh of the forward in progress (`active`)
_ACTIVE: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: `world_size` ranks, this process's `rank` and
    device, the backend and process group (None for the mesh of a process
    outside a launch, whose collectives are the identity; a launched world
    of one runs its collectives through its backend). A rank past `world_size`
    belongs to the process group but not to the mesh (`member` False):
    make_mesh clamped the mesh to a batch."""
    world_size: int
    rank: int
    device: Optional[torch.device] = None
    backend: Optional[str] = None
    group: Any = None
    axis: str = "data"

    @property
    def size(self) -> int:
        return self.world_size

    @property
    def member(self) -> bool:
        return self.rank < self.world_size

    @property
    def is_main(self) -> bool:
        return self.rank == 0


# the mesh of a process alone: size 1, collectives the identity
_ALONE = Mesh(1, 0)


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def visible_devices() -> int:
    """Devices a mesh can span: the ranks of the process group, else 1."""
    return dist.get_world_size() if _in_group() else 1


def rank_device() -> Optional[torch.device]:
    """The device `launch` gave this rank (None outside a launch)."""
    return _RANK_DEVICE


def process_rank() -> int:
    """This process's rank in the process group, else 0."""
    return dist.get_rank() if _in_group() else 0


def make_mesh(num_devices: Optional[int] = None, axis: str = "data",
              batch_size: Optional[int] = None) -> Mesh:
    """1-D data mesh over the first `num_devices` ranks (default all). With
    batch_size given, clamps the mesh to the largest rank count that
    divides the batch. Every rank of the process group must call it (a
    clamped mesh builds a subgroup)."""
    available = visible_devices()
    if num_devices is not None:
        if num_devices > available:
            raise ValueError(
                f"requested {num_devices} devices but only {available} available "
                f"(ranks of the process group; core.mesh.launch starts one per "
                f"device) — a silently clamped mesh would misattribute throughput "
                f"to parallelism that is not running")
        n = num_devices
    else:
        n = available
    if batch_size is not None:
        while n > 1 and batch_size % n != 0:
            n -= 1
    if not _in_group():
        return Mesh(1, 0, _RANK_DEVICE, None, None, axis)
    rank = dist.get_rank()
    group = dist.group.WORLD if n == available else dist.new_group(list(range(n)))
    return Mesh(n, rank, _RANK_DEVICE, dist.get_backend(), group, axis)


# ---------------------------------------------------------------- placement

def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a params tree: nested dicts / lists of tensors and
    modules (a module's parameters and buffers), in order."""
    if isinstance(tree, nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def replicated(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Overwrite `t` in place with rank 0's bits (any dtype)."""
    if mesh.group is None:
        return t
    buf = t.detach() if t.is_contiguous() else t.detach().contiguous()
    dist.broadcast(buf.reshape(-1).view(torch.uint8), 0, group=mesh.group)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


def replicate_pytree(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of a params tree (dicts, lists, modules) overwritten in
    place with rank 0's; returns the tree."""
    for t in _tensors(tree):
        replicated(t, mesh)
    return tree


def batch_sharded(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of a leading dim of `n`."""
    if n % mesh.size:
        raise ValueError(f"a leading dim of {n} does not divide over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_pytree_batch(tree: Any, mesh: Mesh) -> Any:
    """Every array or tensor leaf of nested dicts cut to this rank's rows of
    its leading dim, in rank order; other leaves unchanged."""
    if isinstance(tree, dict):
        return {k: shard_pytree_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return tree[batch_sharded(tree.shape[0], mesh)]
    return tree


# ---------------------------------------------------------------- collectives

def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.contiguous().clone(), ctx.group), None


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the mesh's ranks, differentiable: the gradient of a sum
    over ranks is the sum of the ranks' gradients."""
    if mesh is None or mesh.group is None:
        return x
    return _AllReduce.apply(x, mesh.group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, world):
        ctx.group, ctx.rows = group, slice(rank * x.shape[0], (rank + 1) * x.shape[0])
        buf = x.new_zeros((world * x.shape[0],) + tuple(x.shape[1:]))
        buf[ctx.rows] = x
        return _all_reduce_(buf, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.contiguous().clone(), ctx.group)[ctx.rows], None, None, None


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's `x` (equal shapes) concatenated on dim 0 in rank order,
    differentiable; bool tensors travel as uint8, 16-bit floats as f32.
    Exact: each row is summed with zeros only."""
    if mesh is None or mesh.group is None:
        return x
    if x.dtype == torch.bool:
        return all_gather_rows(x.to(torch.uint8), mesh).to(torch.bool)
    if x.dtype in (torch.bfloat16, torch.float16):
        return all_gather_rows(x.to(torch.float32), mesh).to(x.dtype)
    return _GatherRows.apply(x, mesh.group, mesh.rank, mesh.size)


@torch.no_grad()
def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over the mesh's ranks without a gradient (counts, reports)."""
    if mesh is None or mesh.group is None:
        return x
    return _all_reduce_(x.detach().clone(), mesh.group)


GRAD_BUCKET_BYTES = 256 << 20


@torch.no_grad()
def all_reduce_grads_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum every tensor's .grad over the ranks in place (a missing .grad
    counts as zeros and is filled), in buckets of about GRAD_BUCKET_BYTES
    (one flat copy of a bucket at a time)."""
    if mesh is None or mesh.group is None:
        return
    for t in tensors:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = _all_reduce_(torch.cat([t.grad.reshape(-1) for t in bucket]), mesh.group)
        off = 0
        for t in bucket:
            n = t.grad.numel()
            t.grad.copy_(flat[off:off + n].view_as(t.grad))
            off += n
        bucket.clear()

    for t in tensors:
        if bucket and (bucket[0].grad.dtype != t.grad.dtype or size >= GRAD_BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(t)
        size += t.grad.numel() * t.grad.element_size()
    if bucket:
        flush()


def gather_objects(obj: Any, mesh: Mesh) -> List[Any]:
    """Every rank's picklable `obj`, in rank order (host objects)."""
    if mesh.group is None:
        return [obj]
    out: List[Any] = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def host_mesh(mesh: Mesh) -> Mesh:
    """`mesh`'s ranks over a gloo group of their own, for host objects
    (gather_objects) that must not queue behind, or interleave with, the
    collectives of the mesh's own group; the mesh of a process alone is
    returned as it is. Every rank of the process group must call it, as
    make_mesh."""
    if mesh.group is None:
        return mesh
    group = dist.new_group(list(range(mesh.size)), backend="gloo")
    return dataclasses.replace(mesh, backend="gloo", group=group)


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's picklable `obj` on every rank."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0, group=mesh.group)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Run the enclosed forward and backward as this rank's share of the
    global batch of `mesh` (None: no mesh)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current() -> Mesh:
    """The mesh set by `active`; without one, the mesh of this process
    alone (size 1, rank 0, collectives the identity)."""
    return _ACTIVE if _ACTIVE is not None else _ALONE


# ---------------------------------------------------------------- launcher

def _rank_main(rank, world, store_path, backend, device, timeout_s, threads, call,
               results):
    global _RANK_DEVICE
    device = torch.device(device)
    if threads:
        torch.set_num_threads(threads)
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        _RANK_DEVICE = device
        fn, args = pickle.loads(call)
        results.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    dist.destroy_process_group()


def _devices(nprocs: int, device, devices) -> List[str]:
    if devices is not None:
        if len(devices) != nprocs:
            raise ValueError(f"{len(devices)} devices for {nprocs} ranks")
        return [str(torch.device(d)) for d in devices]
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return ["cpu"] * nprocs
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    count = torch.cuda.device_count()
    if nprocs > count:
        raise ValueError(f"{nprocs} ranks need {nprocs} cards but {count} are visible; "
                         f"name the devices (and gloo) to share a card")
    return [f"cuda:{i}" for i in range(nprocs)]


def launch(fn: Callable[..., Any], nprocs: int, args: Sequence[Any] = (),
           device=None, devices: Optional[Sequence[Any]] = None,
           backend: Optional[str] = None, timeout_s: float = 600.0,
           threads: Optional[int] = None) -> List[Any]:
    """Run fn(rank, *args) in `nprocs` spawned processes joined in one
    process group; returns the ranks' results in rank order (host objects:
    they are pickled back). `args` travel pickled by value: each rank holds
    its own copy of every tensor in them.

    fn must be importable by name (a module-level function of a module the
    child can import). Devices: `devices` (one per rank), else one card per
    rank (`device` "cuda", the default, raising past the visible cards) or
    all on the CPU (`device` "cpu"). Backend: NCCL when every rank has its
    own card, gloo on the CPU; `backend="gloo"` with a repeated CUDA device
    runs several ranks on one card. The rendezvous is a FileStore in a
    temporary directory; collectives time out after `timeout_s`. If a rank
    raises or dies, the others are stopped and this raises with its
    traceback. Ranks on the CPU run `threads` torch threads each (default:
    this process's threads shared out)."""
    devs = _devices(nprocs, device, devices)
    kinds = {torch.device(d).type for d in devs}
    if len(kinds) != 1:
        raise ValueError(f"ranks on mixed device types: {devs}")
    if backend is None:
        backend = "gloo" if kinds == {"cpu"} else "nccl"
    if backend == "nccl" and (kinds != {"cuda"} or len(set(devs)) != len(devs)):
        raise ValueError(f"NCCL needs one card per rank, got {devs}; use backend='gloo' "
                         f"for ranks that share a card or run on the CPU")
    if kinds != {"cpu"}:
        threads = None
    elif threads is None:
        threads = max(1, torch.get_num_threads() // nprocs)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="rgrg_mesh_")
    results = ctx.Queue()
    # plain pickles both ways: the multiprocessing pickler would move tensors
    # to shared memory, which every rank (and this process) would then write
    call = pickle.dumps((fn, tuple(args)))
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(r, nprocs, os.path.join(tmp, "store"), backend, devs[r],
                               timeout_s, threads, call, results))
             for r in range(nprocs)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in out]
                if dead:
                    time.sleep(0.5)   # a last report may still be in the pipe
                    while not results.empty():
                        rank, ok, payload = results.get()
                        if not ok:
                            raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{payload}")
                        out[rank] = pickle.loads(payload)
                    dead = [r for r in dead if r not in out]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of {nprocs} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=timeout_s)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(nprocs)]
