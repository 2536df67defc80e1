"""Process-group mesh, data sharding and collectives (counterpart of
:mod:`ich_tpu.parallel.mesh`).

The JAX package has one program over a ``jax.sharding.Mesh`` of devices,
and XLA inserts the collectives. Here every rank is a process that runs
the same program on its slice of each global batch: a :class:`Mesh` holds
the ``torch.distributed`` process group, this process's rank, the world
size and the device, and the collectives below are called where the JAX
program has its implicit ones (the gradient mean, BatchNorm's statistics,
the InfoNCE gather). A mesh on a CUDA device runs NCCL and raises where
NCCL is missing; gloo runs only when the caller asks for the CPU (the
tests). Nothing moves a rank's tensors to another device or swaps the
backend on a failure.

Launch one process per card, with ``torchrun --nproc-per-node N`` (which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) or with explicit arguments, and call
:func:`init_distributed` first in each.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

# a rank that dies makes its peers' next collective raise after this long,
# instead of hanging
DEFAULT_TIMEOUT = timedelta(minutes=10)

_DEFAULT_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-axis data mesh: the process group (``None``: the default group),
    this process's rank in it, its size and this rank's device."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def _backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, and this torch build has none")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def make_mesh(device: Optional[torch.device | str] = None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of an initialised process group (default: the world).
    ``device`` defaults to the current CUDA device under NCCL and the CPU
    under gloo; a device that the group's backend does not serve raises."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call init_distributed first")
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if _backend_for(device) != backend:
        raise RuntimeError(f"a mesh on {device} needs the {_backend_for(device)} backend; "
                           f"the process group runs {backend}")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device)


def init_distributed(
    device: Optional[torch.device | str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout: timedelta = DEFAULT_TIMEOUT,
) -> Mesh:
    """Join the process group and return the world's mesh (the counterpart
    of ``initialize_multihost``). Arguments left ``None`` come from
    torchrun's environment: ``RANK``, ``WORLD_SIZE``, and ``LOCAL_RANK`` for
    the default device ``cuda:<LOCAL_RANK>``; ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``). ``device="cpu"`` runs
    gloo; a CUDA device runs NCCL (``"cuda"`` alone: ``cuda:<LOCAL_RANK>``),
    and without a card or NCCL this raises."""
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    backend = _backend_for(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)
    return make_mesh(device)


def get_mesh(mesh: Optional[Mesh] = None) -> Mesh:
    """The given mesh, the process default, or the world's mesh."""
    global _DEFAULT_MESH
    if mesh is not None:
        return mesh
    if _DEFAULT_MESH is None:
        _DEFAULT_MESH = make_mesh()
    return _DEFAULT_MESH


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _local_slice(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous part of a leading axis of ``n``; a world size
    that does not divide ``n`` raises (as the JAX package's ``device_put``
    of a batch does)."""
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} does not split over {mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(batch: Any, mesh: Optional[Mesh] = None) -> Any:
    """This rank's slice of each batched leaf of ``batch`` (tensors and
    arrays, in dicts, lists and tuples) as a tensor on the mesh's device;
    0-d leaves have no batch axis and are kept whole."""
    mesh = get_mesh(mesh)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if isinstance(x, (torch.Tensor, np.ndarray)):
            if x.ndim:
                x = x[_local_slice(len(x), mesh)]
            return torch.as_tensor(x).to(mesh.device)
        return x

    return one(batch)


def replicate(module: torch.nn.Module, mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from the mesh's rank 0
    in place, so that every rank starts from the same weights."""
    mesh = get_mesh(mesh)
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=mesh.group)
    return module


# -- collectives ----------------------------------------------------------------

def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def all_reduce_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a new tensor; no gradient)."""
    return all_reduce_(t.detach().clone(), mesh).div_(mesh.size)


def barrier(mesh: Mesh) -> None:
    """Returns once every rank has reached it: a one-element all-reduce whose
    value the host waits for (an NCCL collective alone returns before it
    runs)."""
    all_reduce_(torch.ones(1, device=mesh.device), mesh).item()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradients over
    the ranks too, so that each rank's gradient holds what every rank's
    loss sends it."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Concatenation of every rank's ``x`` along the leading axis, in rank
    order; the backward sums the gradient over the ranks and keeps this
    rank's rows (a reduce-scatter, which gloo lacks)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, size: int, rank: int) -> torch.Tensor:
        ctx.group, ctx.rank, ctx.n = group, rank, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:class:`_AllReduceSum` over the mesh, with gradient."""
    return _AllReduceSum.apply(x, mesh.group)


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """:class:`_AllGather` over the mesh, with gradient."""
    return _AllGather.apply(x, mesh.group, mesh.size, mesh.rank)


def average_gradients(params: Iterable[torch.nn.Parameter], mesh: Mesh) -> int:
    """Replace each parameter's gradient by its mean over the ranks: one
    flat all-reduce per dtype. Parameters without a gradient (frozen ones)
    are left out. Returns the bytes reduced."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    n_bytes = 0
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat, mesh).div_(mesh.size)
        n_bytes += flat.numel() * flat.element_size()
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return n_bytes
