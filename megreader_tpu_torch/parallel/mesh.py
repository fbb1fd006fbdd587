"""Data parallelism over ``torch.distributed``: the JAX package's
``parallel/mesh.py`` for one process a card.

JAX's mesh is an SPMD device grid whose ``'data'`` axis splits each batch;
here a :class:`Mesh` names this process's place in a process group: its
rank, the world size, its device and the group. NCCL serves the card and
gloo the CPU. The JAX package's global batch is the ranks' local batches
stacked in rank order (``jax.make_array_from_process_local_data`` over a
``P('data')`` sharding), which is what :func:`all_gather_batch` rebuilds;
a rank's share of a global batch is its contiguous block
(:func:`batch_sharding`).

Under SPMD the JAX step's loss, gradient and BatchNorm statistics are the
global batch's. The losses reduce over the batch through :func:`batch_sum`
and :func:`batch_mean`, which within :func:`global_batch` sum across the
ranks, so every rank holds the global batch's loss; ``train/train_step.py``
back-propagates it and all-reduces the gradients, and
``models/resnet.py::BatchNorm2d`` reduces its sums across the group (see
:func:`sync_batch_norm`).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn


@dataclass
class Mesh:
    """This process's rank, the world size, its device, and the process
    group (None in a single process with no group)."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None


def init_mesh(init_method: str, world_size: int, rank: int, device="cuda") -> Mesh:
    """Join a process group (``init_method`` such as ``tcp://localhost:PORT``
    or ``file:///path``) with NCCL for a card and gloo for the CPU, and
    return its mesh. ``device`` 'cuda' takes the card of the local rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size, rank=rank)
    return make_mesh(device)


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the default process group, or a world of one on
    ``device`` when no group is up. The default is the card, as for
    ``init_mesh``; without one it raises (pass ``"cpu"`` for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for the CPU)")
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_rank(), dist.get_world_size(), device, dist.group.WORLD)
    return Mesh(0, 1, device)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of a leading axis of ``n`` (JAX's
    ``P('data')``; ``n`` must split evenly, as there)."""
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} does not split over {mesh.world_size} ranks")
    per = n // mesh.world_size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(module: nn.Module, mesh: Mesh) -> nn.Module:
    """``module`` with rank 0's parameters and buffers on every rank (JAX's
    ``P()``), in place."""
    if mesh.group is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0, group=mesh.group)
    return module


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """A rank's batch on its device: array leaves (numpy arrays and tensors
    of at least one axis) move there; other entries (texts, polygon lists)
    stay on the host."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            out[k] = torch.as_tensor(v).to(mesh.device)
        elif isinstance(v, torch.Tensor) and v.ndim >= 1:
            out[k] = v.to(mesh.device)
        else:
            out[k] = v
    return out


def all_gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal-shape ``x`` stacked along the leading axis in rank
    order (bool travels as uint8: gloo gathers no bool)."""
    if mesh.group is None:
        return x
    y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(y) for _ in range(mesh.world_size)]
    dist.all_gather(parts, y, group=mesh.group)
    out = torch.cat(parts, 0)
    return out.bool() if x.dtype == torch.bool else out


def all_reduce_sum_(tensors: List[torch.Tensor], mesh: Mesh) -> None:
    """Sum ``tensors`` across the ranks in place, one collective per dtype."""
    if mesh.group is None or not tensors:
        return
    for dt in {t.dtype for t in tensors}:
        same = [t for t in tensors if t.dtype == dt]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=mesh.group)
        off = 0
        for t in same:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """The sum across the ranks, whose gradient is the sum of the ranks'
    gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed across the ranks of ``group``, differentiably."""
    return _AllReduceSum.apply(x, group)


#: the group the losses' batch reductions sum across (None: this rank's batch)
_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_group", default=None)


@contextlib.contextmanager
def global_batch(mesh: Optional[Mesh]):
    """Within the block, :func:`batch_sum` and :func:`batch_mean` reduce over
    the global batch of ``mesh``'s ranks (a world of one, or no mesh, keeps
    the local batch)."""
    group = mesh.group if mesh is not None and mesh.world_size > 1 else None
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's batch, summed over the global batch
    (differentiably: the gradient of the sum reaches every rank's terms)."""
    group = _BATCH_GROUP.get()
    return x if group is None else all_reduce_sum(x, group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of per-sample values ``x`` (B,) over the global batch."""
    group = _BATCH_GROUP.get()
    if group is None:
        return x.mean()
    total = all_reduce_sum(torch.stack([x.sum(), x.new_tensor(float(x.shape[0]))]), group)
    return total[0] / total[1]


def sync_batch_norm(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Point every ``BatchNorm2d`` of ``module`` at the mesh's group, so that
    train mode takes the statistics of the global batch (a world of one
    keeps its own); returns the module."""
    from ..models.resnet import BatchNorm2d

    group = mesh.group if mesh.world_size > 1 else None
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = group
    return module


def is_primary(mesh: Optional[Mesh] = None) -> bool:
    """Rank 0 (the only process when no group is up): it logs and saves."""
    if mesh is not None:
        return mesh.rank == 0
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (``dist.barrier``) when the world size is above 1."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
