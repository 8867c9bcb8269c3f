"""Sums and gathers over a named group of ranks: a mesh's whole group, its
data group or its tile group (``parallel/mesh.Mesh``), what GSPMD makes
of a reduction or a reshard under the JAX package's mesh.

* ``group_sum``: a tensor summed over the group with a gradient through
  the sum. The backward all-reduces the incoming gradients, so when every
  rank computes the same global loss, each rank's gradient is the group's
  size times its own share, and the mean over the ranks is the global
  gradient (``train/loop.py``).
* ``group_count``: a count or flag summed over the group, with no gradient.
* ``all_reduce_``, ``all_gather``, ``broadcast_``: the plain collectives.

A group of None is this rank alone: the sums return their input. On a gloo
group a CUDA tensor crosses through host memory (copied to the CPU, the
collective run there, copied back): gloo has no CUDA ``all_gather``, and
NCCL refuses two ranks on one card, so this is how ranks that share a
card exchange. On NCCL the tensor stays on its card. The module imports
only ``torch.distributed``, so the loss ops and the layers take it without
the mesh and the tiled kernels above them.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` over ``group`` in place."""
    if _via_host(x, group):
        host = x.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        return x.copy_(host)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (one shape on all ranks), in group rank order."""
    x = x.contiguous()
    src = x.cpu() if _via_host(x, group) else x
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(x.device) for p in parts] if src is not x else parts


def broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` from global rank ``src`` of ``group``, in place."""
    if _via_host(x, group):
        host = x.cpu()
        dist.broadcast(host, src, group=group)
        return x.copy_(host)
    dist.broadcast(x, src, group=group)
    return x


class _GroupSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: this rank alone), with a gradient
    through the sum (see the module docstring)."""
    return x if group is None else _GroupSum.apply(x, group)


def group_count(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` with no gradient: counts and flags."""
    x = x.detach().clone()
    return x if group is None else all_reduce_(x, group)
