"""Sums over a data group, what GSPMD makes of a batch reduction under a
data mesh (``cnmnet_tpu/parallel/sharding.py``'s batch sharding).

* ``data_sum``: a tensor summed over the group with a gradient through the
  sum. The backward all-reduces the incoming gradients, so when every
  rank computes the same global loss, each rank's gradient is ``world``
  times its samples' share and the mean over ranks is the global gradient.
* ``data_count``: a count or flag summed over the group, with no gradient.

A group of None is this rank alone: both return their input. The module
imports only ``torch.distributed``, so the loss ops and the layers take it
without the mesh and the tiled kernels above them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _DataSum(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def data_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (None: this rank alone), with a gradient
    through the sum (see the module docstring)."""
    return x if group is None else _DataSum.apply(x, group)


def data_count(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` with no gradient: counts and flags."""
    x = x.detach().clone()
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x
