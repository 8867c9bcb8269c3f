"""Shared conv building blocks (``cnmnet_tpu/models/layers.py``), NCHW.

The blocks are ``nn.Sequential``s laid out as the reference's torch
``Sequential``s, so their ``state_dict`` keys are the reference's own
(``conv1.0.weight``, ``conv1.1.running_mean``, ``upconv5.1.weight``,
``disp1.0.bias``, ...):

* ``ConvNormAct``: Conv2d (no bias, symmetric ``(k-1)//2`` padding), norm
  (``BatchNorm2d`` below: eps 1e-5, momentum 0.1, flax's biased running
  variance; or GroupNorm(32, eps 1e-5)), ReLU;
* ``DownConvBlock``: two of those, the second with stride 2 (indices 0-5);
* ``UpConvBlock``: bilinear x2 (half-pixel, ``align_corners=False``), then
  a ``ConvNormAct`` (indices 1-3);
* ``DispHead``: Conv2d with bias, sigmoid in f32, times ``scale``.

A conv over a concatenation is ``torch.cat`` + one conv, whose weight
covers the inputs' channels in order (the JAX package's ``MultiInConv``
splits it only for TPU lane alignment). Convolution weights start He-normal
with fan-out, drawn from the caller's ``torch.Generator``.

Training in bf16 (``set_compute_dtype``) is flax's ``dtype=bfloat16``: each
``Conv2d`` casts its input, weight and bias to bf16 at use, so the
parameters and their gradients stay f32; the norm layers keep f32
parameters and statistics and round only their output.

``remat(block, *inputs)`` runs a block under ``torch.utils.checkpoint``:
its activations are recomputed in the backward. The recompute's BatchNorm
statistics are thrown away, as flax's ``nn.remat`` throws away the
recompute's ``batch_stats``: a checkpointed block moves its running
statistics once per forward.

Under a data mesh (``parallel/sharding.data_parallel``) the train-mode
``BatchNorm2d`` takes its statistics over the global batch, as the JAX
step does, where GSPMD turns the batch means into psums.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cnmnet_tpu_torch.parallel.collectives import data_sum


@contextlib.contextmanager
def _recomputing(owner: nn.Module):
    """The checkpoint's recompute: ``owner``'s ``BatchNorm2d`` layers leave
    their running statistics alone while it runs."""
    norms = [m for m in owner.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def remat(fn, *inputs, owner: nn.Module = None):
    """``fn(*inputs)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant, so ``torch.autograd.grad``
    reaches the parameters). ``owner`` holds the modules ``fn`` runs
    (``fn`` itself when it is a module). The model draws no random
    numbers, so no RNG state is stashed."""
    owner = fn if owner is None else owner
    return checkpoint(fn, *inputs, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing(owner)))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` when one is set: the
    input, weight and bias are cast at use (flax's ``nn.Conv(dtype=...)``),
    and the parameters keep their own dtype. ``None`` computes in the
    weight's dtype, as ``nn.Conv2d`` does."""

    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Compute every ``Conv2d`` of ``model`` in ``dtype`` (``None``: in its
    weight's dtype) and record it as the model's ``compute_dtype``."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype
    model.compute_dtype = dtype
    return model


def _f32_or_wider(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in its own dtype where that is wider (f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class GroupNormF32(nn.GroupNorm):
    """GroupNorm that normalises in f32 and returns the input's dtype, as
    flax's GroupNorm does under bf16 compute (f32 statistics and params).
    PyTorch's BatchNorm normalises a bf16 input with f32 params in f32 by
    itself, but its CUDA GroupNorm refuses them ("expected scalar type
    BFloat16 but found Float"), so the input is cast up here."""

    def forward(self, x):
        return F.group_norm(_f32_or_wider(x), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode running variance is updated as flax's
    ``nn.BatchNorm`` updates it: with the *biased* batch variance
    ``E[x^2] - E[x]^2`` (clipped at 0, in f32), where ``nn.BatchNorm2d``
    takes the unbiased ``n / (n - 1)`` variance. The running mean moves as
    ``(1 - m) ra + m * mean``, the same products flax rounds. Normalisation
    is ``nn.BatchNorm2d``'s own (batch statistics in train mode, running
    statistics in eval mode); the parameters, buffers and ``state_dict``
    keys are unchanged. ``momentum=None`` keeps PyTorch's cumulative
    average.

    Inside a ``remat`` recompute the running statistics stay where the
    first pass left them. With ``group`` set (a data mesh's data group, by
    ``parallel/sharding.data_parallel``), train mode all-reduces the
    per-channel ``(sum x, sum x^2, n)`` over it, with a gradient through the
    all-reduce, and normalises flax's way, ``(x - mean) * (rsqrt(var + eps)
    * weight) + bias`` in f32, with the global mean and biased variance.
    ``nn.SyncBatchNorm`` is not used: it moves the running variance by the
    unbiased variance and refuses CPU tensors."""

    group = None
    recomputing = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._global_forward(x)
        with torch.no_grad():
            xf = _f32_or_wider(x.detach())
            mean = xf.mean((0, 2, 3))
            var = torch.clamp_min((xf * xf).mean((0, 2, 3)) - mean * mean, 0.0)
            self._track(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    @torch.no_grad()
    def _track(self, mean, var):
        if self.recomputing:
            return
        self.num_batches_tracked.add_(1)
        m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        self.running_mean.mul_(1.0 - m).add_(mean * m)
        self.running_var.mul_(1.0 - m).add_(var * m)

    def _global_forward(self, x):
        C = x.shape[1]
        xf = _f32_or_wider(x)
        n = xf.new_full((1,), float(x.numel() // C))
        sums = data_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), n]), self.group)
        count = sums[2 * C:].detach()
        mean = sums[:C] / count
        var = torch.clamp_min(sums[C:2 * C] / count - mean * mean, 0.0)
        self._track(mean.detach(), var.detach())
        shape = (1, C, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def _norm(norm: str, features: int) -> nn.Module:
    if norm == "batch":
        return BatchNorm2d(features, eps=1e-5, momentum=0.1)
    if norm == "group":
        return GroupNormF32(32, features, eps=1e-5)
    raise ValueError(f"unknown norm {norm!r}")


def _conv_norm_act(cin, features, kernel, stride=1, norm="batch"):
    return [
        Conv2d(cin, features, kernel, stride, padding=(kernel - 1) // 2, bias=False),
        _norm(norm, features),
        nn.ReLU(inplace=True),
    ]


class ConvNormAct(nn.Sequential):
    """conv (no bias) + norm + relu."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int = 1,
                 norm: str = "batch"):
        super().__init__(*_conv_norm_act(cin, features, kernel, stride, norm))


class DownConvBlock(nn.Sequential):
    """Two ConvNormActs, the second stride 2 (the reference's ``down_conv_layer``)."""

    def __init__(self, cin: int, features: int, kernel: int, norm: str = "batch"):
        super().__init__(
            *_conv_norm_act(cin, features, kernel, 1, norm),
            *_conv_norm_act(features, features, kernel, 2, norm),
        )


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with half-pixel centres (edge-clamped hat weights 1/4, 3/4)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2: ``out[i] = in[i // 2]``."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample2x(nn.Module):
    def forward(self, x):
        return upsample2x_bilinear(x)


class UpConvBlock(nn.Sequential):
    """Bilinear x2 + ConvNormAct (the reference's ``up_conv_layer``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, norm: str = "batch"):
        super().__init__(Upsample2x(), *_conv_norm_act(cin, features, kernel, 1, norm))


class DispHead(nn.Sequential):
    """3x3 conv (with bias) + sigmoid in f32 (f64 for an f64 model), times
    ``scale``."""

    def __init__(self, cin: int, scale: float):
        super().__init__(Conv2d(cin, 1, 3, padding=1, bias=True))
        self.scale = scale

    def forward(self, x):
        return self.scale * torch.sigmoid(_f32_or_wider(self[0](x)))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation of the JAX package: He-normal fan-out conv
    weights (std ``sqrt(2 / (k*k*out))``), zero conv biases, identity norms
    and fresh running statistics."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            with torch.no_grad():
                w = torch.empty(m.weight.shape).normal_(0.0, math.sqrt(2.0 / fan_out),
                                                        generator=generator)
                m.weight.copy_(w)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
