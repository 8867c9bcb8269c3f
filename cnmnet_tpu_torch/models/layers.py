"""Shared conv building blocks (``cnmnet_tpu/models/layers.py``), NCHW or
channels-last.

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

The blocks keep the memory layout their input arrives in: NCHW, or
channels-last (NHWC strides) with the conv weights converted once
(``model.to(memory_format=torch.channels_last)``, as a CUDA serving session
does), where cuDNN's convolutions and the upsamplings run NHWC kernels and
nothing is transposed; on the card a bilinear upsampling there that needs
no gradient is the hand kernel of ``kernels/upsample.py``
(``kernels/dispatch.upsample2x_bilinear``).
``torch.cat`` falls back to NCHW when one input is not channels-last by its
strides, as a 1-channel map made NCHW is, so such an input goes through
``like_layout`` first.

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

Under a tile axis (``parallel/sharding.spatial_parallel``) each rank holds
some rows of every map (``parallel/mesh.RowPlan``), and every layer that
reads across rows fetches the rows it reads (``sharding.Spatial``):

* ``Conv2d`` reads input rows ``s j - p ... s j - p + k - 1`` for output row
  ``j`` (stride ``s``, padding ``p``: asymmetric for stride 2), rows
  outside the image as zeros, and convolves them with no H padding;
* the x2 upsamplings read the coarse rows whose upsampling holds this
  rank's fine rows exactly (bilinear: one more row each side, edge-clamped
  at the image border as ``F.interpolate`` is; nearest: none) and keep
  those rows: the same arithmetic on the same values as the whole map;
* ``BatchNorm2d`` sums its statistics over the whole mesh (data and tile),
  ``GroupNormF32`` its per-sample ones over the tile group.

The per-shard pieces (``conv_rows``, ``upsample_rows``, ``batch_norm_*``,
``group_norm_*``) are pure functions, which the tests run for every shard in
one process; the layers add the collectives.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.parallel.collectives import all_reduce_


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
    weight's dtype, as ``nn.Conv2d`` does. With ``spatial`` set, the input
    is this rank's rows and so is the output (see the module docstring)."""

    compute_dtype = None
    spatial = None

    def forward(self, x):
        dt = self.compute_dtype
        if self.spatial is not None:
            k, s = self.kernel_size[0], self.stride[0]
            stage = f"Conv2d({self.in_channels}, {self.out_channels}, k={k}, stride={s})"
            return conv_rows(self, self.spatial.conv_input(x, k, s, stage))
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


def conv_rows(conv: Conv2d, rows: torch.Tensor) -> torch.Tensor:
    """``conv`` on the input rows its output rows read, its H padding
    included as rows: the conv with no H padding, in ``conv``'s compute
    dtype."""
    dt = conv.compute_dtype or conv.weight.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(rows.to(dt), conv.weight.to(dt), bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


def set_compute_dtype(model: nn.Module, dtype) -> nn.Module:
    """Compute every ``Conv2d`` of ``model`` in ``dtype`` (``None``: in its
    weight's dtype) and record it as the model's ``compute_dtype``."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = dtype
    model.compute_dtype = dtype
    return model


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether ``x`` ``[B, C, H, W]`` has NHWC strides, as ``torch.cat`` reads
    them: a 1-channel map only with the channels-last strides (it is dense
    in either layout)."""
    return x.dim() == 4 and x.stride(1) == 1 and x.is_contiguous(memory_format=torch.channels_last)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    return torch.channels_last if is_channels_last(x) else torch.contiguous_format


def like_layout(x: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``x`` in ``other``'s memory layout (NCHW or channels-last): ``x``
    itself where the two agree, else a copy."""
    if is_channels_last(x) == is_channels_last(other):
        return x
    return torch.empty_like(x, memory_format=_memory_format(other)).copy_(x)


def _f32_or_wider(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in its own dtype where that is wider (f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class GroupNormF32(nn.GroupNorm):
    """GroupNorm that normalises in f32 and returns the input's dtype, as
    flax's GroupNorm does under bf16 compute (f32 statistics and params).
    PyTorch's BatchNorm normalises a bf16 input with f32 params in f32 by
    itself, but its CUDA GroupNorm refuses them ("expected scalar type
    BFloat16 but found Float"), so the input is cast up here; the output
    takes the input's layout (the CUDA GroupNorm returns NCHW). With
    ``spatial`` set, each sample's statistics are summed over the tile
    group (``group_norm_partials``, ``group_norm_apply``)."""

    spatial = None

    def forward(self, x):
        if self.spatial is not None:
            sums = self.spatial.tile_sum(group_norm_partials(x, self.num_groups))
            return group_norm_apply(x, sums, self.weight, self.bias, self.eps)
        y = F.group_norm(_f32_or_wider(x), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype, memory_format=_memory_format(x))


def group_norm_partials(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Per sample and group ``(sum x, sum x^2, count)`` of a shard's rows,
    ``[B, groups, 3]``, in f32 or wider."""
    xf = _f32_or_wider(x).reshape(x.shape[0], groups, -1)
    n = xf.new_full(xf.shape[:2], float(xf.shape[-1]))
    return torch.stack([xf.sum(-1), (xf * xf).sum(-1), n], -1)


def group_norm_apply(x: torch.Tensor, sums: torch.Tensor, weight, bias, eps: float):
    """GroupNorm of a shard's rows given the whole image's per-sample sums
    (``group_norm_partials`` summed over the shards): biased variance, as
    ``F.group_norm``; returns the input's dtype."""
    B, C = x.shape[:2]
    G = sums.shape[1]
    count = sums[..., 2].detach()
    mean = sums[..., 0] / count
    var = torch.clamp_min(sums[..., 1] / count - mean * mean, 0.0)
    xf = _f32_or_wider(x).reshape(B, G, -1)
    y = ((xf - mean[..., None]) * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
    y = y * weight.view(1, C, 1, 1) + bias.view(1, C, 1, 1)
    return y.to(x.dtype)


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
    ``parallel/sharding.data_parallel``; the whole mesh's under a tile
    axis), train mode sums the per-channel ``(sum x, sum x^2, n)`` over it
    (``batch_norm_partials``; shards may hold different counts) and
    normalises flax's way, ``(x - mean) * (rsqrt(var + eps) * weight) +
    bias`` in f32, with the global mean and biased variance
    (``batch_norm_apply``). Its gradient is BatchNorm's own through the
    global statistics: the backward sums ``(sum g, sum g (x - mean))`` over
    the group (``batch_norm_grad_partials``, ``batch_norm_grad``), and only
    the input is kept for it, as ``F.batch_norm`` keeps it, not f32 copies.
    ``nn.SyncBatchNorm`` is not used: it moves the running variance by the
    unbiased variance and refuses CPU tensors."""

    group = None
    recomputing = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, self.group)
            self._track(mean, var)
            return y
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


def batch_norm_partials(x: torch.Tensor) -> torch.Tensor:
    """Per channel ``(sum x, sum x^2)`` of a shard and its count ``n``:
    ``[2 C + 1]`` in f32 or wider."""
    xf = _f32_or_wider(x)
    n = xf.new_full((1,), float(x.numel() // x.shape[1]))
    return torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), n])


def batch_norm_stats(sums: torch.Tensor):
    """``(mean, biased variance clipped at 0, unclipped variance, count)``
    from the summed partials."""
    C = (sums.shape[0] - 1) // 2
    count = sums[2 * C]
    mean = sums[:C] / count
    raw = sums[C:2 * C] / count - mean * mean
    return mean, torch.clamp_min(raw, 0.0), raw, count


def batch_norm_apply(x, mean, var, weight, bias, eps: float) -> torch.Tensor:
    """Flax's normalisation of a shard: ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` in f32 or wider, returned in the input's dtype."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * weight
    return ((_f32_or_wider(x) - mean.view(shape)) * mul.view(shape) + bias.view(shape)).to(x.dtype)


def batch_norm_grad_partials(grad: torch.Tensor, x: torch.Tensor, mean) -> torch.Tensor:
    """Per channel ``(sum g, sum g (x - mean))`` of a shard, ``[2 C]``."""
    g = _f32_or_wider(grad)
    xc = _f32_or_wider(x) - mean.view(1, -1, 1, 1)
    return torch.cat([g.sum((0, 2, 3)), (g * xc).sum((0, 2, 3))])


def batch_norm_grad(grad, x, mean, var, raw, weight, sums, count, eps: float) -> torch.Tensor:
    """The input gradient of ``batch_norm_apply`` with the statistics taken
    over every shard: ``w r (g - Sg / n - (x - mean) r^2 Sgx / n)``, ``r =
    rsqrt(var + eps)``, from the summed ``batch_norm_grad_partials`` ``sums``
    (no variance term where the unclipped variance ``raw`` is below 0)."""
    C = mean.shape[0]
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(var + eps)
    sg, sgx = sums[:C] / count, sums[C:] / count
    k = inv * inv * sgx * (raw >= 0).to(inv.dtype)
    xc = _f32_or_wider(x) - mean.view(shape)
    g = _f32_or_wider(grad)
    return ((g - sg.view(shape) - xc * k.view(shape)) * (weight * inv).view(shape)).to(x.dtype)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm with statistics summed over ``group``; returns
    ``(y, mean, biased variance)``, the last two without a gradient. The
    incoming gradient is this rank's, so the weight's and the bias's are
    this rank's shares, and the input's sums its two terms over the group
    (``parallel/collectives.py``'s convention)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        sums = all_reduce_(batch_norm_partials(x.detach()), group)
        mean, var, raw, count = batch_norm_stats(sums)
        y = batch_norm_apply(x.detach(), mean, var, weight.detach(), bias.detach(), eps)
        ctx.save_for_backward(x, weight, mean, var, raw)
        ctx.eps, ctx.group, ctx.count = eps, group, count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad, _mean, _var):
        x, weight, mean, var, raw = ctx.saved_tensors
        local = batch_norm_grad_partials(grad, x, mean)
        C = mean.shape[0]
        inv = torch.rsqrt(var + ctx.eps)
        gw = (local[C:] * inv).to(weight.dtype) if ctx.needs_input_grad[1] else None
        gb = local[:C].to(weight.dtype) if ctx.needs_input_grad[2] else None
        gx = None
        if ctx.needs_input_grad[0]:
            sums = all_reduce_(local.clone(), ctx.group)
            gx = batch_norm_grad(grad, x, mean, var, raw, weight, sums, ctx.count, ctx.eps)
        return gx, gw, gb, None, None


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


def _upsample(x: torch.Tensor, mode: str, backend=None) -> torch.Tensor:
    if mode == "bilinear":
        return dispatch.upsample2x_bilinear(x, backend)
    return F.interpolate(x, scale_factor=2, mode="nearest")


def upsample_rows(rows: torch.Tensor, first: int, out, mode: str) -> torch.Tensor:
    """Output rows ``out`` = ``[a, b)`` of a x2 upsampling from the coarse
    rows it reads (``rows``, from global row ``first``;
    ``mesh.upsample_input_rows``): the upsampling of those rows, cut to
    ``out``. Each kept row takes its taps inside ``rows``, or clamped at
    the image border as on the whole map."""
    a, b = out
    return _upsample(rows, mode, "torch").narrow(2, a - 2 * first, b - a)


def _upsample2x(x: torch.Tensor, mode: str, spatial, backend=None) -> torch.Tensor:
    if spatial is None:
        return _upsample(x, mode, backend)
    rows, first = spatial.upsample_input(x, mode, f"{mode} x2 upsampling")
    return upsample_rows(rows, first, spatial.rows(spatial.level(x.shape[-1]) - 1), mode)


def upsample2x_bilinear(x: torch.Tensor, spatial=None, backend=None) -> torch.Tensor:
    """Bilinear x2 with half-pixel centres (edge-clamped hat weights 1/4,
    3/4): ``kernels/dispatch.upsample2x_bilinear`` on ``backend``; with
    ``spatial``, of this rank's rows, through ``F.interpolate``."""
    return _upsample2x(x, "bilinear", spatial, backend)


def upsample2x_nearest(x: torch.Tensor, spatial=None) -> torch.Tensor:
    """Nearest x2: ``out[i] = in[i // 2]``; with ``spatial``, of this
    rank's rows."""
    return _upsample2x(x, "nearest", spatial)


class Upsample2x(nn.Module):
    spatial = None
    backend = None  # the kernel backend (kernels/dispatch); CNMModel.cv_backend sets it

    def forward(self, x):
        return upsample2x_bilinear(x, self.spatial, self.backend)


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
