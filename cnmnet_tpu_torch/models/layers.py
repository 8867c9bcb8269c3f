"""Shared conv building blocks (``cnmnet_tpu/models/layers.py``), NCHW.

The blocks are ``nn.Sequential``s laid out as the reference's torch
``Sequential``s, so their ``state_dict`` keys are the reference's own
(``conv1.0.weight``, ``conv1.1.running_mean``, ``upconv5.1.weight``,
``disp1.0.bias``, ...):

* ``ConvNormAct``: Conv2d (no bias, symmetric ``(k-1)//2`` padding), norm
  (BatchNorm eps 1e-5, momentum 0.1; or GroupNorm(32, eps 1e-5)), ReLU;
* ``DownConvBlock``: two of those, the second with stride 2 (indices 0-5);
* ``UpConvBlock``: bilinear x2 (half-pixel, ``align_corners=False``), then
  a ``ConvNormAct`` (indices 1-3);
* ``DispHead``: Conv2d with bias, sigmoid in f32, times ``scale``.

A conv over a concatenation is ``torch.cat`` + one conv, whose weight
covers the inputs' channels in order (the JAX package's ``MultiInConv``
splits it only for TPU lane alignment). Convolution weights start He-normal
with fan-out, drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _norm(norm: str, features: int) -> nn.Module:
    if norm == "batch":
        return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
    if norm == "group":
        return nn.GroupNorm(32, features, eps=1e-5)
    raise ValueError(f"unknown norm {norm!r}")


def _conv_norm_act(cin, features, kernel, stride=1, norm="batch"):
    return [
        nn.Conv2d(cin, features, kernel, stride, padding=(kernel - 1) // 2, bias=False),
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
    """3x3 conv (with bias) + sigmoid in f32, times ``scale``."""

    def __init__(self, cin: int, scale: float):
        super().__init__(nn.Conv2d(cin, 1, 3, padding=1, bias=True))
        self.scale = scale

    def forward(self, x):
        return self.scale * torch.sigmoid(self[0](x).float())


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
