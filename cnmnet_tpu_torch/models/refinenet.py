"""DepthRefineNet: occlusion-aware fusion of two inverse-depth hypotheses.

Counterpart of ``cnmnet_tpu/models/refinenet.py``, NCHW, with the
reference's flat submodule names (``conv1..3``,
``{upconv,iconv}{3,2,1}_{depth,prob}``, ``disp_refine``, ``prob``):

* input: cat(idepth01, idepth02, |idepth01 - idepth02|, iconv01 + iconv02)
  = 67 channels;
* a shared stride-2 encoder 128, 256, 512 (kernel 3);
* two decoder branches with the 256/128 encoder skips, one ending in the
  refined inverse depth (sigmoid x ``idepth_scale``), the other in the
  occlusion probability (sigmoid);
* ``remat``: the three encoder blocks and both decoder branches (heads
  included, as the JAX ``_DecoderBranch``) are recomputed in the backward
  (``layers.remat``), the JAX ``DepthRefineNet.remat``; the ``state_dict``
  keys are the same either way.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from cnmnet_tpu_torch.models.layers import (
    ConvNormAct,
    DispHead,
    DownConvBlock,
    UpConvBlock,
    remat,
)

BRANCHES = ("depth", "prob")


class DepthRefineNet(nn.Module):
    def __init__(self, idepth_scale: float = 3.0, norm: str = "batch", remat: bool = False):
        super().__init__()
        self.remat = bool(remat)
        self.conv1 = DownConvBlock(67, 128, 3, norm)
        self.conv2 = DownConvBlock(128, 256, 3, norm)
        self.conv3 = DownConvBlock(256, 512, 3, norm)
        for tag in BRANCHES:
            setattr(self, f"upconv3_{tag}", UpConvBlock(512, 256, 3, norm))
            setattr(self, f"iconv3_{tag}", ConvNormAct(512, 256, 3, norm=norm))
            setattr(self, f"upconv2_{tag}", UpConvBlock(256, 128, 3, norm))
            setattr(self, f"iconv2_{tag}", ConvNormAct(256, 128, 3, norm=norm))
            setattr(self, f"upconv1_{tag}", UpConvBlock(128, 64, 3, norm))
            setattr(self, f"iconv1_{tag}", ConvNormAct(64, 64, 3, norm=norm))
        self.disp_refine = DispHead(64, idepth_scale)
        self.prob = DispHead(64, 1.0)

    def _branch(self, tag, head, conv1, conv2, conv3):
        m = lambda name: getattr(self, f"{name}_{tag}")  # noqa: E731
        iconv3 = m("iconv3")(torch.cat([m("upconv3")(conv3), conv2], 1))
        iconv2 = m("iconv2")(torch.cat([m("upconv2")(iconv3), conv1], 1))
        return head(m("iconv1")(m("upconv1")(iconv2)))

    def _run(self, fn, *inputs):
        return remat(fn, *inputs, owner=self) if self.remat else fn(*inputs)

    def forward(self, idepth01, idepth02, iconv01, iconv02):
        """``idepth0*`` ``[B, 1, H, W]``, ``iconv0*`` ``[B, 64, H, W]`` ->
        (refined inverse depth, occlusion probability), each ``[B, 1, H, W]`` f32."""
        dt = iconv01.dtype
        diff = (idepth01 - idepth02).abs()
        x = torch.cat([idepth01.to(dt), idepth02.to(dt), diff.to(dt), iconv01 + iconv02], 1)
        conv1 = self._run(self.conv1, x)
        conv2 = self._run(self.conv2, conv1)
        conv3 = self._run(self.conv3, conv2)
        depth = functools.partial(self._branch, "depth", self.disp_refine)
        prob = functools.partial(self._branch, "prob", self.prob)
        return self._run(depth, conv1, conv2, conv3), self._run(prob, conv1, conv2, conv3)
