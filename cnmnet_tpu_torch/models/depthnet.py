"""DepthNet: plane-sweep hourglass regressing multi-scale inverse depth.

Counterpart of ``cnmnet_tpu/models/depthnet.py``, NCHW, with the
reference's submodule names:

* input: cat(ref RGB, P-plane cost volume) = 3 + P channels;
* encoder ``conv1..conv5``: stride-2 double convs 128, 256, 512, 512, 512
  with kernels 7, 5, 3, 3, 3;
* decoder ``upconv5..1`` / ``iconv5..1`` with the encoder skips and the
  nearest-upsampled coarser disparity concatenated in the JAX package's
  order (1024, 1024, 513, 257, 65 input channels), and the sigmoid heads
  ``disp4..disp1`` scaled by ``idepth_scale``;
* under a tile axis each map holds this rank's rows; the skip
  concatenations meet on the same rows because every layer writes the rows
  of ``parallel/mesh.RowPlan`` at its level (the upsamplings read the coarse
  rows they need from their owners);
* ``remat``: the first ``remat`` encoder stages (0-5, from the input side,
  where the activations are largest) are recomputed in the backward
  (``layers.remat``), the JAX ``DepthNet.remat``. The submodules and their
  ``state_dict`` keys are the same either way.
"""

from __future__ import annotations

import torch
from torch import nn

from cnmnet_tpu_torch.models.layers import (
    ConvNormAct,
    DispHead,
    DownConvBlock,
    UpConvBlock,
    remat,
    upsample2x_nearest,
)


class DepthNet(nn.Module):
    spatial = None  # this rank's rows under a tile axis (parallel/sharding.spatial_parallel)

    def __init__(self, idepth_scale: float = 3.0, num_planes: int = 64, norm: str = "batch",
                 remat: int = 0):
        super().__init__()
        self.remat = int(remat)
        s = idepth_scale
        self.conv1 = DownConvBlock(3 + num_planes, 128, 7, norm)
        self.conv2 = DownConvBlock(128, 256, 5, norm)
        self.conv3 = DownConvBlock(256, 512, 3, norm)
        self.conv4 = DownConvBlock(512, 512, 3, norm)
        self.conv5 = DownConvBlock(512, 512, 3, norm)
        self.upconv5 = UpConvBlock(512, 512, 3, norm)
        self.iconv5 = ConvNormAct(1024, 512, 3, norm=norm)
        self.upconv4 = UpConvBlock(512, 512, 3, norm)
        self.iconv4 = ConvNormAct(1024, 512, 3, norm=norm)
        self.disp4 = DispHead(512, s)
        self.upconv3 = UpConvBlock(512, 256, 3, norm)
        self.iconv3 = ConvNormAct(513, 256, 3, norm=norm)
        self.disp3 = DispHead(256, s)
        self.upconv2 = UpConvBlock(256, 128, 3, norm)
        self.iconv2 = ConvNormAct(257, 128, 3, norm=norm)
        self.disp2 = DispHead(128, s)
        self.upconv1 = UpConvBlock(128, 64, 3, norm)
        self.iconv1 = ConvNormAct(65, 64, 3, norm=norm)
        self.disp1 = DispHead(64, s)

    def forward(self, ref_image: torch.Tensor, cost_volume: torch.Tensor):
        """``ref_image`` ``[B, 3, H, W]``, ``cost_volume`` ``[B, P, H, W]``, both
        in the compute dtype -> ([disp1..disp4] each ``[B, 1, h, w]`` f32 at
        1/2^(k-1) resolution, iconv1 ``[B, 64, H, W]``)."""
        dt = ref_image.dtype
        x = torch.cat([ref_image, cost_volume], 1)
        stages = []
        for i, block in enumerate((self.conv1, self.conv2, self.conv3, self.conv4, self.conv5)):
            x = remat(block, x) if i < self.remat else block(x)
            stages.append(x)
        conv1, conv2, conv3, conv4, conv5 = stages

        iconv5 = self.iconv5(torch.cat([self.upconv5(conv5), conv4], 1))
        iconv4 = self.iconv4(torch.cat([self.upconv4(iconv5), conv3], 1))
        disp4 = self.disp4(iconv4)

        udisp4 = upsample2x_nearest(disp4, self.spatial).to(dt)
        iconv3 = self.iconv3(torch.cat([self.upconv3(iconv4), conv2, udisp4], 1))
        disp3 = self.disp3(iconv3)

        udisp3 = upsample2x_nearest(disp3, self.spatial).to(dt)
        iconv2 = self.iconv2(torch.cat([self.upconv2(iconv3), conv1, udisp3], 1))
        disp2 = self.disp2(iconv2)

        udisp2 = upsample2x_nearest(disp2, self.spatial).to(dt)
        iconv1 = self.iconv1(torch.cat([self.upconv1(iconv2), udisp2], 1))
        disp1 = self.disp1(iconv1)
        return [disp1, disp2, disp3, disp4], iconv1
