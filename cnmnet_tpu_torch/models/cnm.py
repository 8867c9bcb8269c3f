"""CNMModel: cost volume + DepthNet + DepthRefineNet in one module.

Counterpart of ``cnmnet_tpu/models/cnm.py``, covering the same protocols:

* 3 views: the two (ref, src) pairs are folded into one batch of 2B for the
  cost volume and DepthNet, then refined;
* 2 views (S = 1) or ``use_refiner=False``: DepthNet only;
* 5 / 7 views: S sources folded into the batch, even-index sources averaged
  into hypothesis 1 and odd-index sources into hypothesis 2, then refined.

Inputs and outputs keep the JAX package's layouts (images ``[B, V, H, W,
3]``, cams ``[B, V, 2, 4, 4]``, NHWC outputs); the convolutions run NCHW
and the outputs are NHWC views of their results. The module computes in
the dtype of its parameters (``model.to(torch.bfloat16)`` for bf16
compute); the cost volume is written in that dtype and the disparity heads
return f32.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch import nn

from cnmnet_tpu_torch.geometry.camera import camera_from_array
from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.models.depthnet import DepthNet
from cnmnet_tpu_torch.models.refinenet import DepthRefineNet


class CNMOutputs(NamedTuple):
    """disps: 4 scales, each [B, S, h, w, 1] per source pair;
    iconv: [B, S, H, W, 64];
    idepth_g1/g2: the group-averaged full-res disparities fed to the refiner
    (None when S == 1);
    idepth_refined, prob_map: [B, H, W, 1] (None when S == 1)."""

    disps: List[torch.Tensor]
    iconv: torch.Tensor
    idepth_g1: Optional[torch.Tensor]
    idepth_g2: Optional[torch.Tensor]
    idepth_refined: Optional[torch.Tensor]
    prob_map: Optional[torch.Tensor]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class CNMModel(nn.Module):
    def __init__(
        self,
        idepth_scale: float = 3.0,
        num_planes: int = 64,
        norm: str = "batch",
        cv_backend: Optional[str] = None,
        sampling: str = "exact",
        use_refiner: bool = True,
    ):
        super().__init__()
        self.idepth_scale = idepth_scale
        self.num_planes = num_planes
        self.cv_backend = cv_backend
        self.sampling = sampling
        self.use_refiner = use_refiner
        self.depth_net = DepthNet(idepth_scale, num_planes, norm)
        self.refine_net = DepthRefineNet(idepth_scale, norm) if use_refiner else None

    def forward(self, images: torch.Tensor, cams: torch.Tensor) -> CNMOutputs:
        """images: [B, V, H, W, 3] normalised float (view 0 = reference);
        cams: [B, V, 2, 4, 4]."""
        B, V, H, W, C = images.shape
        S = V - 1
        if S < 1:
            raise ValueError(f"need at least one source view, got V={V}")
        dt = self.depth_net.conv1[0].weight.dtype

        # Fold sources into the batch: pair i of sample b sits at b * S + i.
        ref = images[:, 0].repeat_interleave(S, 0)
        src = images[:, 1:].reshape(B * S, H, W, C)
        ref_cam = camera_from_array(cams[:, 0].repeat_interleave(S, 0))
        src_cam = camera_from_array(cams[:, 1:].reshape(B * S, 2, 4, 4))
        volume = dispatch.cost_volume(
            ref, src, ref_cam, src_cam, self.idepth_scale, self.num_planes,
            backend=self.cv_backend, sampling=self.sampling, out_dtype=dt,
        )  # [B*S, H, W, P], a view of [B*S, P, H, W]

        disps, iconv = self.depth_net(
            ref.permute(0, 3, 1, 2).to(dt), volume.permute(0, 3, 1, 2)
        )
        disps_unfold = [
            _nhwc(d).reshape(B, S, d.shape[2], d.shape[3], 1) for d in disps
        ]
        iconv_unfold = _nhwc(iconv).reshape(B, S, H, W, iconv.shape[1])
        if S == 1 or self.refine_net is None:
            return CNMOutputs(disps_unfold, iconv_unfold, None, None, None, None)

        # Group-average: even-index sources -> hypothesis 1, odd -> hypothesis 2.
        d1 = disps[0].reshape(B, S, 1, H, W)
        ic = iconv.reshape(B, S, iconv.shape[1], H, W)
        g1, g2 = d1[:, 0::2].mean(1), d1[:, 1::2].mean(1)
        c1, c2 = ic[:, 0::2].mean(1), ic[:, 1::2].mean(1)
        idepth_refined, prob_map = self.refine_net(g1, g2, c1, c2)
        return CNMOutputs(
            disps_unfold, iconv_unfold, _nhwc(g1), _nhwc(g2),
            _nhwc(idepth_refined), _nhwc(prob_map),
        )
