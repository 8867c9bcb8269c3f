"""Plain PyTorch reference of the CNMNet forward, inference mode.

A functional forward over a state dict whose keys are the reference
implementation's (``depth_net.conv1.0.weight``, ``refine_net.iconv3_depth.1.
running_mean``, ...), float32, with every convolution a plain
``F.conv2d`` and every norm a ``F.batch_norm`` on running statistics. The
caller turns TF32 off (``exact_float32``). Nothing here imports the program.

The net (CNMNet, arXiv 2004.00845; ``depthNet_model.py`` and
``refinenet_model.py`` of the reference implementation):

* each of the ``S`` (reference, source) pairs gets a ``P``-plane cost
  volume; DepthNet reads ``cat(reference RGB, volume)``: an encoder of
  stride-2 double convs 128, 256, 512, 512, 512 (kernels 7, 5, 3, 3, 3),
  a decoder of bilinear x2 up-convs with the encoder skips and the nearest
  x2 coarser disparity, sigmoid disparity heads times ``idepth_scale`` at
  1/8, 1/4, 1/2 and full resolution;
* the full-resolution disparities and the last decoder features are
  averaged over the even-index sources and over the odd-index ones, and
  the RefineNet fuses the two hypotheses: ``cat(d1, d2, |d1 - d2|, f1 +
  f2)``, a shared encoder 128, 256, 512, and two decoder branches ending in
  the refined inverse depth (sigmoid times ``idepth_scale``) and the
  occlusion probability (sigmoid);
* depth is ``1 / (idepth + 1e-8)`` and the normals are its ``k x k`` plane
  fit (``geometry.depth_to_normal``).

``precision`` rounds every convolution's input and weight before the float32
convolution: to TF32 or bfloat16, or to float8 e4m3 with a per-tensor scale.
That is how the reference is computed in the precision the configuration
states, and one step below it for the control.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from benchmark.reference import geometry

FP8_MAX = 448.0


def conv_layers(planes: int):
    """Every convolution of the net: ``(name, in, out, kernel, stride, level,
    head)``, where ``level`` is the output's size divisor (1 = full
    resolution) and ``head`` marks the disparity heads (a bias, no norm).
    Every other convolution is followed by a batch norm at index + 1."""
    out = []

    def down(prefix, cin, cout, k, level):
        out.append((f"{prefix}.0", cin, cout, k, 1, level, False))
        out.append((f"{prefix}.3", cout, cout, k, 2, 2 * level, False))

    def up(prefix, cin, cout, level):
        out.append((f"{prefix}.1", cin, cout, 3, 1, level, False))

    def conv(name, cin, cout, level, head=False):
        out.append((name, cin, cout, 3, 1, level, head))

    d = "depth_net"
    for i, (cin, cout, k) in enumerate(((3 + planes, 128, 7), (128, 256, 5), (256, 512, 3),
                                        (512, 512, 3), (512, 512, 3))):
        down(f"{d}.conv{i + 1}", cin, cout, k, 2 ** i)
    up(f"{d}.upconv5", 512, 512, 16)
    conv(f"{d}.iconv5.0", 1024, 512, 16)
    up(f"{d}.upconv4", 512, 512, 8)
    conv(f"{d}.iconv4.0", 1024, 512, 8)
    conv(f"{d}.disp4.0", 512, 1, 8, head=True)
    for i, cin, cout, level in ((3, 512, 256, 4), (2, 256, 128, 2), (1, 128, 64, 1)):
        up(f"{d}.upconv{i}", cin, cout, level)
        skip = {3: 256, 2: 128, 1: 0}[i]
        conv(f"{d}.iconv{i}.0", cout + skip + 1, cout, level)
        conv(f"{d}.disp{i}.0", cout, 1, level, head=True)
    r = "refine_net"
    for i, (cin, cout) in enumerate(((67, 128), (128, 256), (256, 512))):
        down(f"{r}.conv{i + 1}", cin, cout, 3, 2 ** i)
    for tag in ("depth", "prob"):
        for i, cin, cout, level in ((3, 512, 256, 4), (2, 256, 128, 2), (1, 128, 64, 1)):
            up(f"{r}.upconv{i}_{tag}", cin, cout, level)
            conv(f"{r}.iconv{i}_{tag}.0", 2 * cout if i > 1 else cout, cout, level)
    conv(f"{r}.disp_refine.0", 64, 1, 1, head=True)
    conv(f"{r}.prob.0", 64, 1, 1, head=True)
    return out


def rounder(precision: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding applied to every conv operand: ``None`` (float32),
    ``"tf32"`` (10 mantissa bits, as the tensor cores read float32),
    ``"bfloat16"`` or ``"float8"`` (e4m3, scaled per tensor to its range).
    The convolution itself then runs in exact float32."""
    if precision is None or precision == "float32":
        return lambda x: x
    if precision == "tf32":
        def tf32(x):
            bits = x.contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return tf32
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if precision == "float8":
        def fp8(x):
            scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
            return (x * scale).to(torch.float8_e4m3fn).float() / scale
        return fp8
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN convolutions and matrix products, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class Net:
    def __init__(self, state: Dict[str, torch.Tensor], precision: Optional[str] = None):
        self.sd = state
        self.q = rounder(precision)

    def conv(self, x, name, stride=1, bias=False):
        w = self.sd[f"{name}.weight"].float()
        b = self.sd[f"{name}.bias"].float() if bias else None
        return F.conv2d(self.q(x), self.q(w), b, stride, (w.shape[-1] - 1) // 2)

    def cna(self, x, prefix, i=0, stride=1):
        """conv (no bias) -> batch norm (running statistics) -> ReLU."""
        y = self.conv(x, f"{prefix}.{i}", stride)
        n = f"{prefix}.{i + 1}"
        y = F.batch_norm(y, self.sd[f"{n}.running_mean"].float(),
                         self.sd[f"{n}.running_var"].float(), self.sd[f"{n}.weight"].float(),
                         self.sd[f"{n}.bias"].float(), False, 0.0, 1e-5)
        return F.relu(y)

    def down(self, x, prefix):
        return self.cna(self.cna(x, prefix, 0), prefix, 3, stride=2)

    def up(self, x, prefix):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return self.cna(x, prefix, 1)

    def head(self, x, name, scale):
        return scale * torch.sigmoid(self.conv(x, f"{name}.0", bias=True))

    def depth_net(self, ref, volume, s):
        p = "depth_net"
        x = torch.cat([ref, volume], 1)
        c1 = self.down(x, f"{p}.conv1")
        c2 = self.down(c1, f"{p}.conv2")
        c3 = self.down(c2, f"{p}.conv3")
        c4 = self.down(c3, f"{p}.conv4")
        c5 = self.down(c4, f"{p}.conv5")
        i5 = self.cna(torch.cat([self.up(c5, f"{p}.upconv5"), c4], 1), f"{p}.iconv5")
        i4 = self.cna(torch.cat([self.up(i5, f"{p}.upconv4"), c3], 1), f"{p}.iconv4")
        d4 = self.head(i4, f"{p}.disp4", s)
        u4 = F.interpolate(d4, scale_factor=2, mode="nearest")
        i3 = self.cna(torch.cat([self.up(i4, f"{p}.upconv3"), c2, u4], 1), f"{p}.iconv3")
        d3 = self.head(i3, f"{p}.disp3", s)
        u3 = F.interpolate(d3, scale_factor=2, mode="nearest")
        i2 = self.cna(torch.cat([self.up(i3, f"{p}.upconv2"), c1, u3], 1), f"{p}.iconv2")
        d2 = self.head(i2, f"{p}.disp2", s)
        u2 = F.interpolate(d2, scale_factor=2, mode="nearest")
        i1 = self.cna(torch.cat([self.up(i2, f"{p}.upconv1"), u2], 1), f"{p}.iconv1")
        return self.head(i1, f"{p}.disp1", s), i1

    def refine_net(self, d1, d2, f1, f2, s):
        p = "refine_net"
        x = torch.cat([d1, d2, (d1 - d2).abs(), f1 + f2], 1)
        c1 = self.down(x, f"{p}.conv1")
        c2 = self.down(c1, f"{p}.conv2")
        c3 = self.down(c2, f"{p}.conv3")
        out = []
        for tag, head, scale in (("depth", "disp_refine", s), ("prob", "prob", 1.0)):
            i3 = self.cna(torch.cat([self.up(c3, f"{p}.upconv3_{tag}"), c2], 1), f"{p}.iconv3_{tag}")
            i2 = self.cna(torch.cat([self.up(i3, f"{p}.upconv2_{tag}"), c1], 1), f"{p}.iconv2_{tag}")
            i1 = self.cna(self.up(i2, f"{p}.upconv1_{tag}"), f"{p}.iconv1_{tag}")
            out.append(self.head(i1, f"{p}.{head}", scale))
        return out


def normals(idepth: torch.Tensor, cams: torch.Tensor, k: int,
            fit_dtype=torch.float32) -> torch.Tensor:
    """Normals ``[B, H, W, 3]`` of the depth ``1 / (idepth + 1e-8)`` (f32),
    fitted in ``fit_dtype``."""
    depth = 1.0 / (idepth.float() + 1e-8)
    K_inv = geometry.inverse_intrinsics(cams[:, 0, 1, :3, :3])
    return geometry.depth_to_normal(depth.to(fit_dtype), K_inv.to(fit_dtype), k).float()


def forward(state: Dict[str, torch.Tensor], images: torch.Tensor, cams: torch.Tensor,
            model: dict, precision: Optional[str] = None,
            fit_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``images`` ``[B, V, H, W, 3]`` (uint8, or normalised float32), ``cams``
    ``[B, V, 2, 4, 4]``, ``model`` the configuration's ``model`` group ->
    ``idepth``, ``depth``, ``prob`` ``[B, H, W]`` and ``normal`` ``[B, H, W, 3]``,
    float32, for ``V >= 3``. ``precision`` rounds the convolutions' operands
    (``rounder``), ``fit_dtype`` is the normals' fit."""
    B, V, H, W, _ = images.shape
    S = V - 1
    s, P, k = float(model["idepth_scale"]), int(model["num_planes"]), int(model["k_size"])
    x = geometry.normalize(images) if images.dtype == torch.uint8 else images.float()
    cams = cams.float()
    net = Net(state, precision)
    with torch.no_grad():
        ref = x[:, 0].repeat_interleave(S, 0)
        src = x[:, 1:].reshape(B * S, H, W, 3)
        volume = geometry.cost_volume(ref, src, cams[:, 0].repeat_interleave(S, 0),
                                      cams[:, 1:].reshape(B * S, 2, 4, 4), s, P)
        disp, feat = net.depth_net(ref.permute(0, 3, 1, 2), volume, s)
        disp = disp.reshape(B, S, 1, H, W)
        feat = feat.reshape(B, S, feat.shape[1], H, W)
        idepth, prob = net.refine_net(disp[:, 0::2].mean(1), disp[:, 1::2].mean(1),
                                      feat[:, 0::2].mean(1), feat[:, 1::2].mean(1), s)
        idepth, prob = idepth[:, 0], prob[:, 0]
        normal = normals(idepth, cams, k, fit_dtype)
    return {"idepth": idepth, "depth": 1.0 / (idepth + 1e-8), "prob": prob, "normal": normal}
