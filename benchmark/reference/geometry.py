"""Plain PyTorch geometry of the reference: image normalisation, the
plane-sweep cost volume and depth -> surface normals.

Written from the method's description (CNMNet, arXiv 2004.00845, and the
reference implementation's ``depthNet_model.py`` and ``utils``), in float32
with no kernel, tiling or caching. Nothing here imports the program.

* Images: ImageNet normalisation of [0, 1] RGB, ``(x - mean) / std``; a
  uint8 frame is first divided by 255.
* Cost volume: for each of ``P`` inverse depths uniform in ``[0.1, s]``
  (``s`` = ``idepth_scale``; ``[0.02, 2]`` at ``s = 2``), every reference
  pixel ``(u, v)`` is warped into the source through ``K_s R K_r^-1 (u, v,
  1) + K_s t * idepth``, the source is sampled bilinearly at the pinhole
  projection with zero padding, and the cost is ``sum_c |warped - ref|``.
* Normals: depth is backprojected through ``K^-1`` (closed form), depths
  outside ``(0, 10)`` are masked, the nine moments ``xx, xy, xz, yy, yz, zz, x, y, z`` are
  summed over a zero-padded ``k x k`` window, ``(A^T A) n = A^T 1`` is
  solved by the adjugate (``A^T 1`` where the determinant is below 1e-5),
  and ``n`` is normalised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 or [0, 1] float RGB ``[..., 3]`` -> ImageNet-normalised f32."""
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    mean = x.new_tensor(IMAGENET_MEAN)
    std = x.new_tensor(IMAGENET_STD)
    return (x - mean) / std


def idepth_planes(idepth_scale: float, planes: int, device=None) -> torch.Tensor:
    if idepth_scale == 2.0:
        lo, hi = 0.02, 2.0
    else:
        lo, hi = 0.1 * idepth_scale / 3.0, idepth_scale
    return torch.linspace(lo, hi, planes, dtype=torch.float64, device=device).float()


def inverse_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of ``[[fx, s, cx], [0, fy, cy], [0, 0, 1]]``, in
    ``K``'s type."""
    fx, s, cx, fy, cy = K[..., 0, 0], K[..., 0, 1], K[..., 0, 2], K[..., 1, 1], K[..., 1, 2]
    one, zero = torch.ones_like(fx), torch.zeros_like(fx)
    return torch.stack([torch.stack([one / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], -1),
                        torch.stack([zero, one / fy, -cy / fy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _sweep_terms(ref_cam: torch.Tensor, src_cam: torch.Tensor):
    """``[N, 2, 4, 4]`` cameras -> ``K_s R K_r^-1`` ``[N, 3, 3]`` and ``K_s t``
    ``[N, 3]`` of the ref->src pose, in float64."""
    E_r, E_s = ref_cam[:, 0].double(), src_cam[:, 0].double()
    K_r, K_s = ref_cam[:, 1, :3, :3].double(), src_cam[:, 1, :3, :3].double()
    rel = E_s @ torch.linalg.inv(E_r)
    return K_s @ rel[:, :3, :3] @ torch.linalg.inv(K_r), (K_s @ rel[:, :3, 3:4])[..., 0]


def cost_volume(ref: torch.Tensor, src: torch.Tensor, ref_cam: torch.Tensor,
                src_cam: torch.Tensor, idepth_scale: float, planes: int) -> torch.Tensor:
    """Normalised ``ref``, ``src`` ``[N, H, W, 3]`` and cameras ``[N, 2, 4, 4]`` ->
    the cost volume ``[N, P, H, W]`` f32."""
    N, H, W, C = ref.shape
    KRKi, KT = _sweep_terms(ref_cam, src_cam)
    v, u = torch.meshgrid(torch.arange(H, device=ref.device, dtype=torch.float64),
                          torch.arange(W, device=ref.device, dtype=torch.float64), indexing="ij")
    uv1 = torch.stack([u, v, torch.ones_like(u)], 0).reshape(3, H * W)
    rays = (KRKi @ uv1).float()  # [N, 3, HW]
    idepths = idepth_planes(idepth_scale, planes, ref.device)
    hom = rays[:, None] + KT.float()[:, None, :, None] * idepths[None, :, None, None]
    z = hom[:, :, 2] + 1e-6
    z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    bound = 100.0 * max(H, W)
    x = (hom[:, :, 0] / z).clamp(-bound, bound)  # [N, P, HW]
    y = (hom[:, :, 1] / z).clamp(-bound, bound)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    flat = src.reshape(N, H * W, C)
    warped = torch.zeros(N, planes, H * W, C, device=ref.device)
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                      (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, -1, 1).expand(-1, -1, C)
        vals = torch.gather(flat, 1, idx).reshape(N, planes, H * W, C)
        warped += vals * (w * inside)[..., None]
    cost = (warped - ref.reshape(N, 1, H * W, C)).abs().sum(-1)
    return cost.reshape(N, planes, H, W)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-padded ``k x k`` window sums of ``[B, H, W, C]``: the rows' taps
    added first to last, then the columns'."""
    p = k // 2
    H, W = x.shape[1:3]
    xp = F.pad(x, (0, 0, 0, 0, p, p))
    rows = xp[:, 0:H]
    for d in range(1, k):
        rows = rows + xp[:, d:d + H]
    rp = F.pad(rows, (0, 0, p, p))
    out = rp[:, :, 0:W]
    for d in range(1, k):
        out = out + rp[:, :, d:d + W]
    return out


def depth_to_normal(depth: torch.Tensor, K_inv: torch.Tensor, k: int) -> torch.Tensor:
    """Depth ``[B, H, W]`` and ``K^-1`` ``[B, 3, 3]`` -> unit normals ``[B, H, W, 3]``.

    Each step is one elementwise operation in the order written, so it
    rounds once, left to right: the fit is ill-conditioned (the normals of
    two depths a rounding apart can differ by degrees), and this order is
    the one the program's plain version and kernel keep, so that given the
    same depth all three give the same normals."""
    B, H, W = depth.shape
    v = torch.arange(H, device=depth.device, dtype=depth.dtype)[:, None].expand(H, W)
    u = torch.arange(W, device=depth.device, dtype=depth.dtype)[None, :].expand(H, W)
    k_inv = K_inv[:, :, :, None, None]
    rays = k_inv[:, :, 0] * u + k_inv[:, :, 1] * v + k_inv[:, :, 2]  # [B, 3, H, W]
    valid = ((depth > 0) & (depth < 10)).to(depth.dtype)
    x, y, z = (rays.permute(0, 2, 3, 1) * depth[..., None] * valid[..., None]).unbind(-1)
    m = _box_sum(torch.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z], -1), k)
    a, b, c, d, e, f, rx, ry, rz = m.unbind(-1)
    det = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
    adj00, adj01, adj02 = d * f - e * e, c * e - b * f, b * e - c * d
    adj11, adj12, adj22 = a * f - c * c, b * c - a * e, a * d - b * b
    nx = adj00 * rx + adj01 * ry + adj02 * rz
    ny = adj01 * rx + adj11 * ry + adj12 * rz
    nz = adj02 * rx + adj12 * ry + adj22 * rz
    singular = torch.isnan(det) | (det < 1e-5)
    inv_det = 1.0 / torch.where(singular, torch.ones_like(det), det)
    n = torch.stack([torch.where(singular, rx, nx * inv_det), torch.where(singular, ry, ny * inv_det),
                     torch.where(singular, rz, nz * inv_det)], -1)
    nx, ny, nz = n.unbind(-1)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-20)[..., None]
    return n / (norm + 1e-5)
