"""Depth->normal kernel against its plain version, and its times
(``tools/bench_normals.py``).

On ``B`` smooth scene-like depth maps of ``H`` x ``W`` (the JAX tool's:
sines over a 2 m plane, one offset per map) and a focal of 290: the kernel
(``kernels/dispatch.depth_to_normal``, auto) against the plain version
(``backend="torch"``), max abs and the angle between them; the chain slope
of the dispatch call (``iters`` its long chain); on the card the
CUDA-event time of the kernel launch alone and of the plain version
(``kernels/ablate.device_ms``); the bound (``roofline.kernel_cost``). The
kernel rounds where the plain version rounds: any error exits 1.

    python -m cnmnet_tpu_torch.tools.bench_normals [B H W k iters] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def smooth_depth(B: int, H: int, W: int) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return (2.0 + 0.5 * np.sin(2 * np.pi * xx[None] / W * 3)
            + 0.3 * np.cos(2 * np.pi * yy[None] / H * 2)
            + np.linspace(0, 0.5, B, dtype=np.float32)[:, None, None]).astype(np.float32)


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
    from cnmnet_tpu_torch.kernels import dispatch
    from cnmnet_tpu_torch.obs.timing import forward_slope_seconds
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools.roofline import bound, kernel_cost

    ap = argparse.ArgumentParser()
    ap.add_argument("B", nargs="?", type=int, default=4)
    ap.add_argument("H", nargs="?", type=int, default=192)
    ap.add_argument("W", nargs="?", type=int, default=256)
    ap.add_argument("k", nargs="?", type=int, default=9)
    ap.add_argument("iters", nargs="?", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    B, H, W, k = args.B, args.H, args.W, args.k
    depth = torch.from_numpy(smooth_depth(B, H, W)).to(device)
    K = torch.tensor([[290.0, 0, W / 2], [0, 290.0, H / 2], [0, 0, 1]])
    kinv = invert_intrinsics(K).expand(B, 3, 3).contiguous().to(device)

    def run(d, ki, backend=None):
        return dispatch.depth_to_normal(d, ki, k, backend=backend)[0]

    a, b = run(depth, kinv), run(depth, kinv, "torch")
    err = (a - b).abs().max().item()
    a64, b64 = a.double(), b.double()
    cos = (a64 * b64).sum(-1) / (a64.norm(dim=-1) * b64.norm(dim=-1)).clamp(min=1e-12)
    ang = torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))
    slope = forward_slope_seconds(run, depth, kinv, k1=max(1, args.iters // 4),
                                  k2=max(2, args.iters)) * 1e3
    flops, nbytes = kernel_cost("depth_to_normal", (B, H, W, k))
    bound_ms, by = bound(nbytes, flops)
    row = {"B": B, "height": H, "width": W, "k": k, "max_abs_err": err,
           "angle_max_deg": ang.max().item(), "angle_mean_deg": ang.mean().item(),
           "slope_ms": slope, "bound_ms": bound_ms, "bound_by": by}
    if device.type == "cuda":
        from cnmnet_tpu_torch.kernels import normals as kn
        from cnmnet_tpu_torch.kernels.ablate import device_ms
        from cnmnet_tpu_torch.ops import normals as pn

        row["ms"] = device_ms(lambda: kn.depth_to_normal_kernel(depth, kinv, k))
        row["plain_ms"] = device_ms(lambda: pn.depth_to_normal(depth, kinv, k))
    times = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms (CUDA events)"
             if "ms" in row else "kernel and plain device times not measured")
    print(f"device: {device_name(device)}; depth->normal {B}x{H}x{W} k={k}: max abs "
          f"{err:.3e}, angle max {row['angle_max_deg']:.4f} mean {row['angle_mean_deg']:.6f} "
          f"deg; chain slope {slope:.4f} ms/call; {times}; bound {bound_ms * 1e3:.2f} us ({by})")
    print(json.dumps(row))
    if err > 0:
        print(f"FAIL: the kernel differs from its plain version by {err:.3e}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
