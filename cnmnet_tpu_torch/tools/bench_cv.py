"""Cost-volume kernel against its plain version, and its times
(``tools/bench_cv.py``).

For each batch of ``--batches`` (pairs) at ``--height`` x ``--width`` and
``--planes``, on seeded white-noise images under the JAX tool's cameras
(focal 100, the source moved 0.08 along x):

* numerics: the kernel (``kernels/dispatch.cost_volume``, auto) against the
  plain version (``backend="torch"``) on the same inputs, max abs, in the
  ``--dtype`` writeback (bf16: against the plain volume rounded to bf16).
  The kernel rounds where the plain version rounds: any error exits 1;
* time: the chain slope (``obs/timing``) of the dispatch call, and on the
  card the CUDA-event time of the kernel launch alone and of the plain
  version (``kernels/ablate.device_ms``);
* the bound: ``roofline.kernel_cost`` over the card's peaks.

    python -m cnmnet_tpu_torch.tools.bench_cv [--batches 1,8,16] [--dtype bfloat16]
        [--height 192 --width 256 --planes 64] [--iters 80] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch


def cameras(B: int, H: int, W: int, device):
    """The JAX tool's ``_cams``: the reference at the origin, the source
    moved 0.08 along x, focal 100, principal point at the centre."""
    from cnmnet_tpu_torch.geometry.camera import camera_from_array

    cam = torch.zeros(B, 2, 4, 4)
    cam[:, 0] = torch.eye(4)
    cam[:, 1, :3, :3] = torch.tensor([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    moved = cam.clone()
    moved[:, 0, 0, 3] = 0.08
    return camera_from_array(cam.to(device)), camera_from_array(moved.to(device))


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import chain_lengths, device_name
    from cnmnet_tpu_torch.kernels import dispatch
    from cnmnet_tpu_torch.obs.timing import forward_slope_seconds
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools.roofline import bound, kernel_cost

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,8,16")
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--planes", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--iters", type=int, default=80, help="long chain of the slope")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    H, W, P = args.height, args.width, args.planes
    k1, k2 = chain_lengths(device, args.iters)
    g = torch.Generator().manual_seed(0)
    print(f"device: {device_name(device)}; cost volume {H}x{W}, {P} planes, {args.dtype} "
          f"writeback")
    print("| pairs | max abs | slope ms/call | kernel ms | plain ms | bound us (by) |\n"
          "|---|---|---|---|---|---|")
    worst = 0.0
    for B in (int(b) for b in args.batches.split(",")):
        ref = torch.randn(B, H, W, 3, generator=g).to(device)
        src = torch.randn(B, H, W, 3, generator=g).to(device)
        c1, c2 = cameras(B, H, W, device)

        def run(r, s, backend=None):
            return dispatch.cost_volume(r, s, c1, c2, 3.0, P, backend=backend, out_dtype=dtype)

        err = (run(ref, src).float() - run(ref, src, "torch").float()).abs().max().item()
        worst = max(worst, err)
        slope = forward_slope_seconds(run, ref, src, k1=k1, k2=k2) * 1e3
        flops, nbytes = kernel_cost("cost_volume", (B, H, W, P), dtype.itemsize)
        bound_ms, by = bound(nbytes, flops)
        row = {"pairs": B, "height": H, "width": W, "planes": P, "dtype": args.dtype,
               "max_abs_err": err, "slope_ms": slope, "bound_ms": bound_ms, "bound_by": by}
        if device.type == "cuda":
            from cnmnet_tpu_torch.kernels import cost_volume as kcv
            from cnmnet_tpu_torch.kernels.ablate import device_ms
            from cnmnet_tpu_torch.ops import cost_volume as pcv

            coefs = kcv.pack_coefs(c1, c2)
            idepths = pcv.idepth_hypotheses(3.0, P, device)
            row["ms"] = device_ms(lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths, dtype))
            row["plain_ms"] = device_ms(
                lambda: pcv.cost_volume_from_cameras(ref, src, c1, c2, 3.0, P).to(dtype))
        times = (f"{row['ms']:.4f} | {row['plain_ms']:.4f}" if "ms" in row
                 else "not measured | not measured")
        print(f"| {B} | {err:.3e} | {slope:.4f} | {times} | {bound_ms * 1e3:.2f} ({by}) |")
        print(json.dumps(row), flush=True)
    if worst > 0:
        print(f"FAIL: the kernel differs from its plain version by {worst:.3e}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
