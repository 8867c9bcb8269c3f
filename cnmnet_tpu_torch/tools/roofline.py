"""Roofline accounting: each phase's FLOPs and bytes against its time and
the card's peaks (``tools/roofline.py``).

Phases, as in the JAX tool: ``fwd1``, ``fwd16`` (bench's 3-view refined
forward at batch 1 and 16, 192x256, 64 planes), ``train2``, ``train8``
(the bf16 train step, ``model.compute_dtype=bfloat16``), ``cv`` (the cost
volume kernel alone, one pair, bf16 writeback), ``fwd1n``, ``fwd8n`` and
``train4n`` (480x640; the train step with ``remat_stages=2`` and the
refiner rematerialised). For each: GFLOP, GB, ms, TFLOP/s, ``MFU%``, GB/s
and ``HBM%``.

Counts, on one run of the phase:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and
  matrix products, forward and backward, 2 per multiply-add), plus the two
  hand kernels' analytic counts (``kernel_cost``): they launch through
  ``ctypes``, which no aten-level counter sees. Elementwise work
  (normalisation, activations, upsampling, the losses, the optimizer) is
  not counted. XLA's ``cost_analysis`` in the JAX tool counts it, so the
  port's count sits below XLA's for the same forward.
* Bytes: every aten op's tensor inputs read once and outputs written once
  (a ``TorchDispatchMode``; views and allocations move nothing), plus the
  kernels' ``kernel_cost`` bytes. Eager PyTorch runs op by op, so this is
  the traffic of the unfused program; an op whose operands stay in the 50
  MB L2 moves less, which is how a reading could pass 100%.
* Training counts the step's model work: the forward, the backward and the
  optimizer, each once. With remat the count is taken on the same step
  with remat off, so the recomputed forward is not counted as model work;
  the time is the remat step's.

The cost volume's analytic count is 55 f32 operations per cost (pair,
plane, pixel) where the JAX tool's ``phase_cost_volume`` counts 42 for C =
3 (``2 * 4 * C`` for the bilinear taps, ``2 * 3 * C`` for the absolute
differences): the port counts the same 24 for the taps, 8 for the three
differences, their absolute values and the two adds of the channel sum,
and adds the per-plane projection the JAX count leaves out (X, Y, Z 6, z +
eps 1, two divisions 2, floors 2, fractions 2, 1 - f 2, four weights 4, the
coordinate clip 4). Depth->normal: ``normals_flops``. ``chip_smoke.py``'s
kernel bounds read these counts too.

Time: the chain slope of ``obs/timing.forward_slope_seconds`` for the
forwards, of ``_train_slope`` for the steps, CUDA events for the kernel
alone (``phase_cost_volume``). Peaks (H100
SXM, NVIDIA's data sheet, dense): 989 TFLOP/s bf16, 495 TF32, 67 f32
outside the tensor cores, 3.35 TB/s HBM; a phase's MFU is taken against the
peak of its compute dtype (bf16 for the model phases, f32 for the kernel).
A share above 100% raises: it would mean a count or a time is wrong (the
JAX tool's record shows ``HBM% 128%``, ``RESULTS.md:40``). On the CPU the
tool prints the counts and the host's milliseconds and no shares.

    python -m cnmnet_tpu_torch.tools.roofline [--phases fwd1,fwd16,train2,train8,cv]
        [--iters N] [--ks 4,16,48] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from cnmnet_tpu_torch.kernels import cost_volume as kcv
from cnmnet_tpu_torch.kernels import normals as kn

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_F32 = PEAK_FLOPS["float32"]
# f32 operations per cost-volume output (pair, plane, pixel): X, Y, Z 6;
# z + eps 1; two divisions 2; floors 2; fractions 2; 1 - f 2; four weights
# 4; 12 tap products and 12 accumulations 24; three differences, abs and
# two adds 8; the clip 4. The per-pixel terms are amortised over the planes.
CV_FLOPS = 55
CV_COEFS = 12  # f32 homography coefficients per pair


def normals_flops(k: int) -> int:
    """f32 operations per pixel of depth->normal: backprojection 18,
    monomials 6, two separable k-tap passes over 9 sums 18 (k - 1), the
    adjugate solve and normalisation 62."""
    return 18 + 6 + 18 * (k - 1) + 62


def kernel_cost(name: str, shape, out_bytes: int = 4):
    """``(flops, bytes)`` of one launch, each input read once and each
    output written once. ``cost_volume``: shape ``(pairs, H, W, planes)``
    (f32 reference and source, the pairs' coefficients, the plane table,
    the volume in ``out_bytes`` per cost); ``depth_to_normal``: ``(B, H, W,
    k)`` (f32 depth, ``K^-1``, f32 normals)."""
    if name == "cost_volume":
        pairs, H, W, P = shape
        costs = pairs * P * H * W
        return costs * CV_FLOPS, 2 * pairs * H * W * 3 * 4 + pairs * CV_COEFS * 4 + P * 4 \
            + costs * out_bytes
    if name == "depth_to_normal":
        B, H, W, k = shape
        return B * H * W * normals_flops(k), B * H * W * 4 + B * 9 * 4 + B * H * W * 3 * 4
    raise KeyError(name)


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_F32):
    """The least time on the card, ms, and what sets it: ``"bytes"`` at
    3.35 TB/s or ``"operations"`` at ``peak_flops``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def shares(flops: float, nbytes: float, secs: float, peak_flops: float):
    """``(TFLOP/s, MFU%, GB/s, HBM%)``; a share above 100% raises."""
    tflops, gbs = flops / secs / 1e12, nbytes / secs / 1e9
    mfu, hbm = 100 * tflops * 1e12 / peak_flops, 100 * gbs * 1e9 / PEAK_BYTES
    if mfu > 100 or hbm > 100:
        raise ValueError(f"a roofline share above 100% (MFU {mfu:.1f}%, HBM {hbm:.1f}%): "
                         f"{flops:.4g} FLOP and {nbytes:.4g} B in {secs * 1e3:.4f} ms cannot "
                         "run on this card; the count or the time is wrong")
    return tflops, mfu, gbs, hbm


class KernelLog:
    """For the span of a ``with``: every launch of the two hand kernels
    through their wrappers (``kernels/cost_volume.cost_volume`` and
    ``kernels/normals.depth_to_normal``, which ``kernels/dispatch`` calls)
    with its ``kernel_cost``. CPU tensors take the plain versions there and
    are not logged; the launch counters stay the kernels' own."""

    def __init__(self):
        self.flops = self.bytes = 0
        self.calls = []

    def _log(self, name, shape, out_bytes):
        flops, nbytes = kernel_cost(name, shape, out_bytes)
        self.flops += flops
        self.bytes += nbytes
        self.calls.append((name, shape))

    def __enter__(self):
        self._cv, self._n = kcv.cost_volume, kn.depth_to_normal

        def cost_volume(ref_images, *args, **kwargs):
            out = self._cv(ref_images, *args, **kwargs)  # [B, H, W, P]
            if ref_images.is_cuda:
                self._log("cost_volume", tuple(out.shape), out.element_size())
            return out

        def depth_to_normal(depth, intrinsics_inv, k_size=9, *args, **kwargs):
            out = self._n(depth, intrinsics_inv, k_size, *args, **kwargs)
            if depth.is_cuda:
                self._log("depth_to_normal", tuple(depth.shape) + (k_size,), 4)
            return out

        kcv.cost_volume, kn.depth_to_normal = cost_volume, depth_to_normal
        return self

    def __exit__(self, *exc):
        kcv.cost_volume, kn.depth_to_normal = self._cv, self._n


class ByteCounter(TorchDispatchMode):
    """Bytes of every aten op's tensor inputs and outputs; views and
    allocations count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and not func.__name__.startswith(("empty", "_local_scalar")):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count(fn):
    """Run ``fn()`` once under the counters: ``{"flops", "bytes",
    "model_flops", "kernel_flops", "kernel_bytes", "flops_by_op",
    "kernels"}``; ``flops_by_op`` keys are aten op names
    (``"aten.convolution"``)."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes, KernelLog() as log:
        fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    by_op = {str(op): int(n) for op, n in flops.get_flop_counts().get("Global", {}).items()}
    model = int(flops.get_total_flops())
    return {"flops": model + log.flops, "bytes": nbytes.bytes + log.bytes, "model_flops": model,
            "kernel_flops": log.flops, "kernel_bytes": log.bytes, "flops_by_op": by_op,
            "kernels": log.calls}


@contextlib.contextmanager
def no_remat(model):
    """``model`` (a ``CNMModel``) with remat off for the span of a ``with``."""
    dn, rn = model.depth_net, model.refine_net
    saved = dn.remat, rn.remat if rn is not None else None
    dn.remat = 0
    if rn is not None:
        rn.remat = False
    try:
        yield model
    finally:
        dn.remat = saved[0]
        if rn is not None:
            rn.remat = saved[1]


def _train_slope(step, state, batch, ks=(4, 16, 48)):
    """Chain-slope seconds per step (``step_time_slope``'s method): K steps
    then one ``float(loss)``, for the last two K."""
    state, metrics = step(state, batch)
    float(metrics["loss"])
    results = []
    for k in ks:
        t0 = time.monotonic()
        for _ in range(k):
            state, metrics = step(state, batch)
        float(metrics["loss"])
        results.append((k, time.monotonic() - t0))
    (k1, t1), (k2, t2) = results[-2], results[-1]
    return (t2 - t1) / (k2 - k1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_forward(device, batch_size, height=192, width=256, iters=None, forward=None):
    """Bench's forward (``forward``, else a new seeded one) at this batch
    and size."""
    from cnmnet_tpu_torch.bench import build_model, chain_lengths, make_forward
    from cnmnet_tpu_torch.obs.timing import forward_slope_seconds
    from cnmnet_tpu_torch.tools._batch import tiny_batch

    batch = tiny_batch(batch_size, height, width, device=device)
    images, cams = batch["images"], batch["cams"]
    forward = forward or make_forward(build_model(device))
    forward(images, cams)
    _sync(device)
    c = count(lambda: forward(images, cams))
    k1, k2 = chain_lengths(device, iters)
    c["secs"] = forward_slope_seconds(forward, images, cams, k1=k1, k2=k2)
    c["dtype"] = "bfloat16" if device.type == "cuda" else "float32"
    return c


def train_config(batch_size, height, width, extra=()):
    from cnmnet_tpu_torch.config import Config, apply_overrides

    return apply_overrides(Config(), [
        f"dataset.batch_size={batch_size}", f"dataset.image_height={height}",
        f"dataset.image_width={width}", "model.num_planes=64", "model.compute_dtype=bfloat16",
        *extra])


def train_setup(device, batch_size, height, width, extra=()):
    """``train_config``'s step, a seeded state and one seeded batch on
    ``device``, after the step's first call: ``(cfg, step, state, batch)``."""
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    cfg = train_config(batch_size, height, width, extra)
    batch = tiny_batch(batch_size, height, width, device=device)
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg)
    state, metrics = step(state, batch)  # first-call costs
    float(metrics["loss"])
    return cfg, step, state, batch


def phase_train(device, batch_size, height=192, width=256, extra=(), ks=(4, 16, 48)):
    _, step, state, batch = train_setup(device, batch_size, height, width, extra)
    with no_remat(state.model):
        c = count(lambda: float(step(state, batch)[1]["loss"]))
    c["secs"] = _train_slope(step, state, batch, ks)
    c["dtype"] = "bfloat16"
    return c


def phase_cost_volume(device, iters=None):
    """The kernel alone at 192x256, 64 planes, one pair, bf16 writeback:
    its CUDA-event time (``kernels/ablate.device_ms``; a chain of single
    launches would time the host's launch path instead), the plain
    version's chain slope on the CPU; counts from ``kernel_cost``."""
    from cnmnet_tpu_torch.bench import chain_lengths
    from cnmnet_tpu_torch.geometry.camera import camera_from_array
    from cnmnet_tpu_torch.kernels import dispatch
    from cnmnet_tpu_torch.obs.timing import forward_slope_seconds
    from cnmnet_tpu_torch.ops import cost_volume as pcv

    H, W, P = 192, 256, 64
    g = torch.Generator().manual_seed(0)
    ref = torch.randn(1, H, W, 3, generator=g).to(device)
    src = torch.randn(1, H, W, 3, generator=g).to(device)
    cam = torch.zeros(1, 2, 4, 4)
    cam[:, 0] = torch.eye(4)
    cam[:, 1, :3, :3] = torch.tensor([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    moved = cam.clone()
    moved[:, 0, 0, 3] = 0.08
    c1, c2 = camera_from_array(cam.to(device)), camera_from_array(moved.to(device))
    if device.type == "cuda":
        from cnmnet_tpu_torch.kernels.ablate import device_ms

        coefs, idepths = kcv.pack_coefs(c1, c2), pcv.idepth_hypotheses(3.0, P, device)
        secs = device_ms(lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths,
                                                        torch.bfloat16)) / 1e3
    else:
        k1, k2 = chain_lengths(device, iters)
        secs = forward_slope_seconds(
            lambda r, s: dispatch.cost_volume(r, s, c1, c2, 3.0, P, out_dtype=torch.bfloat16),
            ref, src, k1=k1, k2=k2)
    flops, nbytes = kernel_cost("cost_volume", (1, H, W, P), out_bytes=2)
    return {"flops": flops, "bytes": nbytes, "model_flops": 0, "kernel_flops": flops,
            "kernel_bytes": nbytes, "secs": secs, "dtype": "float32"}


TITLES = {
    "fwd1": "3-view fwd b=1", "fwd16": "3-view fwd b=16", "train2": "train step b=2",
    "train8": "train step b=8", "cv": "cost-volume kernel", "fwd1n": "fwd b=1 @480x640",
    "fwd8n": "fwd b=8 @480x640", "train4n": "train b=4 @480x640, remat2+refiner",
}
REMAT = ("model.remat=true", "model.remat_stages=2", "model.remat_refiner=true")


def run_phase(key, device, iters=None, ks=(4, 16, 48), forward=None):
    """One phase's counts and seconds; the forward phases share ``forward``
    (bench's seeded model) when one is given."""
    return {
        "fwd1": lambda: phase_forward(device, 1, iters=iters, forward=forward),
        "fwd16": lambda: phase_forward(device, 16, iters=iters, forward=forward),
        "train2": lambda: phase_train(device, 2, ks=ks),
        "train8": lambda: phase_train(device, 8, ks=ks),
        "cv": lambda: phase_cost_volume(device, iters),
        "fwd1n": lambda: phase_forward(device, 1, 480, 640, iters, forward),
        "fwd8n": lambda: phase_forward(device, 8, 480, 640, iters, forward),
        "train4n": lambda: phase_train(device, 4, 480, 640, REMAT, ks),
    }[key]()


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import build_model, device_name, make_forward
    from cnmnet_tpu_torch.serve import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="fwd1,fwd16,train2,train8,cv")
    ap.add_argument("--iters", type=int, default=None,
                    help="long chain of the forward slopes (default: bench's 40)")
    ap.add_argument("--ks", default="4,16,48", help="chain lengths of the train slopes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ks = tuple(int(k) for k in args.ks.split(","))
    on_card = device.type == "cuda"
    keys = [k.strip() for k in args.phases.split(",")]
    forward = make_forward(build_model(device)) if any(k.startswith("fwd") for k in keys) else None
    print(f"device: {device_name(device)}")
    print("| phase | dtype | GFLOP (model + kernels) | GB | ms | TFLOP/s | MFU% | GB/s | HBM% |\n"
          "|---|---|---|---|---|---|---|---|---|", flush=True)
    for key in keys:
        c = run_phase(key, device, args.iters, ks, forward)
        row = {"phase": key, "title": TITLES[key], "dtype": c["dtype"], "gflop": c["flops"] / 1e9,
               "gflop_model": c["model_flops"] / 1e9, "gflop_kernels": c["kernel_flops"] / 1e9,
               "gb": c["bytes"] / 1e9, "ms": c["secs"] * 1e3}
        if on_card:
            peak = PEAK_FLOPS[c["dtype"]]
            row["tflops"], row["mfu_pct"], row["gbs"], row["hbm_pct"] = shares(
                c["flops"], c["bytes"], c["secs"], peak)
            row["peak_tflops"] = peak / 1e12
            cells = (f"{row['tflops']:.2f} | {row['mfu_pct']:.2f}% | {row['gbs']:.1f} | "
                     f"{row['hbm_pct']:.2f}%")
        else:
            cells = "- | - | - | -"
        print(f"| {TITLES[key]} | {c['dtype']} | {row['gflop']:.2f} ({row['gflop_model']:.2f} + "
              f"{row['gflop_kernels']:.3f}) | {row['gb']:.3f} | {row['ms']:.3f} | {cells} |")
        print(json.dumps(row), flush=True)
        del c
        if on_card:
            torch.cuda.empty_cache()
    if not on_card:
        print("(host milliseconds; the shares are the card's and are not computed here)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
