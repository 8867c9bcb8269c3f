"""Benchmark: 3-view refined depth inference, frames/s on one card
(``bench.py`` of the repository, for the JAX package).

The timed forward is the JAX benchmark's (``bench.py:53-59``) at the
reference's working point (192x256, 64 planes, 1 reference + 2 source
views): the two plane-sweep cost volumes, the folded DepthNet, the
RefineNet, ``depth = 1/(idepth_refined + 1e-8)`` and depth->normal with k =
9 on view 0's ``K^-1``, on inputs already on the device (no wire). The
model is ``CNMModel(num_planes=64)`` with seeded weights in eval mode, in
bf16 on the card (``models/cnm.cast_for_compute``: norm layers stay f32)
and f32 on the CPU, as the JAX benchmark picks bf16 off the CPU. Both hand
kernels run through ``kernels/dispatch``.

Timing: the chain slope of ``obs/timing.forward_slope_seconds`` (k1 = 10,
k2 = 40 on the card, 1 and 4 on the CPU), with a CUDA-event time
(``kernels/ablate.device_ms``) printed on an earlier line as a cross-check.

The last line is the JAX benchmark's JSON: ``metric``
(``3view_refined_fps_per_chip``, ``_HxW`` appended off 192x256),
``value`` (frames/s), ``unit``, ``vs_baseline`` against the same estimated
10 frames/s of a V100, and ``baseline_kind``. The JAX line's
``measured_same_host_speedup`` is left out: it is a CPU figure of the JAX
package, not of this one.

    python -m cnmnet_tpu_torch.cli bench [--height 192 --width 256] [--device cuda]
"""

from __future__ import annotations

import json

import torch

from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.models.cnm import CNMModel, cast_for_compute
from cnmnet_tpu_torch.models.layers import init_weights
from cnmnet_tpu_torch.obs.timing import forward_slope_seconds
from cnmnet_tpu_torch.serve import resolve_device

V100_BASELINE_FPS = 10.0


def build_model(device, num_planes: int = 64, seed: int = 0) -> CNMModel:
    """Seeded ``CNMModel`` in eval mode on ``device``: bf16 compute on the
    card, f32 on the CPU."""
    dev = resolve_device(device)
    model = CNMModel(num_planes=num_planes)
    init_weights(model, torch.Generator().manual_seed(seed))
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    return cast_for_compute(model, dtype, dev).eval()


def make_forward(model: CNMModel, k_size: int = 9):
    """The timed forward: ``(images, cams) -> (idepth_refined, prob_map,
    normals)``."""

    @torch.inference_mode()
    def forward(images, cams):
        out = model(images, cams)
        depth = 1.0 / (out.idepth_refined[..., 0] + 1e-8)
        K_inv = invert_intrinsics(cams[:, 0, 1, :3, :3])
        normals, _ = dispatch.depth_to_normal(depth, K_inv, k_size)
        return out.idepth_refined, out.prob_map, normals

    return forward


def chain_lengths(device: torch.device, iters=None):
    """(k1, k2) of the chain slope: the benchmark's 10 and 40 on the card,
    1 and 4 on the CPU; ``iters`` sets k2 and k1 a quarter of it."""
    if iters:
        return max(1, iters // 4), max(2, iters)
    return (10, 40) if device.type == "cuda" else (1, 4)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)} (count {torch.cuda.device_count()})"
    return "cpu"


def main(height: int = 192, width: int = 256, device="cuda") -> dict:
    from cnmnet_tpu_torch.tools._batch import tiny_batch

    dev = resolve_device(device)
    batch = tiny_batch(1, height, width, device=dev)
    images, cams = batch["images"], batch["cams"]
    forward = make_forward(build_model(dev))
    forward(images, cams)  # loads the kernels
    k1, k2 = chain_lengths(dev)
    dt = forward_slope_seconds(forward, images, cams, k1=k1, k2=k2)
    print(f"device: {device_name(dev)}; chain slope {dt * 1e3:.4f} ms per frame "
          f"(k1 {k1}, k2 {k2})")
    if dev.type == "cuda":
        from cnmnet_tpu_torch.kernels.ablate import device_ms

        print(f"cuda events: {device_ms(lambda: forward(images, cams), runs=10, reps=5):.4f} ms "
              "per frame (median of 10 runs of 5 forwards behind a queued sleep)")
    fps = 1.0 / dt
    result = {
        "metric": "3view_refined_fps_per_chip"
        + ("" if (height, width) == (192, 256) else f"_{height}x{width}"),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / V100_BASELINE_FPS, 3),
        # an estimate: the reference publishes no throughput (SURVEY.md §6)
        "baseline_kind": "estimated 10 fps V100",
    }
    print(json.dumps(result))
    return result

