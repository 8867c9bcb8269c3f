"""Backward-lever sweep: chain-slope ms/step and GFLOP of train-step
variants (``tools/bwd_probe.py``).

Each variant is ``VARIANTS[name]`` over the fixed overrides
``dataset.batch_size=--batch``, ``model.num_planes=64`` and
``model.compute_dtype=bfloat16``, as in JAX: ``base`` (bf16, no remat),
the remat options, ``no_normals`` (the normal losses off: the three
depth->normal forwards and their backward go), ``k5`` (k_size 5), ``f32``.
``s2d``, ``psg`` and their remat forms select TPU lowerings of the
stride-2 convs that the port builds as the strided conv
(``train/state.py``), so their rows are expected to equal ``base``'s and
``remat``'s.

ms/step: the chain slope of ``roofline._train_slope`` over ``--ks`` (JAX's
``slope_ms``: K steps, then one ``float(loss)``; the slope between the last
two K). GFLOP: ``roofline.count`` of one step in place of XLA's
``cost_analysis``: the convolutions and matrix products of the forward, the
backward and the optimizer (``FlopCounterMode``), plus the analytic
``roofline.kernel_cost`` of every cost-volume and depth->normal call on
the step's path, counted where ``kernels/dispatch`` is called, so that
the plain versions on the CPU count as the kernels on the card do (on the
card the two counts must agree). Neither counts elementwise work, nor the
backward of depth->normal (plain autograd), which XLA's count includes. A
remat variant is counted with remat off (``roofline.no_remat``): the
recomputed forward is not model work; its time is the remat step's.

    python -m cnmnet_tpu_torch.tools.bwd_probe [--batch 8] [--height 192 --width 256]
        [--variants base,remat,...] [--ks 4,16,48] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.tools.roofline import KernelLog

VARIANTS = {
    "base": [],
    "remat": ["model.remat=true"],
    # selective remat: checkpoint only the N high-resolution encoder stages
    "remat1": ["model.remat=true", "model.remat_stages=1"],
    "remat2": ["model.remat=true", "model.remat_stages=2"],
    "remat3": ["model.remat=true", "model.remat_stages=3"],
    # + RefineNet remat
    "rematr": [
        "model.remat=true", "model.remat_stages=2", "model.remat_refiner=true"
    ],
    "rematfr": ["model.remat=true", "model.remat_refiner=true"],
    "no_normals": ["train.use_normal_loss=false"],
    "k5": ["model.k_size=5"],
    "f32": ["model.compute_dtype=float32"],
    "s2d": ["model.stride2=s2d"],
    "s2d_remat": ["model.stride2=s2d", "model.remat=true"],
    "psg": ["model.stride2=psg"],
    "psg_remat": ["model.stride2=psg", "model.remat=true"],
}


class CallLog(KernelLog):
    """``KernelLog``'s count taken at ``kernels/dispatch``: every call of
    ``dispatch.cost_volume`` and ``dispatch.depth_to_normal`` with its
    ``kernel_cost``, on the card or the CPU."""

    def __enter__(self):
        self._cv, self._n = dispatch.cost_volume, dispatch.depth_to_normal

        def cost_volume(*args, **kwargs):
            out = self._cv(*args, **kwargs)  # [B, H, W, P]
            self._log("cost_volume", tuple(out.shape), out.element_size())
            return out

        def depth_to_normal(depth, intrinsics_inv, k_size=9, *args, **kwargs):
            out = self._n(depth, intrinsics_inv, k_size, *args, **kwargs)
            self._log("depth_to_normal", tuple(depth.shape) + (k_size,), 4)
            return out

        dispatch.cost_volume, dispatch.depth_to_normal = cost_volume, depth_to_normal
        return self

    def __exit__(self, *exc):
        dispatch.cost_volume, dispatch.depth_to_normal = self._cv, self._n


def probe(name: str, batch_size: int, height: int, width: int, ks, device) -> dict:
    """One variant's row."""
    from cnmnet_tpu_torch.kernels.dispatch import launch_counts
    from cnmnet_tpu_torch.tools.roofline import _train_slope, count, no_remat, train_setup

    overrides = VARIANTS[name]
    cfg, step, state, batch = train_setup(device, batch_size, height, width, overrides)
    with no_remat(state.model), CallLog() as calls:
        c = count(lambda: float(step(state, batch)[1]["loss"]))
    if device.type == "cuda" and calls.flops != c["kernel_flops"]:
        raise RuntimeError(f"{name}: dispatch-level count {calls.flops} != the kernels' "
                             f"{c['kernel_flops']}")
    before = launch_counts()
    secs = _train_slope(step, state, batch, ks)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    flops = c["model_flops"] + calls.flops
    return {"variant": name, "overrides": overrides, "gflop": flops / 1e9,
            "gflop_model": c["model_flops"] / 1e9, "gflop_kernels": calls.flops / 1e9,
            "counted_with_remat_off": cfg.model.remat or cfg.model.remat_refiner,
            "ms_per_step": secs * 1e3, "samples_per_s": batch_size / secs,
            "steps_timed": 1 + sum(ks), "launches": launches, "batch": batch_size,
            "height": height, "width": width}


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.serve import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--ks", default="4,16,48", help="chain lengths of the slope")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ks = tuple(int(k) for k in args.ks.split(","))
    names = [n.strip() for n in args.variants.split(",")]
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    print(f"device: {device_name(device)}")
    print("| variant | GFLOP | ms/step | samples/s/chip |\n|---|---|---|---|", flush=True)
    for name in names:
        row = probe(name, args.batch, args.height, args.width, ks, device)
        print(f"| {name} | {row['gflop']:.0f} | {row['ms_per_step']:.1f} | "
              f"{row['samples_per_s']:.1f} |", flush=True)
        print(json.dumps(row), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
