"""Scaling sweep over mesh shapes (``tools/scaling_sweep.py``; BASELINE
configs 3-5).

For each ``DATAxTILE`` mesh of ``--meshes``, runs the full train step
(``make_train_step(cfg, mesh)``: global BatchNorm and loss reductions, one
gradient all-reduce, rows over the tile axis) in ``DATA x TILE`` rank
processes (``tools/_ranks.py``: NCCL, one rank a card, on CUDA; gloo on the
CPU), with JAX's config: ``Config()``, ``--planes`` planes, k = 5, global
batch = ``--per-device-batch`` x DATA. Each rank takes one warm-up step,
waits at a barrier, then runs ``--iters`` steps closed by one
synchronising fetch of the loss; a mesh's step time is its slowest rank's.
Prints one JSON row a mesh (``mesh``, ``devices``, ``global_batch``,
``step_ms``, ``samples_per_s``, ``scaling_efficiency``: samples/s over the
mesh's devices times the first measured mesh's rate per device), then
``{"sweep": [...]}``. A mesh with more ranks than cards prints ``skip
{mesh}: only {n} devices`` and is left out; on the CPU the ranks are
processes and no mesh is skipped.

    python -m cnmnet_tpu_torch.tools.scaling_sweep [--meshes 1x1,2x1,4x1,8x1]
        [--height 32 --width 64] [--planes 16] [--per-device-batch 1] [--iters 5]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def sweep_rank(device, data: int, tile: int, height: int, width: int, planes: int,
               per_device_batch: int, iters: int) -> dict:
    """One rank of one mesh: seconds per step over ``iters`` steps."""
    import torch.distributed as dist

    from cnmnet_tpu_torch.config import Config
    from cnmnet_tpu_torch.kernels.dispatch import launch_counts
    from cnmnet_tpu_torch.parallel.mesh import make_mesh
    from cnmnet_tpu_torch.parallel.sharding import shard_batch
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    mesh = make_mesh(data=data, tile=tile)
    cfg = Config()
    cfg.model.num_planes = planes
    cfg.model.k_size = 5
    cfg.dataset.batch_size = per_device_batch * data
    cfg.dataset.image_height, cfg.dataset.image_width = height, width
    local = shard_batch(mesh, tiny_batch(cfg.dataset.batch_size, height, width, device=device))
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg, mesh)
    state, metrics = step(state, local)  # first-call costs
    float(metrics["loss"])
    dist.barrier()
    before = launch_counts()
    t0 = time.monotonic()
    for _ in range(iters):
        state, metrics = step(state, local)
    loss = float(metrics["loss"])  # waits for the whole chain
    secs = (time.monotonic() - t0) / iters
    return {"secs": secs, "loss": loss,
            "launches": {k: v - before[k] for k, v in launch_counts().items()}}


def main(argv=None) -> int:
    from cnmnet_tpu_torch.bench import device_name
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools import _ranks

    p = argparse.ArgumentParser()
    p.add_argument("--meshes", default="1x1,2x1,4x1,8x1")
    p.add_argument("--height", type=int, default=32)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--planes", type=int, default=16)
    p.add_argument("--per-device-batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    print(f"device: {device_name(device)}", flush=True)

    results = []
    base_rate = None
    for mesh_str in args.meshes.split(","):
        data, tile = (int(v) for v in mesh_str.split("x"))
        n = data * tile
        if cards is not None and n > cards:
            print(f"skip {mesh_str}: only {cards} devices", flush=True)
            continue
        ranks = _ranks.run(n, sweep_rank, data, tile, args.height, args.width, args.planes,
                           args.per_device_batch, args.iters, device=device.type)
        dt = max(r["secs"] for r in ranks)
        global_batch = args.per_device_batch * data
        rate = global_batch / dt
        if base_rate is None:
            base_rate = rate / n  # per-device rate at the first measured mesh
        results.append({
            "mesh": mesh_str, "devices": n, "global_batch": global_batch,
            "step_ms": dt * 1e3, "samples_per_s": rate,
            "scaling_efficiency": rate / (n * base_rate),
            "loss": ranks[0]["loss"], "launches": [r["launches"] for r in ranks],
        })
        print(json.dumps(results[-1]), flush=True)

    print(json.dumps({"sweep": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
