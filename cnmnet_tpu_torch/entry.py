"""The entry points of ``__graft_entry__.py``, for the port.

``entry(device)`` -> ``(fn, example_args)``: the single-card forward of the
flagship model, ``CNMModel(num_planes=64)`` with seeded weights, f32, in
eval mode, on ``tiny_batch(1, 192, 256)`` (3 views).
``fn(images, cams) -> (idepth_refined, prob_map)``, as JAX's ``fn``: the two
plane-sweep cost volumes (one launch of the cost-volume kernel for the two
folded pairs), DepthNet and RefineNet. JAX's docstring names depth->normal
too; its ``fn`` does not run it, and neither does this one.

``dryrun_multichip(n, device)``: one full train step (loss stack, backward,
Adam) on an ``n``-rank ``data x tile`` mesh, tile 2 when ``n`` is even and
above 2, else 1, as in JAX: ``Config()`` with 8 planes, k = 5,
``dataset.batch_size`` = the data axis, the normal losses on. Each rank
takes its samples of the global batch and, under a tile axis, its rows
(``train/loop.make_train_step(cfg, mesh)``). The inputs are 32x64 as in JAX
where the tile axis is 1; the port's row plan needs ``tile`` rows at every
level of the conv stack, so at tile 2 they are 64x64
(``parallel/mesh.least_height``). The ranks are processes
(``tools/_ranks.py``): NCCL, one a card, on CUDA; gloo on the CPU. More
ranks than cards raises, as JAX's ``assert`` does.

    python -m cnmnet_tpu_torch.entry [multichip N] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import torch

WIDTH = 64


def entry(device="cuda"):
    """``(fn, (images, cams))``: the flagship forward and its inputs on
    ``device``. ``fn.model`` is the model it runs."""
    from cnmnet_tpu_torch.models.cnm import CNMModel
    from cnmnet_tpu_torch.models.layers import init_weights
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.tools._batch import tiny_batch

    dev = resolve_device(device)
    batch = tiny_batch(1, 192, 256, device=dev)
    model = CNMModel(num_planes=64)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()

    @torch.inference_mode()
    def fn(images, cams):
        out = model(images, cams)
        return out.idepth_refined, out.prob_map

    fn.model = model
    return fn, (batch["images"], batch["cams"])


def mesh_shape(n_devices: int):
    """``(data, tile)`` of JAX's dryrun mesh."""
    tile = 2 if n_devices % 2 == 0 and n_devices > 2 else 1
    return n_devices // tile, tile


def dryrun_config(data: int, height: int):
    """The dryrun's ``Config``: 8 planes, k = 5, batch = the data axis, the
    normal losses on; the image size the step will see."""
    from cnmnet_tpu_torch.config import Config

    cfg = Config()
    cfg.model.num_planes = 8
    cfg.model.k_size = 5
    cfg.dataset.batch_size = data
    cfg.dataset.image_height, cfg.dataset.image_width = height, WIDTH
    cfg.train.use_normal_loss = True
    return cfg


def dryrun_rank(device, n_devices: int) -> dict:
    """One rank of ``dryrun_multichip``: its mesh, the global loss of one
    step, the rows and samples it held and its kernels' launches."""
    import torch.distributed as dist

    from cnmnet_tpu_torch.kernels.dispatch import launch_counts
    from cnmnet_tpu_torch.parallel.mesh import least_height, make_mesh
    from cnmnet_tpu_torch.parallel.sharding import Spatial, shard_batch
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    data, tile = mesh_shape(n_devices)
    mesh = make_mesh(data=data, tile=tile)
    height = least_height(tile)
    cfg = dryrun_config(data, height)
    local = shard_batch(mesh, tiny_batch(data, height, WIDTH, device=device))
    state = create_train_state(cfg, 0, device)
    before = launch_counts()
    state, metrics = make_train_step(cfg, mesh)(state, local)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"rank {dist.get_rank()}: loss {loss}, metrics "
                                 f"{ {k: float(v) for k, v in metrics.items() if k != 'viz'} }")
    rows = Spatial(mesh, height, WIDTH).rows(0) if tile > 1 else (0, height)
    first = mesh.data_index * len(local["images"])
    return {"mesh": mesh.shape, "loss": loss, "height": height, "width": WIDTH,
            "rows": list(rows), "samples": [first, first + len(local["images"])],
            "launches": {k: v - before[k] for k, v in launch_counts().items()}}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run one sharded train step on ``n_devices`` ranks; prints the
    sharding and ``dryrun_multichip ok: mesh=... loss=...`` and returns
    rank 0's result with every rank's under ``"ranks"``."""
    from cnmnet_tpu_torch.tools import _ranks

    ranks = _ranks.run(n_devices, dryrun_rank, n_devices, device=device)
    lead = ranks[0]
    data, tile = lead["mesh"]["data"], lead["mesh"]["tile"]
    where = "dim 0 (samples) over 'data'"
    if tile > 1:
        where += ", dim 2 (rows) over 'tile'"
    print(f"dryrun sharding: images {where}; {lead['height']}x{lead['width']}; rank 0 holds "
          f"samples {lead['samples']}, rows {lead['rows']}")
    print(f"dryrun_multichip ok: mesh={ {'data': data, 'tile': tile} } loss={lead['loss']:.4f}")
    return {**lead, "ranks": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=["multichip"])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mode == "multichip":
        dryrun_multichip(args.n_devices, args.device)
        return 0
    fn, example = entry(args.device)
    out = fn(*example)
    if out[0].is_cuda:
        torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
