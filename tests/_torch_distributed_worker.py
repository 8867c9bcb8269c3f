"""One rank of the port's two-process gloo checks (``tests/test_torch_distributed.py``).

    python tests/_torch_distributed_worker.py PORT WORLD RANK OUT_DIR

Joins a gloo process group on ``tcp://127.0.0.1:PORT`` and runs, in order,
on the CPU at 32x64 (8 planes, k = 5):

1. ``ops``: the row fetch of a halo and both tiled ops over a 1 x WORLD
   mesh (at 64 rows), against the untiled port ops on the global image;
2. ``step`` and ``accum``: one data-parallel train step (``grad_accum`` 1
   and 2, in f64: see ``one_step``) of a WORLD x 1 mesh whose ranks hold
   samples with different numbers of valid ground-truth pixels, against
   the one-process step on the global batch, which the first rank also
   runs;
3. ``cli``: ``cli train`` with a coordinator address over the same group,
   2 steps into one shared checkpoint directory, then a resume to step 3.

Each rank writes ``OUT_DIR/rank<RANK>.json`` with the largest differences
it measured; the test asserts on them. Imports torch and the port only.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cnmnet_tpu_torch import cli  # noqa: E402
from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import collate, normalize_images  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu_torch.geometry.camera import camera_from_array, invert_intrinsics  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch  # noqa: E402
from cnmnet_tpu_torch.models.layers import DispHead  # noqa: E402
from cnmnet_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from cnmnet_tpu_torch.parallel import sharding, tiled_ops  # noqa: E402
from cnmnet_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from cnmnet_tpu_torch.train import state as tstate  # noqa: E402

H, W, K, PLANES = 32, 64, 5, 8


def tiny_cfg(accum=1):
    cfg = Config()
    cfg.model.num_planes = PLANES
    cfg.model.k_size = K
    cfg.dataset.batch_size = 2
    cfg.train.grad_accum = accum
    return cfg


def scenes(n, seed, height=H):
    ds = SyntheticScenes(num_samples=n, height=height, width=W, view_num=3, seed=seed)
    batch = collate([ds[i] for i in range(n)])
    batch.pop("index")
    batch["images"] = normalize_images(batch["images"])
    return batch


def global_batch():
    """Four samples; sample ``i`` loses its ground truth in ``4 i`` top rows,
    so the two ranks' shards hold different valid-pixel counts."""
    batch = scenes(4, 7)
    for i in range(4):
        rows = 4 * i
        batch["depths"][i, :, :rows] = 0.0
        batch["disparity"][i, :rows] = 0.0
    return batch


def ops(mesh, world, rank):
    """Largest differences of each rank's tiled results from the untiled
    op's rows (0 = bit-equal), at 64 rows (the least height whose row plan
    splits over two ranks at every level)."""
    rng = np.random.default_rng(3)
    rows_h = 64
    spatial = sharding.Spatial(mesh, rows_h, W)
    a, b = spatial.rows(0)
    rows = slice(a, b)
    halo = K // 2
    x = torch.from_numpy(rng.standard_normal((2, rows_h, W, 9)).astype(np.float32))
    got = sharding.fetch_rows(x[:, rows], spatial.plan.ranges[0],
                              [(c - halo, d + halo) for c, d in spatial.plan.ranges[0]], rank,
                              mesh.tile_group, 1)
    pad = torch.nn.functional.pad(x, (0, 0, 0, 0, halo, halo))
    want = pad[:, a:b + 2 * halo]
    out = {"halo": float((got - want).abs().max())}

    batch = scenes(2, 11, rows_h)
    depth = torch.from_numpy(batch["depths"][:, 0])
    kinv = invert_intrinsics(torch.from_numpy(batch["cams"][:, 0, 1, :3, :3]))
    normals = tiled_ops.depth_to_normal_tiled(depth[:, rows].contiguous(), kinv, spatial, K)
    want, _ = dispatch.depth_to_normal(depth, kinv, K)
    out["normals"] = float((normals - want[:, rows]).abs().max())

    images = torch.from_numpy(batch["images"])
    cams = torch.from_numpy(batch["cams"])
    ref_cam, src_cam = camera_from_array(cams[:, 0]), camera_from_array(cams[:, 1])
    vol = tiled_ops.cost_volume_tiled(images[:, 0, rows], images[:, 1, rows], ref_cam, src_cam,
                                      spatial, num_planes=PLANES)
    want = dispatch.cost_volume(images[:, 0], images[:, 1], ref_cam, src_cam, num_planes=PLANES)
    out["cost_volume"] = float((vol - want[:, rows]).abs().max())
    return out


class RecordGrads:
    """Keeps the gradients the optimizer is handed."""

    def __init__(self):
        self.grads = None
        self._update = tstate.Optimizer.update

    def __enter__(self):
        rec = self

        def update(opt, grads, state, params):
            rec.grads = {k: (v.clone() if v is not None else None) for k, v in grads.items()}
            return rec._update(opt, grads, state, params)

        tstate.Optimizer.update = update
        return self

    def __exit__(self, *exc):
        tstate.Optimizer.update = self._update


def one_step(cfg, batch, mesh):
    """One f64 step from the seed-0 weights (heads scaled by 0.05, as in
    ``tests/test_torch_train.py``): the new state, metrics and gradients.
    In f32 the train-mode gradient of this random net moves by 1e-2 under
    a 1e-7 change of its inputs, so a sum taken in another order (two
    ranks' partial sums) would hide any fault; in f64 the two steps agree
    to about 1e-12."""
    state = create_train_state(cfg, 0, "cpu")
    state.model.double()
    state.opt_state = tstate.make_optimizer(cfg).init(state.params())
    with torch.no_grad():
        for m in state.model.modules():
            if isinstance(m, DispHead):
                m[0].weight.mul_(0.05)
    with RecordGrads() as rec:
        state, metrics = make_train_step(cfg, mesh)(state, batch)
    metrics = {k: float(v) for k, v in metrics.items() if k != "viz"}
    return state, metrics, rec.grads


def compare(cfg, batch, local, mesh, rank):
    """One data-parallel step on this rank's samples; on the first rank, the
    one-process step on ``batch`` and the differences."""
    state, metrics, grads = one_step(cfg, local, mesh)
    valid = {"valid_count": int((local["disparity"] > 0).sum())}
    if rank != 0:
        return valid
    ref_state, ref_metrics, ref_grads = one_step(cfg, batch, None)
    diff = {"metrics": {k: abs(metrics[k] - v) / max(abs(v), 1e-12)
                        for k, v in ref_metrics.items()}}
    num = sum(float(((grads[k] - ref_grads[k]) ** 2).sum()) for k in grads)
    den = sum(float((ref_grads[k] ** 2).sum()) for k in grads)
    diff["grads_rel_l2"] = (num / den) ** 0.5
    diff["grad_norm"] = abs(metrics["grad_norm"] - ref_metrics["grad_norm"]) / ref_metrics["grad_norm"]
    sd, ref_sd = state.model.state_dict(), ref_state.model.state_dict()
    var = max(float(((sd[k] - ref_sd[k]).abs() / ref_sd[k].abs()).max())
              for k in sd if k.endswith("running_var"))
    mean = max(float(((sd[k] - ref_sd[k]).abs()
                      / ref_sd[k.replace("running_mean", "running_var")].sqrt()).max())
               for k in sd if k.endswith("running_mean"))
    diff["running_var"], diff["running_mean"] = var, mean
    diff["num_batches_tracked"] = all(torch.equal(sd[k], ref_sd[k]) for k in sd
                                      if k.endswith("num_batches_tracked"))
    diff["params"] = max(float((sd[k] - ref_sd[k]).abs().max())
                         for k, _ in state.model.named_parameters())
    return {**valid, **diff}


def cli_run(world, rank, out_dir):
    ckpt = os.path.join(out_dir, "ckpt")
    overrides = [f"parallel.coordinator_address=127.0.0.1:1",
                 f"parallel.num_processes={world}", f"parallel.process_id={rank}",
                 f"dataset.image_height={H}", f"dataset.image_width={W}",
                 f"model.num_planes={PLANES}", f"model.k_size={K}", "dataset.batch_size=1",
                 "dataset.synthetic_size=4", "train.ckpt_interval=100", "train.ckpt_keep=1",
                 f"train.checkpoint_dir={ckpt}", f"train.log_dir={out_dir}/logs"]
    cli.main(["train", "--synthetic", "--device", "cpu", "--max-steps", "2"] + overrides)
    first = sorted(os.listdir(ckpt))
    cli.main(["train", "--synthetic", "--device", "cpu", "--max-steps", "3"] + overrides
             + [f"train.resume_dir={ckpt}"])
    return {"first": first, "resumed": sorted(os.listdir(ckpt))}


def main():
    port, world, rank, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    result = {"ops": ops(pmesh.make_mesh(data=1, tile=world), world, rank)}
    mesh = pmesh.make_mesh()
    batch = global_batch()
    local = sharding.shard_batch(mesh, batch)
    result["step"] = compare(tiny_cfg(), batch, local, mesh, rank)
    # grad_accum 2: microbatch i is both ranks' i-th sample, so the
    # one-process step takes the global batch in that order
    order = [0, 2, 1, 3]
    result["accum"] = compare(tiny_cfg(2), {k: v[order] for k, v in batch.items()}, local, mesh,
                              rank)
    result["cli"] = cli_run(world, rank, out_dir)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
