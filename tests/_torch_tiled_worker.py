"""One rank of the port's tile-axis checks over gloo processes
(``tests/test_torch_tiled_mesh.py``, ``tests/test_torch_tiled_serve.py``).

    python tests/_torch_tiled_worker.py PORT WORLD RANK OUT_DIR PHASE...

Joins a gloo process group on ``tcp://127.0.0.1:PORT`` and runs each PHASE
in order on the CPU (8 planes, k = 5), writing ``OUT_DIR/rank<RANK>.json``
with what it measured; the tests assert on it.

* ``ops``: over a 1 x WORLD mesh, the row fetch (forward and backward, an
  uneven split), ``depth_to_normal_tiled`` with its gradient, the tiled
  cost volume, and a DownConvBlock + UpConvBlock under
  ``spatial_parallel`` (BatchNorm's sums over the ranks), each against the
  one-process computation on the whole image;
* ``step128``, ``step160``, ``remat``, ``accum``, ``step22``: one f64 train
  step over a 1 x 2 mesh at 128x32 and at 160x32 (5 rows at 1/32, split
  2/3), with ``remat_stages=2``, with ``grad_accum=2``, and over a 2 x 2
  mesh at 128x32, against the
  one-process step on the global batch, which the first rank also runs
  (``tests/_torch_distributed_worker.py``'s comparison and tolerances);
* ``serve``: ``InferenceSession(mesh=)`` at 2 x 1 (32x64) and 1 x 2
  (128x32) against the one-process session, both models in f64;
* ``cli``: ``cli eval --eval-tile 2`` over the group on ``OUT_DIR/seven``
  against the one-process eval, then ``cli train parallel.tile_axis=2``
  for one step;
* ``eval22``: the tiled 7-Scenes eval over a 2 x 2 mesh at 128x128 with the
  flax variables of ``OUT_DIR/variables.pkl`` on ``OUT_DIR/seven``.

Imports torch and the port only.
"""

import contextlib
import io
import json
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_distributed_worker import compare, tiny_cfg  # noqa: E402
from cnmnet_tpu_torch import cli  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import collate, normalize_images  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import quantize_images_u8  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu_torch.evals import seven_scenes_eval as teval  # noqa: E402
from cnmnet_tpu_torch.geometry.camera import camera_from_array  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch  # noqa: E402
from cnmnet_tpu_torch.models import layers  # noqa: E402
from cnmnet_tpu_torch.models.transplant import load_flax_variables  # noqa: E402
from cnmnet_tpu_torch.parallel import collectives  # noqa: E402
from cnmnet_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from cnmnet_tpu_torch.parallel import sharding, tiled_ops  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession, MicroBatcher  # noqa: E402
from cnmnet_tpu_torch.train.state import build_model  # noqa: E402

PLANES, K = 8, 5


def scenes(n, h, w, seed):
    ds = SyntheticScenes(num_samples=n, height=h, width=w, view_num=3, seed=seed)
    batch = collate([ds[i] for i in range(n)])
    batch.pop("index")
    batch["images"] = normalize_images(batch["images"])
    return batch


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


# -- ops ----------------------------------------------------------------------------


def ops(rank, world):
    mesh = pmesh.make_mesh(data=1, tile=world)
    g = torch.Generator().manual_seed(0)
    out = {}

    # the fetch at an uneven split: 5 rows over the ranks, each reading a
    # conv's halo, integer values so that every sum is exact
    ranges = pmesh.split_rows(5, world)
    needs = [(a - 1, b + 1) for a, b in ranges]
    x = torch.randint(-8, 8, (2, 3, 5, 4), generator=g).double()
    r = [torch.randint(-8, 8, (2, 3, b - a, 4), generator=g).double() for a, b in needs]
    mine = x[:, :, ranges[rank][0]:ranges[rank][1]].clone().requires_grad_(True)
    got = sharding.fetch_rows(mine, ranges, needs, rank, mesh.tile_group, 2)
    (grad,) = torch.autograd.grad((got * r[rank]).sum(), [mine])
    shards = [x[:, :, a:b].clone().requires_grad_(True) for a, b in ranges]
    want = [sharding.rows_from_shards(shards, ranges, n, 2) for n in needs]
    wgrad = torch.autograd.grad(sum((w * ri).sum() for w, ri in zip(want, r)), shards)
    out["fetch"] = torch.equal(got, want[rank]) and torch.equal(grad, wgrad[rank])

    # depth->normal with its gradient across the halo (f64, plain version)
    H, W = 64, 12
    sp = sharding.Spatial(mesh, H, W)
    a, b = sp.rows(0)
    depth = 2.0 + 0.3 * torch.randn(2, H, W, generator=g, dtype=torch.float64)
    kinv = torch.linalg.inv(torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]],
                                         dtype=torch.float64)).expand(2, 3, 3).contiguous()
    rn = torch.randn(2, H, W, 3, generator=g, dtype=torch.float64)
    d = depth[:, a:b].clone().requires_grad_(True)
    n = tiled_ops.depth_to_normal_tiled(d, kinv, sp, K)
    (gd,) = torch.autograd.grad((n * rn[:, a:b]).sum(), [d])
    gd = collectives.all_gather(gd, mesh.tile_group)  # (every rank's rows' gradient)
    dr = depth.clone().requires_grad_(True)
    nw, _ = dispatch.depth_to_normal(dr, kinv, K)
    (gw,) = torch.autograd.grad((nw * rn).sum(), [dr])
    out["normals"] = float((n.detach() - nw.detach()[:, a:b]).abs().max())
    out["normals_grad"] = rel(torch.cat(gd, 1), gw)

    # the tiled cost volume against the untiled one
    batch = scenes(2, H, 32, 11)
    images, cams = torch.from_numpy(batch["images"]), torch.from_numpy(batch["cams"])
    sp = sharding.Spatial(mesh, H, 32)
    a, b = sp.rows(0)
    rc, sc = camera_from_array(cams[:, 0]), camera_from_array(cams[:, 1])
    vol = tiled_ops.cost_volume_tiled(images[:, 0, a:b], images[:, 1, a:b], rc, sc, sp,
                                      num_planes=PLANES)
    want = dispatch.cost_volume(images[:, 0], images[:, 1], rc, sc, num_planes=PLANES)
    out["cost_volume"] = float((vol - want[:, a:b]).abs().max())

    # a stride-2 block and an upsampling block, BatchNorm over both ranks
    net = torch.nn.Sequential(layers.DownConvBlock(3, 8, 3), layers.UpConvBlock(8, 4, 3))
    layers.init_weights(net, torch.Generator().manual_seed(1))
    net.double().train()
    x = torch.randn(2, 3, H, 16, generator=g, dtype=torch.float64)
    r = torch.randn(2, 4, H, 16, generator=g, dtype=torch.float64)
    sp = sharding.Spatial(mesh, H, 16)
    a, b = sp.rows(0)
    xs = x[:, :, a:b].clone().requires_grad_(True)
    with sharding.data_parallel(net, mesh.mesh_group), sharding.spatial_parallel(net, sp):
        y = net(xs)
    params = list(net.parameters())
    grads = torch.autograd.grad((y * r[:, :, a:b]).sum(), [xs] + params)
    pg = [collectives.all_reduce_(p.clone(), mesh.tile_group) for p in grads[1:]]
    xr = x.clone().requires_grad_(True)
    yw = net(xr)
    want = torch.autograd.grad((yw * r).sum(), [xr] + params)
    out["block"] = rel(y, yw[:, :, a:b])
    out["block_grad_x"] = rel(grads[0], want[0][:, :, a:b])
    out["block_grad_params"] = max(rel(p, q) for p, q in zip(pg, want[1:]))
    return out


# -- train steps --------------------------------------------------------------------


def tiled_batch(n, h, w, seed):
    """``n`` samples whose top rows have no ground truth (sample ``i``
    loses ``8 (i + 1)`` rows), so the tile ranks hold different valid
    counts. Every float field in f64: the CNM target's plane means sum the
    ground-truth normals over the rows of all tile ranks, and in f32 that
    sum, taken in two parts, moves the normal terms by 2e-10."""
    batch = scenes(n, h, w, seed)
    for i in range(n):
        rows = 8 * (i + 1)
        batch["depths"][i, :, :rows] = 0.0
        batch["disparity"][i, :rows] = 0.0
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


def step(rank, data, tile, h, w=32, accum=1, **model):
    mesh = pmesh.make_mesh(data=data, tile=tile)
    cfg = tiny_cfg(accum)
    cfg.dataset.image_height, cfg.dataset.image_width = h, w
    for k, v in model.items():
        setattr(cfg.model, k, v)
    batch = tiled_batch(2 * data, h, w, 7)
    local = sharding.shard_batch(mesh, batch)
    a, b = sharding.Spatial(mesh, h, w).rows(0)
    result = compare(cfg, batch, local, mesh, rank)
    result["valid_count"] = int((local["disparity"][:, a:b] > 0).sum())
    return result


# -- serving ----------------------------------------------------------------------


def serve(rank, world):
    out = {}
    for data, tile, h, w in ((2, 1, 32, 64), (1, 2, 128, 32)):
        mesh = pmesh.make_mesh(data=data, tile=tile)
        cfg = tiny_cfg()
        kw = dict(cfg=cfg, batch_buckets=(1, 4), device="cpu")
        session = InferenceSession(mesh=mesh, **kw)
        session.model.double()  # f64 throughout (the norm layers too)
        b = scenes(3, h, w, 5)
        u8 = quantize_images_u8(b["images"])
        cams = b["cams"].astype(np.float32)
        key = f"{data}x{tile}"
        if rank != 0:
            out[key] = {"served": session.follow()}
            continue
        got = session.predict(u8, cams)
        batcher = MicroBatcher(session, max_batch=4, max_wait_ms=50.0)
        futures = [batcher.submit(u8[i], cams[i]) for i in range(3)]
        batched = [f.result(timeout=120) for f in futures]
        batcher.close()
        refused = ""
        if tile > 1:
            try:
                session.predict(quantize_images_u8(scenes(1, 64, w, 5)["images"]), cams[:1])
            except ValueError as e:
                refused = str(e)
        session.close()
        plain = InferenceSession(**kw)
        plain.model.double()
        want = plain.predict(u8, cams)
        out[key] = {
            "buckets": list(session.buckets),
            "diff": {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
                     for k in want},
            "batcher": max(float(np.abs(f[k] - want[k][i]).max() / max(np.abs(want[k]).max(),
                                                                      1e-30))
                           for i, f in enumerate(batched) for k in want),
            "refused": refused,
        }
    return out


# -- the command line ------------------------------------------------------------------


def cli_phase(rank, world, out_dir):
    root = os.path.join(out_dir, "seven")
    small = [f"model.num_planes={PLANES}", f"model.k_size={K}", "dataset.image_height=128",
             "dataset.image_width=64", f"dataset.root_dir={root}",
             "parallel.coordinator_address=127.0.0.1:1", f"parallel.num_processes={world}",
             f"parallel.process_id={rank}"]
    seen = []
    real = teval.evaluate_seven_scenes

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    teval.evaluate_seven_scenes = spy
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            cli.main(["eval", "--views", "3", "--device", "cpu", "--eval-tile", "2",
                      "--max-frames-per-seq", "3"] + small)
    finally:
        teval.evaluate_seven_scenes = real
    out = {"lines": [ln for ln in text.getvalue().splitlines() if ln.startswith("eval mesh")]}
    if rank == 0:
        cfg = cli._build_config(argparse_namespace(small))
        fwd = teval.make_eval_forward(cli._restored_model(cfg, None), k_size=K, device="cpu")
        want = real(fwd, root, num_sources=2, image_height=128, image_width=64,
                    max_frames_per_seq=3)
        out["frames"] = [seen[0]["frames"], want["frames"]]
        out["metrics"] = {k: abs(seen[0][k] - v) / max(abs(v), 1e-12) for k, v in want.items()
                          if k not in ("seconds_per_frame", "frames")}
    ckpt = os.path.join(out_dir, "ckpt")
    cli.main(["train", "--synthetic", "--device", "cpu", "--max-steps", "1",
              "parallel.tile_axis=2", "dataset.batch_size=1", "dataset.synthetic_size=2",
              "dataset.image_width=32", "train.ckpt_interval=100", "train.ckpt_keep=1",
              f"train.checkpoint_dir={ckpt}", f"train.log_dir={out_dir}/logs"]
             + [o for o in small if "root_dir" not in o and "image_width" not in o])
    out["train"] = sorted(os.listdir(ckpt))
    return out


def argparse_namespace(overrides):
    import argparse

    return argparse.Namespace(config=None, overrides=overrides)


# -- 7-Scenes over a 2 x 2 mesh ---------------------------------------------------------


def eval22(rank, world, out_dir):
    mesh = pmesh.make_mesh(data=2, tile=2)
    cfg = tiny_cfg()
    cfg.dataset.image_height = cfg.dataset.image_width = 128
    model = build_model(cfg)
    with open(os.path.join(out_dir, "variables.pkl"), "rb") as f:
        load_flax_variables(model, pickle.load(f))
    fwd = teval.make_eval_forward(model, k_size=K, device="cpu", mesh=mesh)
    result = teval.evaluate_seven_scenes(
        fwd, os.path.join(out_dir, "seven"), num_sources=2, image_height=128, image_width=128,
        max_frames_per_seq=6, seqs=[("chess", "seq-03")], frame_batch=2, mesh=mesh)
    return {k: v for k, v in result.items() if k != "seconds_per_frame"}


def main():
    port, world, rank, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    phases = {
        "ops": lambda: ops(rank, world),
        "step128": lambda: step(rank, 1, 2, 128),
        "step160": lambda: step(rank, 1, 2, 160),
        "remat": lambda: step(rank, 1, 2, 128, remat=True, remat_stages=2),
        "accum": lambda: step(rank, 1, 2, 128, accum=2),
        "step22": lambda: step(rank, 2, 2, 128),
        "serve": lambda: serve(rank, world),
        "cli": lambda: cli_phase(rank, world, out_dir),
        "eval22": lambda: eval22(rank, world, out_dir),
    }
    result = {name: phases[name]() for name in sys.argv[5:]}
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
