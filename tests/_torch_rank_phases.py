"""The phases of the port's rank tests (``tests/test_torch_ranks.py``).

``cnmnet_tpu_torch/tools/_ranks.run_calls`` calls each phase as
``fn(device, *args)`` in every rank of one gloo group on the CPU, 8 planes
and k = 5; each returns what its rank measured, as JSON, and the tests
assert on it. Imports torch and the port only.

* ``halo_ops``: over a 1 x WORLD mesh at 64x64, the row fetch of a halo
  and both tiled ops against the untiled port ops on the global image;
* ``tiled_ops``: over a 1 x WORLD mesh, the row fetch (forward and
  backward, an uneven split), ``depth_to_normal_tiled`` with its gradient,
  the tiled cost volume, and a DownConvBlock + UpConvBlock under
  ``spatial_parallel`` (BatchNorm's sums over the ranks), each against the
  one-process computation on the whole image;
* ``references``: the one-process f64 train steps of ``REFERENCES``, each
  computed once, by the rank that ``step`` compares against it, and kept
  in that rank's process for the group's later calls;
* ``step``: one f64 train step over a ``data x tile`` mesh whose ranks
  hold different numbers of valid ground-truth pixels; the rank holding
  the reference returns the differences from it;
* ``serve``: ``InferenceSession(mesh=)`` at 2 x 1 (32x64) and 1 x 2
  (128x32) against the one-process session, both models in f64;
* ``cli_train``: ``cli train`` with a coordinator address over the group,
  2 steps into one shared checkpoint directory, then a resume to step 3;
* ``cli_tile``: ``cli eval --eval-tile 2`` over the group on
  ``OUT_DIR/seven`` against the one-process eval, then ``cli train
  parallel.tile_axis=2`` for one step;
* ``eval22``: the tiled 7-Scenes eval over a 2 x 2 mesh at 128x128 with the
  flax variables of ``OUT_DIR/variables.pkl`` on ``OUT_DIR/seven``.
"""

import argparse
import contextlib
import copy
import io
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from cnmnet_tpu_torch import cli
from cnmnet_tpu_torch.config import Config
from cnmnet_tpu_torch.data.pipeline import collate, normalize_images, quantize_images_u8
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
from cnmnet_tpu_torch.evals import seven_scenes_eval as teval
from cnmnet_tpu_torch.geometry.camera import camera_from_array, invert_intrinsics
from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.models import layers
from cnmnet_tpu_torch.models.layers import DispHead
from cnmnet_tpu_torch.models.transplant import load_flax_variables
from cnmnet_tpu_torch.parallel import collectives
from cnmnet_tpu_torch.parallel import mesh as pmesh
from cnmnet_tpu_torch.parallel import sharding, tiled_ops as tops
from cnmnet_tpu_torch.serve import InferenceSession, MicroBatcher
from cnmnet_tpu_torch.train import make_train_step
from cnmnet_tpu_torch.train import state as tstate
from cnmnet_tpu_torch.train.state import build_model

PLANES, K, W = 8, 5, 32

# The one-process steps the mesh steps are held to: (height, samples,
# grad_accum). 64 rows is the least height whose row plan splits over two
# tile ranks (``parallel/mesh.least_height``); 96 rows has 3 rows at 1/32,
# split 1/2. Under ``grad_accum`` 2 the global batch runs in the order
# ``ACCUM_ORDER``: microbatch ``i`` is both data ranks' ``i``-th sample.
REFERENCES = {"even": (64, 2, 1), "even_accum": (64, 4, 2), "uneven": (96, 2, 1)}
ACCUM_ORDER = [0, 2, 1, 3]
_HELD = {}  # this process's references, by name
_STARTS = {}  # this process's start models, by model config


def tiny_cfg(accum=1):
    cfg = Config()
    cfg.model.num_planes = PLANES
    cfg.model.k_size = K
    cfg.dataset.batch_size = 2
    cfg.train.grad_accum = accum
    return cfg


def scenes(n, h, w, seed):
    ds = SyntheticScenes(num_samples=n, height=h, width=w, view_num=3, seed=seed)
    batch = collate([ds[i] for i in range(n)])
    batch.pop("index")
    batch["images"] = normalize_images(batch["images"])
    return batch


def rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


# -- ops ----------------------------------------------------------------------------


def halo_ops(device):
    """Largest differences of each rank's tiled results from the untiled
    op's rows (0 = bit-equal), at 64 rows (the least height whose row plan
    splits over two ranks at every level)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = pmesh.make_mesh(data=1, tile=world)
    rng = np.random.default_rng(3)
    h, w = 64, 64
    spatial = sharding.Spatial(mesh, h, w)
    a, b = spatial.rows(0)
    rows = slice(a, b)
    halo = K // 2
    x = torch.from_numpy(rng.standard_normal((2, h, w, 9)).astype(np.float32))
    got = sharding.fetch_rows(x[:, rows], spatial.plan.ranges[0],
                              [(c - halo, d + halo) for c, d in spatial.plan.ranges[0]], rank,
                              mesh.tile_group, 1)
    pad = torch.nn.functional.pad(x, (0, 0, 0, 0, halo, halo))
    want = pad[:, a:b + 2 * halo]
    out = {"halo": float((got - want).abs().max())}

    batch = scenes(2, h, w, 11)
    depth = torch.from_numpy(batch["depths"][:, 0])
    kinv = invert_intrinsics(torch.from_numpy(batch["cams"][:, 0, 1, :3, :3]))
    normals = tops.depth_to_normal_tiled(depth[:, rows].contiguous(), kinv, spatial, K)
    want, _ = dispatch.depth_to_normal(depth, kinv, K)
    out["normals"] = float((normals - want[:, rows]).abs().max())

    images = torch.from_numpy(batch["images"])
    cams = torch.from_numpy(batch["cams"])
    ref_cam, src_cam = camera_from_array(cams[:, 0]), camera_from_array(cams[:, 1])
    vol = tops.cost_volume_tiled(images[:, 0, rows], images[:, 1, rows], ref_cam, src_cam,
                                 spatial, num_planes=PLANES)
    want = dispatch.cost_volume(images[:, 0], images[:, 1], ref_cam, src_cam, num_planes=PLANES)
    out["cost_volume"] = float((vol - want[:, rows]).abs().max())
    return out


def tiled_ops(device):
    rank, world = dist.get_rank(), dist.get_world_size()
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
    H, Wd = 64, 12
    sp = sharding.Spatial(mesh, H, Wd)
    a, b = sp.rows(0)
    depth = 2.0 + 0.3 * torch.randn(2, H, Wd, generator=g, dtype=torch.float64)
    kinv = torch.linalg.inv(torch.tensor([[30.0, 0, Wd / 2], [0, 30.0, H / 2], [0, 0, 1]],
                                         dtype=torch.float64)).expand(2, 3, 3).contiguous()
    rn = torch.randn(2, H, Wd, 3, generator=g, dtype=torch.float64)
    d = depth[:, a:b].clone().requires_grad_(True)
    n = tops.depth_to_normal_tiled(d, kinv, sp, K)
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
    vol = tops.cost_volume_tiled(images[:, 0, a:b], images[:, 1, a:b], rc, sc, sp,
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


def global_batch(h, n):
    """``n`` samples at ``h`` x 32 whose top rows have no ground truth
    (sample ``i`` loses ``8 (i + 1)`` rows), so the data ranks and the tile
    ranks hold different valid counts. Every float field in f64: the CNM
    target's plane means sum the ground-truth normals over the rows of all
    tile ranks, and in f32 that sum, taken in two parts, moves the normal
    terms by 2e-10."""
    batch = scenes(n, h, W, 7)
    for i in range(n):
        rows = 8 * (i + 1)
        batch["depths"][i, :, :rows] = 0.0
        batch["disparity"][i, :rows] = 0.0
    return {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in batch.items()}


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


def start_model(cfg):
    """The f64 model of ``cfg.model`` with the seed-0 weights, the heads
    scaled by 0.05 (as in ``tests/test_torch_train.py``): a copy of the one
    this process built first."""
    key = repr(cfg.model)
    if key not in _STARTS:
        model = build_model(cfg)
        layers.init_weights(model, torch.Generator().manual_seed(0))
        model.double()
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, DispHead):
                    m[0].weight.mul_(0.05)
        _STARTS[key] = model
    return copy.deepcopy(_STARTS[key])


def one_step(cfg, batch, mesh):
    """One f64 step from ``start_model``: the stepped model, the metrics and
    the gradients. In f32 the train-mode gradient of this
    random net moves by 1e-2 under a 1e-7 change of its inputs, so a sum
    taken in another order (two ranks' partial sums) would hide any fault;
    in f64 the two steps agree to about 1e-12."""
    model = start_model(cfg)
    opt_state = tstate.make_optimizer(cfg).init(dict(model.named_parameters()))
    state = tstate.TrainState(model=model, opt_state=opt_state)
    with RecordGrads() as rec:
        state, metrics = make_train_step(cfg, mesh)(state, batch)
    return state.model, {k: float(v) for k, v in metrics.items() if k != "viz"}, rec.grads


def _reference_cfg(name, **model):
    h, _, accum = REFERENCES[name]
    cfg = tiny_cfg(accum)
    cfg.dataset.image_height, cfg.dataset.image_width = h, W
    for k, v in model.items():
        setattr(cfg.model, k, v)
    return cfg


def references(device, holders):
    """Compute the one-process step of each ``REFERENCES`` name that
    ``holders`` (name -> rank) gives this rank, and keep it."""
    rank = dist.get_rank()
    for name, holder in holders.items():
        if holder == rank:
            h, n, accum = REFERENCES[name]
            batch = global_batch(h, n)
            if accum > 1:
                batch = {k: v[ACCUM_ORDER] for k, v in batch.items()}
            _HELD[name] = one_step(_reference_cfg(name), batch, None)
    return sorted(_HELD)


def step(device, ref, data, tile, order=None, model=None):
    """One step over a ``data x tile`` mesh on the global batch of
    ``REFERENCES[ref]`` (in ``order``), with the ``cfg.model`` fields of
    ``model`` set; every rank returns its valid count, the rank holding
    ``ref`` the differences from it."""
    mesh = pmesh.make_mesh(data=data, tile=tile)
    h, n, _ = REFERENCES[ref]
    batch = global_batch(h, n)
    if order is not None:
        batch = {k: v[order] for k, v in batch.items()}
    local = sharding.shard_batch(mesh, batch)
    net, metrics, grads = one_step(_reference_cfg(ref, **(model or {})), local, mesh)
    a, b = sharding.Spatial(mesh, h, W).rows(0)
    out = {"valid_count": int((local["disparity"][:, a:b] > 0).sum())}
    if ref not in _HELD:
        return out
    ref_net, ref_metrics, ref_grads = _HELD[ref]
    sd, ref_sd = net.state_dict(), ref_net.state_dict()
    out["metrics"] = {k: abs(metrics[k] - v) / max(abs(v), 1e-12)
                      for k, v in ref_metrics.items()}
    num = sum(float(((grads[k] - ref_grads[k]) ** 2).sum()) for k in grads)
    den = sum(float((ref_grads[k] ** 2).sum()) for k in grads)
    out["grads_rel_l2"] = (num / den) ** 0.5
    ref_norm = ref_metrics["grad_norm"]
    out["grad_norm"] = abs(metrics["grad_norm"] - ref_norm) / ref_norm
    out["running_var"] = max(float(((sd[k] - ref_sd[k]).abs() / ref_sd[k].abs()).max())
                             for k in sd if k.endswith("running_var"))
    out["running_mean"] = max(
        float(((sd[k] - ref_sd[k]).abs() / ref_sd[k.replace("running_mean", "running_var")].sqrt())
              .max())
        for k in sd if k.endswith("running_mean"))
    out["num_batches_tracked"] = all(torch.equal(sd[k], ref_sd[k]) for k in sd
                                     if k.endswith("num_batches_tracked"))
    out["params"] = max(float((sd[k] - ref_sd[k]).abs().max()) for k, _ in net.named_parameters())
    return out


# -- serving ----------------------------------------------------------------------


def serve(device):
    rank = dist.get_rank()
    out = {}
    for data, tile, h, w in ((2, 1, 32, 64), (1, 2, 128, 32)):
        mesh = pmesh.make_mesh(data=data, tile=tile)
        kw = dict(cfg=tiny_cfg(), batch_buckets=(1, 4), device="cpu")
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


def _over_the_group():
    return ["parallel.coordinator_address=127.0.0.1:1",
            f"parallel.num_processes={dist.get_world_size()}",
            f"parallel.process_id={dist.get_rank()}"]


def cli_train(device, out_dir):
    ckpt = os.path.join(out_dir, "ckpt")
    overrides = _over_the_group() + [
        "dataset.image_height=32", "dataset.image_width=64", f"model.num_planes={PLANES}",
        f"model.k_size={K}", "dataset.batch_size=1", "dataset.synthetic_size=4",
        "train.ckpt_interval=100", "train.ckpt_keep=1", f"train.checkpoint_dir={ckpt}",
        f"train.log_dir={out_dir}/logs"]
    cli.main(["train", "--synthetic", "--device", "cpu", "--max-steps", "2"] + overrides)
    first = sorted(os.listdir(ckpt))
    cli.main(["train", "--synthetic", "--device", "cpu", "--max-steps", "3"] + overrides
             + [f"train.resume_dir={ckpt}"])
    return {"first": first, "resumed": sorted(os.listdir(ckpt))}


def cli_tile(device, out_dir):
    root = os.path.join(out_dir, "seven")
    small = [f"model.num_planes={PLANES}", f"model.k_size={K}", "dataset.image_height=128",
             "dataset.image_width=64", f"dataset.root_dir={root}"] + _over_the_group()
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
    if dist.get_rank() == 0:
        cfg = cli._build_config(argparse.Namespace(config=None, overrides=small))
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


# -- 7-Scenes over a 2 x 2 mesh ---------------------------------------------------------


def eval22(device, out_dir):
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
