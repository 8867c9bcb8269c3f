"""Smoke run of cnmnet_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``cnmnet_tpu_torch/kernels/csrc`` (one nvcc per
source, in parallel), then:

1. prints the card (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit) and turns TF32 off for the f32 checks;
2. holds each kernel against its plain PyTorch version on the card, asking
   for exact agreement (max abs error 0): the cost volume at the serving
   shapes (2, 8, 16 and, at seven views, 48 pairs, 192x256, 64 planes) in
   f32 and bf16, at (30, 100, 6), (40, 130, 9), an odd width (3 pairs, 31,
   97, 5) and 480x640x64, and under coefficients that
   put taps at and beyond every edge of the source and past the coordinate
   clip; depth->normal at B in {1, 4, 8} x k in {5, 9} at 192x256, at 480x640
   and at an odd size, also judged against the plain version in f64; the
   k-generic depth->normal at k = 19, 31, 89 and 129 (B = 2, 192x256) with
   its times and bounds; the cost volume past 2^31 elements (110 pairs at
   480x640, 64 planes, bf16: two launches, the pairs at every chunk edge
   against the plain version, its time and bound) and, with the limit
   lowered, in chunks of pairs, of one pair's planes and of a row shard;
   depth->normal with the batch limit lowered (8 maps in 3 launches);
3. serves the 3-view refined forward at full width (CNMModel, 64 planes,
   192x256, bf16, seeded weights whose BatchNorm statistics are taken from
   synthetic frames) through ``InferenceSession.predict`` on
   requests of batch 1 (uint8), 3 (f32, padded to bucket 4) and 8, and on an
   f16 wire, with both kernels' launch counters set to 0 just before and
   read just after, and on uint8 seven-view requests (six sources, 48
   pairs a bucket of 8) of batch 1, 3 (padded to 4) and 8: every dispatch
   one CUDA graph replay equal to the eager nets bit for bit, with one
   launch of each kernel; the bilinear upsampling kernel inside the graphs,
   its counter zeroed just before: 11 launches in each capture's eager pass
   and 11 in the capture, and 11 a replay (``upsample_replayed``: 100% of
   the replays engaged), 11 a batch of the eager nets, none in the plain
   session; checks shapes, ranges, unit normals, the bf16
   session against an f32 one, the f32 kernel session against an f32
   session of plain versions, and that every norm layer of the bf16 session
   keeps f32 parameters and statistics;
4. times each kernel at the shapes of buckets 1 and 8 (cost volume: 2 and
   16 pairs; depth->normal: B = 1 and 8) beside its bound, and its plain
   version at bucket 1 (CUDA events, median of 20 runs after warm-up), and
   ``predict`` at buckets 1 and 8; the upsampling kernel on the 11 maps the
   eager nets of phase 3 upsampled at buckets 1 and 8, three and seven
   views (bf16), against ``F.interpolate`` (max abs error 0, equal bits),
   the batch's time beside its bound and ``F.interpolate``'s;
5. traces one ``predict`` at buckets 1 and 8 (torch.profiler), prints the
   device's busy time, its idle share and the kernels that take the time,
   and fails if a batch norm kernel ran with bf16 statistics;
6. trains at full width (3 views, 192x256, 64 planes, k = 9, batch 2, f32,
   the full CNM recipe with the refiner, Adam): 8 steps of ``train_loop``
   on synthetic scenes with a ``CheckpointManager``, the launch counters
   set to 0 just before and read just after (the cost volume once a step,
   depth->normal three times, each with a gradient; the upsampling kernel
   never in phases 6 and 7, which run NCHW), finite losses;
   restores the last checkpoint bit-equal into a fresh state; 10 steps on
   one fixed batch, whose loss must fall; the depth->normal Function's
   forward and depth gradient against plain autograd (max abs 0); one
   whole step with the kernels against one with the plain versions (loss
   terms to 1e-5 relative, gradients to 1e-4 relative L2); and the times:
   the train step (median of 5 after 2 warm-ups with TF32 off, of 10 after
   3 under PyTorch's defaults), depth->normal with its plain backward, and
   one traced step by kernel class;
7. evaluates at full width (CNMModel, 64 planes, 192x256, k = 9, f32,
   seeded weights with BatchNorm statistics from synthetic frames) on a
   mock 7-Scenes tree written with the port's ``write_png`` (two test
   sequences of 40 frames at 480x640): the four protocols through
   ``evaluate_seven_scenes`` and ``make_eval_forward`` at frame batch 1,
   the 3-view one also at 4, the launch counters set to 0 just before each
   run and read just after (one cost volume and one depth->normal per
   flush), the frame census and finite metrics; (a) an oracle of the true
   inverse depth scores abs_rel < 1e-3 and a1 = 1, (b) every flush's
   idepth, prob and normal equal the plain versions' on the same inputs
   (max abs error 0: the cost volume on 1, 2, 4, 6 and 8 pairs in f32,
   depth->normal on 1 and 4 maps), (c) frame batch 4 gives frame batch
   1's metrics (1e-4 relative; a1-a3 3e-5 absolute) under cuDNN TF32 on
   and, on four frames, off, (d) ``cal_metrics`` re-scores the oracle's
   artifacts (5e-3 relative, 1e-3 absolute); ``evaluate_scannet`` and
   ``evaluate_scannet_planes`` on 4 normalised synthetic scenes with
   non-planar pixels (one launch of each kernel per sample, every output
   equal to the plain versions'); ms per frame under PyTorch's defaults
   (cuDNN TF32 on) as the median of 30 repeats of one flush per protocol,
   and one traced 3-view flush at frame batch 1 and 4;
8. serves under load and runs the command line: (a) the serving session
   of phase 3 behind a ``MicroBatcher`` (max_batch 8, max_wait 5 ms), 16
   client threads in a closed loop of 8 requests each, with the launch
   counters around the run (one launch of each kernel per dispatched
   batch): requests/s, p50, p99 and max latency, the mean coalesced batch;
   then 16 x 64 requests, whose p99 and max are also given without each
   client's first request (the round in which all start at once); one
   client alone against ``predict`` at bucket 1; the chain slope of the
   forward (``obs/timing``) beside its CUDA-event time; every future's
   idepth within 1e-4 of ``predict`` on its own request (f32, TF32 off,
   one bucket); the reference faults the port does not copy (mixed
   signatures, a cancelled future, a malformed request, ``max_batch`` above
   the top bucket), each result against ``predict`` on the same chunk;
   ``predict_async`` with two handles in flight equal to ``predict``; (b)
   ``cnmnet_tpu_torch.cli.main`` in this process under PyTorch's defaults
   (cuDNN TF32 on): ``train --synthetic --max-steps 6`` (6 cost volumes, 18
   depth->normals, scalar records, PNG summaries, a step-6 checkpoint),
   ``eval`` on a mock 7-Scenes tree (metrics equal to
   ``evaluate_seven_scenes`` with the restored weights, 1e-6 relative),
   ``cal-metrics``, ``eval-scannet --synthetic --planes``, ``infer`` over 8
   frames (equal to ``InferenceSession(checkpoint="latest").predict`` on the
   same batches) and ``export-tb`` (the scalars of ``events.jsonl``), each
   with its seconds and launches.

9. trains at scale: (a) the phase-6 step in bf16 (convs in bf16; f32
   parameters, Adam moments and norm statistics): one cost volume and
   three depth->normals a step, a conv's output in bf16, the first step's
   loss terms against the f32 step from the same weights (the CPU test's
   bf16 tolerances: 2e-2 relative, 5e-2 for the normal terms), its
   ``grad_norm`` (2e-2) and the gradient with running statistics (0.2
   relative L2),
   the median of 10 steps after 3 warm-ups and one trace; (b) the bf16
   step at 480x640, batch 4, with remat off, ``remat_stages=-1``, ``2``,
   and ``2`` with ``remat_refiner``: ``torch.cuda.max_memory_allocated``
   and the median step time, each remat step's loss terms, running
   statistics against the plain step (1e-3 relative), its ``grad_norm``
   (5e-3) and Adam's first moment (5e-2 relative L2; the plain step rerun
   is the floor), and both kernels against their plain versions at this
   path's shapes (8 pairs f32 and bf16, 4 depth maps); (c) the tile axis
   emulated on one card, tile 2 and 4 at
   192x256 and 480x640: every row shard's launch with its global row
   offset (depth rows with their halo, reference rows against the whole
   source), the shards equal to the untiled kernel and each to the plain
   version with its offset (max abs 0), each shard's time against the
   untiled launch, with its bound; (d) ``torch.distributed`` on NCCL at
   world size 1: one ``make_train_step(cfg, make_mesh())`` step against
   the plain step from the same weights (loss terms, running statistics
   and ``grad_norm`` within 1e-3, Adam's first moment within 0.1), then ``cli train`` with ``parallel.coordinator_address`` for 2
   steps and a resume to step 3. The launch counters are set to 0 just
   before each path and read just after.
10. runs the tile axis through the conv stack and serving and evaluation on
   a mesh: two processes on the one card (gloo; CUDA tensors cross through
   host memory), over a 1 x 2 mesh, then a 2 x 1 mesh, at full width
   (``mesh_phase``): the f32 step at 192x256, batch 2, TF32 off, against
   the one-process step (loss terms and running statistics within 1e-3,
   ``grad_norm`` within 5e-3); at tile 2 the bf16 step at 480x640, batch 4, remat off,
   with each rank's peak memory and median step time; a 3-view eval flush at
   480x640 and the mesh session (rank 0 answers, rank 1 follows) against
   one process (idepth and prob within 1e-2, idepth relative L2 1e-4; the
   normals equal to the untiled kernel's on the same depth); every kernel
   launch of every rank equal to its plain version on its own inputs (max
   abs 0), and each rank's launch counters on each path (one cost volume
   and three depth->normals a step, one of each a flush and a batch).

11. runs the offline tools, the native loader and imported checkpoints at
   full width under PyTorch's defaults (``offline_phase``). It first looks
   for ``g++`` and for ``jpeglib.h`` and ``png.h`` on the compiler's include
   path and prints what it found. With them, or else where cv2 imports:
   (a) a raw ScanNet-layout scene (30 frames at 480x640 ray-cast from a
   ``data/synthetic`` room, JPEGs written by a small C helper against the
   same libjpeg, or by cv2) through ``cli prep-cameras``, ``prep-planes``
   and ``prep-list``, ``cli train`` on the prepared tree for 3 steps with
   every sample on the native loader's path, or on the cv2 path of
   ``ScanNetDataset(use_native=False)`` (one cost volume and three
   depth->normals a step, finite losses), and ``cli eval-scannet --planes``
   on its checkpoint; with the headers, (b) the native loader
   built from ``data/native/loader.cc`` into ``build/``: its decode against
   the arrays the JPEGs were written from (JPEG's loss), its normalised
   RGB against its uint8 RGB, its depth exactly against ``read_png`` +
   ``resize_nearest`` + the clamp, and ``load_frames`` ms per frame at 1
   and 4 threads from 1296x968. With neither only the steps that need no
   JPEG run: ``prep-cameras`` and ``prep-planes``. Then ``cli eval
   --save-dir`` on a mock 7-Scenes tree and ``cli report`` over it (every
   artifact PNG referenced by its sequence page), and (c) a reference
   checkpoint through ``import_checkpoint --torch-ckpt`` and a converter
   ``.npz`` through ``--npz``, each served by ``cli infer --checkpoint``
   equal to ``InferenceSession(state_dict=...)`` on the same weights (max
   abs 0), and one train step resumed from the ``.npz`` import, whose
   restored moments equal the ones written. Each command with its seconds
   and launches.

12. runs the measurement surface at full width under PyTorch's defaults
   (``measure_phase``), each tool in this process through its ``main`` with
   the launch counters around it: ``cli bench`` at 192x256 and 480x640,
   ``bench_batched`` at batch 1, 4, 8, 16, ``bench_protocols`` (3, 5, 7
   views at 192x256; 3 at 480x640), the roofline's eight phases (no share
   above 100%), ``profile_forward`` at batch 8 and ``profile_train`` (bf16,
   batch 2), ``bench_serving`` open loop at 0.25, 0.5, 0.75 and 0.9 of
   phase 8a's requests/s (200 requests each), ``bench_cv`` (1, 8, 16 pairs
   bf16; 4 pairs f32, the train step's volume) and ``bench_normals`` (max
   abs 0 against the plain versions), ``check_gt_normal`` on 4 synthetic
   samples, ``visualize`` from phase 11's ``.npz`` import, ``train_synth``
   for 4 steps and ``two_stage_recipe`` with 3 steps a stage (its three
   checks). Both launch counters must move in every tool that runs the
   model.

13. runs the scale-out surface (``scale_phase``): ``entry()``'s flagship
   forward (f32, 64 planes, 192x256) against the same model on the plain
   versions; under PyTorch's defaults ``dryrun_multichip(1)`` (one full
   train step on NCCL at world size 1; two ranks refused on one card),
   ``scaling_sweep`` over 1x1, 2x1, 1x2 (one measured row, two skips),
   ``probe_multichip_hlo 1 1`` (the collective census of one step),
   ``bwd_probe`` at batch 8 over six variants (GFLOP and chain-slope
   ms/step), ``verify_step_time 2`` (train-mode forward+loss, then hard-
   synced steps and their losses), and ``model.k_size=19`` through the
   k-generic depth->normal in a train step and an eval flush. Both launch
   counters must move in every model tool (a tool's ranks report their
   own), and the upsampling kernel's must not (train steps run NCHW).

After phase 7, ``wide_flush_phase`` runs the eval forward on a 7-view
flush of 19 frames at 480x640 (114 pairs: two cost-volume launches) and
holds its metrics against frame batch 1.

Prints the build seconds, the kernel table as one JSON line (with each
kernel's launches in phases 3, 6, 7, 8, 9, 10, 11, 12 and 13, their total, the
tiled shards' times and the times at the train shape; the upsampling
kernel's in phase 3 and, 0, in phases 6 and 7), the card's
name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failed check raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

H, W, P, K = 192, 256, 64, 9


def synthetic_batch(n, height, width, views, seed):
    from cnmnet_tpu_torch.data.pipeline import collate
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes

    ds = SyntheticScenes(num_samples=n, height=height, width=width, view_num=views, seed=seed)
    return collate([ds[i] for i in range(n)])


# -- phase 2: kernels against their plain versions ---------------------------


def cv_inputs(torch, B, h, w, seed, batch=None):
    """Folded (ref, src) pairs and cameras on the card: from a synthetic
    3-view batch when given, else white noise under random cameras."""
    from cnmnet_tpu_torch.data.pipeline import normalize_images
    from cnmnet_tpu_torch.geometry.camera import camera_from_array

    if batch is not None:
        images = normalize_images(batch["images"])
        cams = batch["cams"].astype(np.float32)
        S = images.shape[1] - 1
        ref = np.repeat(images[:, 0], S, 0)
        src = images[:, 1:].reshape((-1,) + images.shape[2:])
        rc = np.repeat(cams[:, 0], S, 0)
        sc = cams[:, 1:].reshape(-1, 2, 4, 4)
    else:
        rng = np.random.default_rng(seed)
        ref = rng.standard_normal((B, h, w, 3)).astype(np.float32)
        src = rng.standard_normal((B, h, w, 3)).astype(np.float32)
        rc, sc = noise_cameras(rng, B, h, w)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()  # noqa: E731
    return dev(ref), dev(src), camera_from_array(dev(rc)), camera_from_array(dev(sc))


def noise_cameras(rng, B, h, w):
    """``B`` (reference, source) camera arrays ``[B, 2, 4, 4]``: the
    reference at the origin, each source turned and moved a little."""
    rc = np.zeros((B, 2, 4, 4), np.float32)
    rc[:, 0] = np.eye(4)
    rc[:, 1, :3, :3] = [[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]]
    sc = rc.copy()
    for b in range(B):
        a = 0.03 * rng.standard_normal()
        sc[b, 0, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        sc[b, 0, :3, 3] = 0.08 * rng.standard_normal(3)
    return rc, sc


def check_cost_volume(torch, h, w, planes, B, seed, batch=None):
    """Kernel vs plain on the card, f32 and bf16; returns the max f32 error
    and the max bf16 error against the plain version rounded to bf16 (the
    serving path's volume)."""
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.ops import cost_volume as pcv

    ref, src, rc, sc = cv_inputs(torch, B, h, w, seed, batch)
    plain = pcv.cost_volume_from_cameras(ref, src, rc, sc, 3.0, planes)
    f32 = kcv.cost_volume(ref, src, rc, sc, 3.0, planes, torch.float32)
    bf16 = kcv.cost_volume(ref, src, rc, sc, 3.0, planes, torch.bfloat16)
    torch.cuda.synchronize()
    assert f32.shape == plain.shape == (B, h, w, planes), (f32.shape, plain.shape)
    return volume_errors(torch, f32, bf16, plain, f"B={B} {h}x{w}x{planes}")


def volume_errors(torch, f32, bf16, plain, what):
    """Max |kernel - plain| in f32 and max |kernel - bf16(plain)| in bf16;
    both must be 0 (the kernel rounds where the plain version rounds)."""
    err = (f32 - plain).abs().max().item()
    err_bf = (bf16.float() - plain.to(torch.bfloat16).float()).abs().max().item()
    print(f"check cost_volume {what}: max|kernel-plain| f32 {err:.3e}, "
          f"max|kernel-bf16(plain)| bf16 {err_bf:.3e} (both must be 0)")
    assert err == 0 and err_bf == 0, (err, err_bf)
    return err, err_bf


def check_cost_volume_edges(torch, seed):
    """Kernel vs plain under coefficients whose samples cover the source's
    edges and beyond: pair 0 maps the reference onto x in about [-3, W + 9]
    and y in [-3, H + 6] as the planes sweep, so x0 takes -3, -2, -1, W - 1,
    W and beyond; pair 1's Z crosses 0 inside the image, so coordinates
    reach the +-100 max(H, W) clip and the z-guard region."""
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.ops import cost_volume as pcv

    rng = np.random.default_rng(seed)
    ref = torch.from_numpy(rng.standard_normal((2, H, W, 3)).astype(np.float32)).cuda()
    src = torch.from_numpy(rng.standard_normal((2, H, W, 3)).astype(np.float32)).cuda()
    coefs = torch.tensor([
        [1.05, 0.02, -3.3, 0.01, 1.04, -2.7, 0.0, 0.0, 1.0, 3.0, 2.0, 0.0],
        [1.0, 0.05, 0.5, -0.03, 1.0, 0.25, 1e-4, 2e-5, -0.0125, 0.5, 0.5, 0.004],
    ], dtype=torch.float32).cuda()
    idepths = pcv.idepth_hypotheses(3.0, P, ref.device)
    k = coefs[:, :9].reshape(2, 3, 3, 1)
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=ref.device),
                          torch.arange(W, dtype=torch.float32, device=ref.device), indexing="ij")
    u, v = u.reshape(-1), v.reshape(-1)
    terms = k[:, :, 0] * u + k[:, :, 1] * v + k[:, :, 2]  # plane_sweep_terms' rounding
    KT = coefs[:, 9:, None]
    plain = pcv.plane_sweep_cost_volume(ref, src, terms, KT, idepths)
    f32 = kcv.cost_volume_kernel(ref, src, coefs, idepths)
    bf16 = kcv.cost_volume_kernel(ref, src, coefs, idepths, torch.bfloat16)
    x, y = pcv._sweep_coords(terms, KT, idepths, H, W)
    x0, y0 = torch.floor(x), torch.floor(y)
    torch.cuda.synchronize()
    for edge in (-3, -2, -1, W - 1, W, W + 1):
        assert bool((x0[0] == edge).any()), f"no tap at x0 = {edge}"
    for edge in (-3, -2, -1, H - 1, H, H + 1):
        assert bool((y0[0] == edge).any()), f"no tap at y0 = {edge}"
    assert bool((x[1].abs() == 100.0 * max(H, W)).any()), "the clip was not reached"
    return volume_errors(torch, f32, bf16, plain, f"edge coefficients B=2 {H}x{W}x{P}")


def oracle_f64(torch, depth, kinv, k):
    """The plain version in f64 on the card: (unit normals, determinants)."""
    from cnmnet_tpu_torch.geometry.warp import pixel2cam
    from cnmnet_tpu_torch.ops import normals as pn

    d, ki = depth.double(), kinv.double()
    p = pixel2cam(d, ki) * ((d > 0) & (d < 10)).double()[..., None]
    x, y, z = p.unbind(-1)
    mom = pn.box_filter(torch.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z], -1), k)
    a, b, c, dd, e, f = mom[..., :6].unbind(-1)
    det = a * (dd * f - e * e) - b * (b * f - c * e) + c * (b * e - c * dd)
    n, _ = pn.depth_to_normal(d, ki, k)
    return n, det


def angles(torch, n, truth, det):
    """Angles (deg) to the f64 truth over well-posed pixels (truth norm >
    0.5, |det| > 1e-3: away from the singular threshold, where two f32
    implementations tie-break on rounding)."""
    n = n.double()
    keep = (truth.norm(dim=-1) > 0.5) & (det.abs() > 1e-3)
    cos = (n * truth).sum(-1) / (n.norm(dim=-1) * truth.norm(dim=-1)).clamp_min(1e-12)
    return torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))[keep], keep


def check_normals(torch, depth, kinv, k):
    """Kernel no worse than the f32 plain version against the f64 plain
    version (mean < 2x + 0.05 deg, max < max(2x, 1 deg)), and equal to the
    f32 plain version at every pixel (both round at the same steps in the
    same order); returns the max |kernel - plain f32|, which must be 0."""
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.ops import normals as pn

    got, _ = kn.depth_to_normal(depth, kinv, k)
    want, _ = pn.depth_to_normal(depth, kinv, k)
    truth, det = oracle_f64(torch, depth, kinv, k)
    torch.cuda.synchronize()
    a, keep = angles(torch, got, truth, det)
    r, _ = angles(torch, want, truth, det)
    diff = (got - want).abs().amax(-1)
    err = diff.max().item()
    B, h, w = depth.shape
    print(f"check depth_to_normal B={B} {h}x{w} k={k}: angle to f64 kernel mean "
          f"{a.mean().item():.4f} max {a.max().item():.4f} deg, plain f32 mean "
          f"{r.mean().item():.4f} max {r.max().item():.4f} deg over {int(keep.sum())} "
          f"well-posed pixels; max|kernel-plain| {err:.3e} (must be 0), pixels that "
          f"differ: {int((diff > 0).sum())} of {diff.numel()}")
    assert keep.sum() > 0.5 * keep.numel()
    assert a.mean() < r.mean() * 2 + 0.05 and a.max() < max(r.max().item() * 2, 1.0)
    assert err == 0, err
    return err


def normals_inputs(torch, B, h, w, seed):
    """Depth maps of synthetic rooms (some pixels invalid) and their K^-1."""
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics

    batch = synthetic_batch(B, h, w, 1, seed)
    depth = torch.from_numpy(batch["depths"][:, 0]).cuda()
    kinv = invert_intrinsics(torch.from_numpy(batch["cams"][:, 0, 1, :3, :3]).cuda())
    return depth.contiguous(), kinv.contiguous()


def check_wide_k(torch, smi, B=2, h=H, w=W, ks=(19, 31, 89, 129)):
    """depth->normal above the unrolled k (the kernel's k-generic instance)
    at B = 2, ``h`` x ``w``: each k equal to the plain version (max abs 0,
    ``check_normals``), its CUDA-event time beside the plain version's and
    its bound (``tools/roofline.kernel_cost``); the wrapper's shared-memory
    count equal to the kernel's own up to k = 1025. Returns ``{k: row}``."""
    import ctypes

    from cnmnet_tpu_torch.kernels import build
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.kernels.ablate import device_ms
    from cnmnet_tpu_torch.ops import normals as pn
    from cnmnet_tpu_torch.tools.roofline import bound, kernel_cost

    shared = build.load("depth_to_normal").cnm_depth_to_normal_shared_bytes
    shared.argtypes, shared.restype = [ctypes.c_int], ctypes.c_size_t
    for k in range(1, 1026, 2):
        assert shared(k) == kn.shared_bytes(k), (k, shared(k), kn.shared_bytes(k))
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert kn.shared_bytes(1025) <= optin, (kn.shared_bytes(1025), optin)
    depth, kinv = normals_inputs(torch, B, h, w, seed=50)
    rows = {}
    for k in ks:
        err = check_normals(torch, depth, kinv, k)
        ms = device_ms(lambda: kn.depth_to_normal_kernel(depth, kinv, k))
        plain_ms = device_ms(lambda: pn.depth_to_normal(depth, kinv, k))
        flops, nbytes = kernel_cost("depth_to_normal", (B, h, w, k))
        bound_ms, by = bound(nbytes, flops)
        rows[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": by, "shared_bytes": kn.shared_bytes(k)}
        print(f"depth_to_normal k={k} (k-generic) B={B} {h}x{w}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}), ratio "
              f"{ms / bound_ms:.2f}; {kn.shared_bytes(k)} B shared a block [{smi}]")
    print(f"depth_to_normal: the k-generic instance takes {kn.shared_bytes(kn.UNROLLED_K + 2)} B "
          f"of shared memory at every k (kernel and wrapper agree up to k = 1025; {optin} B "
          f"opt-in a block on this card)")
    return rows


def noise_pairs(torch, B, h, w, seed):
    """``B`` (ref, src) pairs of white noise made on the card under
    ``noise_cameras``, for volumes too large to make on the host."""
    from cnmnet_tpu_torch.geometry.camera import camera_from_array

    g = torch.Generator(device="cuda").manual_seed(seed)
    ref = torch.randn((B, h, w, 3), generator=g, device="cuda")
    src = torch.randn((B, h, w, 3), generator=g, device="cuda")
    rc, sc = (torch.from_numpy(c).cuda() for c in noise_cameras(np.random.default_rng(seed), B, h, w))
    return ref, src, camera_from_array(rc), camera_from_array(sc)


def check_chunked_pairs(torch, vol, ref, src, rc, sc, pairs, out_dtype, what, row_offset=0):
    """The named pairs of a chunked volume ``[B, H, W, P]`` against the
    plain version on those pairs alone (max abs 0, in ``out_dtype``)."""
    from cnmnet_tpu_torch.ops import cost_volume as pcv

    err = 0.0
    for b in pairs:
        one = lambda c: c._replace(extrinsic=c.extrinsic[b:b + 1],  # noqa: E731
                                   intrinsic=c.intrinsic[b:b + 1])
        plain = pcv.cost_volume_from_cameras(ref[b:b + 1], src[b:b + 1], one(rc), one(sc), 3.0,
                                             vol.shape[3], row_offset).to(out_dtype)
        err = max(err, (vol[b:b + 1].float() - plain.float()).abs().max().item())
    print(f"check cost_volume {what}: pairs {sorted(pairs)} against the plain version, max abs "
          f"{err:.3e} (must be 0)")
    assert err == 0, (what, err)
    return err


def check_cost_volume_chunks(torch, smi, pairs=110, h=480, w=640, planes=P):
    """The cost volume past 2^31 elements: ``pairs`` pairs at ``h`` x ``w``
    x ``planes`` in bf16 (110 x 480 x 640 x 64 = 2.16e9 costs) in at least
    two launches, the first and last pair and the pairs on each side of
    every chunk boundary equal to the plain version, with its time and
    bound; then at 192x256 with ``INDEX_LIMIT`` lowered: 6 pairs in chunks
    of 2, then each pair in chunks of its planes, and a row shard against
    the whole source, each whole volume equal to the plain version in f32
    and bf16. Returns the 110-pair row."""
    from unittest import mock

    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.kernels.ablate import device_ms
    from cnmnet_tpu_torch.ops import cost_volume as pcv
    from cnmnet_tpu_torch.tools.roofline import bound, kernel_cost

    counter = kcv.cost_volume_kernel
    ref, src, rc, sc = noise_pairs(torch, pairs, h, w, seed=8)
    chunks = kcv.launch_chunks(pairs, h, w, planes)
    before = counter.launches
    vol = kcv.cost_volume(ref, src, rc, sc, 3.0, planes, torch.bfloat16)
    torch.cuda.synchronize()
    launches = counter.launches - before
    assert launches == len(chunks) >= 2 and tuple(vol.shape) == (pairs, h, w, planes), launches
    edges = {0, pairs - 1} | {b for b0, b1, _, _ in chunks for b in (b0, b1 - 1)}
    err = check_chunked_pairs(torch, vol, ref, src, rc, sc, edges, torch.bfloat16,
                              f"B={pairs} {h}x{w}x{planes} bf16 in {launches} launches {chunks}")
    del vol
    coefs = kcv.pack_coefs(rc, sc)
    idepths = pcv.idepth_hypotheses(3.0, planes, ref.device)
    ms = device_ms(lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths, torch.bfloat16),
                   runs=5, reps=2)
    flops, nbytes = kernel_cost("cost_volume", (pairs, h, w, planes), out_bytes=2)
    bound_ms, by = bound(nbytes, flops)
    print(f"cost_volume {pairs} pairs {h}x{w}x{planes} bf16 ({pairs * planes * h * w} costs, "
          f"{launches} launches): kernel {ms:.4f} ms, bound {bound_ms * 1e3:.2f} us ({by}), "
          f"ratio {ms / bound_ms:.2f} [{smi}]")
    del ref, src, coefs
    torch.cuda.empty_cache()

    # lowered limit at 192x256: a pair is 3,145,728 costs, its packed source
    # 203,840 floats; a shard of 48 rows 786,432 costs
    ref, src, rc, sc = cv_inputs(torch, 6, H, W, seed=9)
    shard_ref = ref[:, 48:96].contiguous()
    lowered = {}
    for limit, want in ((7_000_000, 3), (2_000_000, 12)):  # 2 pairs a launch; then 32 planes
        with mock.patch.object(kcv, "INDEX_LIMIT", limit):
            for dtype in (torch.float32, torch.bfloat16):
                before = counter.launches
                vol = kcv.cost_volume(ref, src, rc, sc, 3.0, P, dtype)
                torch.cuda.synchronize()
                assert counter.launches - before == want, (limit, counter.launches - before)
                check_chunked_pairs(torch, vol, ref, src, rc, sc, range(6), dtype,
                                    f"B=6 {H}x{W}x{P} {dtype} under a limit of {limit}: "
                                    f"{want} launches")
        # the shard of rows 48..95 against the whole source, under a quarter
        # of the limit: the same chunks, of pairs and then of planes
        with mock.patch.object(kcv, "INDEX_LIMIT", limit // 4):
            before = counter.launches
            rows = kcv.cost_volume(shard_ref, src, rc, sc, 3.0, P, torch.float32, row_offset=48)
            torch.cuda.synchronize()
            assert counter.launches - before == want, (limit // 4, counter.launches - before)
            check_chunked_pairs(torch, rows, shard_ref, src, rc, sc, range(6), torch.float32,
                                f"row shard 48..95 of B=6 {H}x{W}x{P} under a limit of "
                                f"{limit // 4}: {want} launches", row_offset=48)
        lowered[limit] = want
    return {"pairs": pairs, "shape": [h, w, planes], "out": "bf16", "launches": launches,
            "max_abs_err": err, "ms": ms, "bound_ms": bound_ms, "bound_by": by,
            "lowered_limit_launches": lowered}


def check_normals_batch_chunks(torch, B=8, limit=3, ks=(9, 19)):
    """depth->normal with the batch limit lowered to ``limit``: ``B`` maps
    in ``ceil(B / limit)`` launches, equal to the plain version (max abs
    0) at an unrolled and the k-generic instance."""
    from unittest import mock

    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.ops import normals as pn

    depth, kinv = normals_inputs(torch, B, H, W, seed=51)
    want_launches = -(-B // limit)
    for k in ks:
        with mock.patch.object(kn, "MAX_BATCH", limit):
            before = kn.depth_to_normal_kernel.launches
            got = kn.depth_to_normal_kernel(depth, kinv, k)
            torch.cuda.synchronize()
            launches = kn.depth_to_normal_kernel.launches - before
        want, _ = pn.depth_to_normal(depth, kinv, k)
        err = (got - want).abs().max().item()
        print(f"check depth_to_normal B={B} k={k} under a batch limit of {limit}: {launches} "
              f"launches, max|kernel-plain| {err:.3e} (must be 0)")
        assert launches == want_launches and err == 0, (k, launches, err)
    return want_launches


# -- phase 3: the serving slice ----------------------------------------------


def calibrate_batch_norm(torch, model, images, cams):
    """Set every BatchNorm's running statistics to those of one batch
    (a train-mode forward without gradients, cumulative average). Seeded
    He-normal weights under the fresh statistics (mean 0, var 1) leave the
    activations unnormalised, and the heads' sigmoids saturate: idepth is 0
    or 3 at most pixels. Statistics taken from frames, as a trained net has
    them, keep the outputs inside their ranges."""
    from torch import nn

    from cnmnet_tpu_torch.ops.images import prepare_images

    norms = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in norms:
        bn.reset_running_stats()
        bn.momentum = None
    model.train()
    with torch.no_grad():
        model(prepare_images(images), cams)
    model.eval()
    for bn in norms:
        bn.momentum = 0.1


def check_norms_f32(torch, model):
    """A bf16 model keeps every norm layer's parameters and running
    statistics in f32 (as the JAX package's bf16 path does) and its conv
    weights in bf16."""
    from torch import nn

    norms = [m for m in model.modules() if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm))]
    kinds = {t.dtype for m in norms for t in (*m.parameters(recurse=False),
                                              *m.buffers(recurse=False)) if t.is_floating_point()}
    convs = {m.weight.dtype for m in model.modules() if isinstance(m, nn.Conv2d)}
    print(f"bf16 session: {len(norms)} norm layers hold {sorted(map(str, kinds))}; "
          f"conv weights {sorted(map(str, convs))}")
    assert norms and kinds == {torch.float32} and convs == {torch.bfloat16}, (kinds, convs)


def serve_phase(torch, counters):
    from cnmnet_tpu_torch.config import Config
    from cnmnet_tpu_torch.data.pipeline import normalize_images, quantize_images_u8
    from cnmnet_tpu_torch.kernels import upsample as kups
    from cnmnet_tpu_torch.models.layers import Upsample2x
    from cnmnet_tpu_torch.serve import InferenceSession

    batch = synthetic_batch(8, H, W, 3, seed=11)
    u8 = quantize_images_u8(batch["images"])
    f32 = normalize_images(u8.astype(np.float32) / 255.0)
    cams = batch["cams"].astype(np.float32)
    batch7 = synthetic_batch(8, H, W, 7, seed=13)  # six sources a frame
    u8_7, cams7 = quantize_images_u8(batch7["images"]), batch7["cams"].astype(np.float32)
    cfg = Config()  # 64 planes, k = 9, 192x256

    # seeded weights, BatchNorm statistics from other frames of the same kind
    full32 = InferenceSession(cfg, seed=0, compute_dtype="float32", device="cuda")
    calib = synthetic_batch(4, H, W, 3, seed=12)
    calibrate_batch_norm(
        torch, full32.model, torch.from_numpy(quantize_images_u8(calib["images"])).cuda(),
        torch.from_numpy(calib["cams"].astype(np.float32)).cuda(),
    )
    weights = full32.model.state_dict()
    session = InferenceSession(cfg, state_dict=weights, device="cuda")
    wire16 = InferenceSession(cfg, state_dict=weights, wire_dtype="float16", device="cuda")
    assert session.compute_dtype == torch.bfloat16
    check_norms_f32(torch, session.model)
    session.predict(u8[:1], cams[:1])  # loads the kernels before the counted run

    for c in (*counters.values(), kups.upsample2x_bilinear_kernel):
        c.launches = 0
    session.upsample_replayed = 0
    captured = session.graph_captures
    outs = {
        "b1_u8": session.predict(u8[:1], cams[:1]),
        "b3_f32": session.predict(f32[:3], cams[:3]),
        "b8_u8": session.predict(u8, cams),
        "b1_f16": wire16.predict(u8[:1], cams[:1]),
    }
    seven = {f"b{B}_u8_7v": (u8_7[:B], cams7[:B]) for B in (1, 3, 8)}
    outs.update({key: session.predict(*req) for key, req in seven.items()})
    launches = {name: c.launches for name, c in counters.items()}
    print(f"launches during predict ({len(outs)} requests): {launches}")
    for name, n in launches.items():
        assert n == len(outs), f"kernel {name}: {n} launches for {len(outs)} dispatches"
    # the upsampling kernel runs inside the nets' graphs: 11 launches a
    # capture's eager pass and 11 in the capture itself (its counter), and 11
    # a replay (every one at three or more views), counted by the sessions
    captures = session.graph_captures - captured + wire16.graph_captures
    replays = len(outs)
    replayed = session.upsample_replayed + wire16.upsample_replayed
    up_launches = {"capture": kups.upsample2x_bilinear_kernel.launches, "replayed": replayed}
    print(f"upsample launches during predict: {up_launches} ({captures} captures, {replays} "
          f"replays; engaged share {replayed / (11 * replays):.2%} of 11 a replay)")
    assert up_launches == {"capture": 22 * captures, "replayed": 11 * replays}, up_launches

    # the nets replay as CUDA graphs, one a bucket and signature (three views:
    # bucket 1 and 8 uint8, bucket 4 float32, the first predict capturing
    # bucket 1; seven views: buckets 1, 4 and 8 uint8), one replay a dispatch;
    # the same session with its graphs off agrees bit for bit
    graphs = (session.graph_captures, session.graph_replays)
    assert graphs == (6, 7), graphs
    assert session.one_card  # so every replay ran channels-last
    eager = InferenceSession(cfg, state_dict=weights, device="cuda")
    eager._graphs = None  # the nets eagerly, as the CPU and a mesh run them
    # the maps the served nets upsample (phase 4 times the kernel on them)
    served, seen = {}, []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
             for m in eager.model.modules() if isinstance(m, Upsample2x)]
    before = kups.upsample2x_bilinear_kernel.launches
    for key, (imgs, cm) in {"b1_u8": (u8[:1], cams[:1]), "b3_f32": (f32[:3], cams[:3]),
                            "b8_u8": (u8, cams), **seven}.items():
        seen.clear()
        want = eager.predict(imgs, cm)
        if key in ("b1_u8", "b8_u8", "b1_u8_7v", "b8_u8_7v"):
            served[(7 if key.endswith("7v") else 3, int(key[1]))] = list(seen)
        differ = [k for k in want if not np.array_equal(outs[key][k], want[k])]
        assert not differ, f"{key}: the replayed nets differ from the eager ones in {differ}"
    for h in hooks:
        h.remove()
    eager_up = kups.upsample2x_bilinear_kernel.launches - before
    assert eager_up == 11 * 6, eager_up  # the eager nets launch the kernel too
    print(f"CUDA graphs: {graphs[0]} captures, {graphs[1]} replays; the replays equal the "
          f"eager nets bit for bit at buckets 1, 4 and 8, at three and at seven views; the "
          f"eager nets launched the upsampling kernel {eager_up} times")
    del eager

    for key, out in outs.items():
        B = int(key[1])
        assert set(out) == {"idepth", "depth", "prob", "normal"}, (key, set(out))
        assert out["idepth"].shape == out["depth"].shape == out["prob"].shape == (B, H, W)
        assert out["normal"].shape == (B, H, W, 3)
        for name, a in out.items():
            assert np.isfinite(a).all(), (key, name)
        assert 0.0 <= out["prob"].min() and out["prob"].max() <= 1.0, key
        # idepth = 3 sigmoid(x) lies in (0, 3], but f32's sigmoid gives 0 for
        # x < -88, which random heads can reach
        assert 0.0 <= out["idepth"].min() and out["idepth"].max() <= 3.0, key
        valid = (out["depth"] > 0) & (out["depth"] < 10)
        norm = np.linalg.norm(out["normal"], axis=-1)[valid]
        assert valid.any() and np.abs(norm - 1.0).max() < 1e-3, (key, np.abs(norm - 1).max())
    a, b = outs["b1_f16"], outs["b1_u8"]
    for name in ("idepth", "prob", "normal"):
        assert (np.abs(a[name] - b[name]) <= 2.0**-10 * np.abs(b[name]) + 1e-6).all(), name
    assert np.allclose(a["depth"], np.minimum(b["depth"], 65504.0), rtol=2.0**-10)

    # bf16 against f32 (TF32 off), and the f32 kernels against the f32 plain versions
    cfg_plain = Config()
    cfg_plain.model.cv_backend = "torch"
    plain32 = InferenceSession(cfg_plain, state_dict=weights, compute_dtype="float32",
                               device="cuda")
    o32 = full32.predict(u8, cams)
    before = kups.upsample2x_bilinear_kernel.launches
    op = plain32.predict(u8, cams)
    # the plain session upsamples through F.interpolate (cv_backend "torch")
    assert kups.upsample2x_bilinear_kernel.launches == before
    o16 = outs["b8_u8"]
    kernel_vs_plain = {k: np.abs(o32[k] - op[k]).max() for k in ("idepth", "prob", "normal")}
    kvp_rel_l2 = np.linalg.norm(o32["idepth"] - op["idepth"]) / np.linalg.norm(op["idepth"])
    rel_l2 = np.linalg.norm(o16["idepth"] - o32["idepth"]) / np.linalg.norm(o32["idepth"])
    mean_abs = np.abs(o16["idepth"] - o32["idepth"]).mean()
    prob_mean_abs = np.abs(o16["prob"] - o32["prob"]).mean()
    print(f"f32 session, batch 8, kernels vs plain versions: max|d| "
          f"{ {k: float(f'{v:.3e}') for k, v in kernel_vs_plain.items()} } (idepth tol 1e-2), "
          f"idepth relative L2 {kvp_rel_l2:.3e} (tol 1e-4)")
    print(f"bf16 vs f32 session, batch 8: idepth relative L2 {rel_l2:.4e} (tol 0.25), "
          f"mean|d| {mean_abs:.4e} (tol 0.25); prob mean|d| {prob_mean_abs:.4e}; "
          f"f32 idepth range [{o32['idepth'].min():.3e}, {o32['idepth'].max():.3e}]")
    # The kernels agree with the plain versions to an ulp or exactly. Random
    # weights amplify an ulp of the volume through the conv stack, at the most
    # sensitive pixels to some 1e-3 (one earlier run: 2.3e-3), far less on the
    # whole map.
    assert kernel_vs_plain["idepth"] <= 1e-2 and kvp_rel_l2 <= 1e-4
    # bf16 rounds every activation to 8 significant bits; random weights
    # amplify that through ~30 layers into the heads' pre-sigmoids (std ~6),
    # so the maps differ by some percent of their range (0.14 in both
    # measures on the CPU at 64x96): tolerance 0.25, a twelfth of the range.
    assert rel_l2 <= 0.25 and mean_abs <= 0.25
    del full32, plain32
    return session, weights, u8, cams, launches, up_launches, served


def upsample_cost(maps):
    """``(flops, bytes)`` of one x2 bilinear upsampling of each map: each
    output element ``h0 (w0 a + w1 b) + h1 (w0 c + w1 d)`` (9 operations in
    f32), the input read once and the output (four times it) written once."""
    elems = sum(x.numel() for x in maps)
    return 9 * 4 * elems, 5 * elems * maps[0].element_size()


def check_upsample(torch, smi, served):
    """The upsampling kernel against ``F.interpolate`` (its plain version,
    PyTorch's own NHWC kernel) on the maps the served nets upsample at
    buckets 1 and 8, three and seven views (``serve_phase``), bit for bit
    (max abs error 0), and the time of a batch's 11 launches beside its
    bound and ``F.interpolate``'s (CUDA events, ``device_ms``). Returns
    ``{"{views}v_b{bucket}": row}``."""
    import torch.nn.functional as F

    from cnmnet_tpu_torch.kernels import upsample as kups
    from cnmnet_tpu_torch.kernels.ablate import device_ms
    from cnmnet_tpu_torch.tools.roofline import bound

    kernel = kups.upsample2x_bilinear_kernel
    plain = lambda x: F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)  # noqa: E731
    rows = {}
    with torch.inference_mode():
        for (views, bucket), maps in sorted(served.items()):
            assert len(maps) == 11 and all(x.dtype == torch.bfloat16 for x in maps), (views, bucket)
            err = max((kernel(x).float() - plain(x).float()).abs().max().item() for x in maps)
            exact = all(torch.equal(kernel(x).view(torch.int16), plain(x).view(torch.int16))
                        for x in maps)
            ms = device_ms(lambda: [kernel(x) for x in maps])
            library_ms = device_ms(lambda: [plain(x) for x in maps])
            flops, nbytes = upsample_cost(maps)
            bound_ms, by = bound(nbytes, flops)
            rows[f"{views}v_b{bucket}"] = {
                "max_abs_err": err, "bit_equal": exact, "launches": len(maps), "ms": ms,
                "plain_ms": library_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": by, "shapes": [tuple(x.shape) for x in maps]}
            print(f"upsample2x_bilinear {views} views bucket {bucket} (11 maps, bf16): "
                  f"max|kernel-F.interpolate| {err:.3e}, bit-equal {exact} (must be 0, True); "
                  f"kernel {ms:.4f} ms, F.interpolate {library_ms:.4f} ms, bound "
                  f"{bound_ms * 1e3:.2f} us ({by}), ratio {ms / bound_ms:.2f} [{smi}]")
            assert err == 0 and exact, (views, bucket, err)
    return rows


def check_batch_norm_kernels(prof_rows):
    """Every traced batch norm kernel normalised with f32 statistics: the
    native kernel's second template argument is the statistics' type."""
    norms = [key for key, _, _ in prof_rows if "batch_norm" in key or "bn_fw" in key]
    for key in norms:
        print(f"  batch norm kernel: {key[:120]}")
    assert norms, "no batch norm kernel in the trace"
    bf16_stats = [k for k in norms if "<c10::BFloat16, c10::BFloat16" in k]
    assert not bf16_stats, f"batch norm ran with bf16 statistics: {bf16_stats}"


# -- phase 6: the training slice -----------------------------------------------

def train_config(h=H, w=W, planes=P, k=K, steps=12):
    """The README's quick-start training at full width: 3 views, batch 2,
    f32, the full CNM recipe with the refiner, Adam lr 1e-4, wd 1e-5, on
    ``2 * steps`` synthetic scenes (one epoch of ``steps`` batches)."""
    from cnmnet_tpu_torch.config import Config

    cfg = Config()
    cfg.dataset.image_height, cfg.dataset.image_width = h, w
    cfg.dataset.batch_size = 2
    cfg.dataset.synthetic_size = 2 * steps
    cfg.model.num_planes, cfg.model.k_size = planes, k
    cfg.train.num_epochs = 1
    cfg.train.print_interval = 1
    return cfg


def check_normals_gradient(torch, depth, kinv, k):
    """The kernel's autograd Function against plain autograd on the same
    depth and cotangent: forward and depth gradient, max abs 0 both."""
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.ops import normals as pn

    cot = torch.randn(depth.shape + (3,), generator=torch.Generator().manual_seed(0)).to(depth.device)
    d1, d2 = depth.clone().requires_grad_(), depth.clone().requires_grad_()
    n1, _ = kn.depth_to_normal(d1, kinv, k)  # the wrapper takes the Function here
    n2, _ = pn.depth_to_normal(d2, kinv, k)
    (g1,) = torch.autograd.grad(n1, d1, cot)
    (g2,) = torch.autograd.grad(n2, d2, cot)
    fwd = (n1 - n2).abs().max().item()
    bwd = (g1 - g2).abs().max().item()
    print(f"check depth_to_normal gradient B={depth.shape[0]} {depth.shape[1]}x{depth.shape[2]} "
          f"k={k}: max|Function-plain| forward {fwd:.3e}, depth gradient {bwd:.3e} "
          f"(both must be 0); gradient max |g| {g2.abs().max().item():.3e}")
    assert fwd == 0 and bwd == 0, (fwd, bwd)
    return fwd, bwd


def train_phase(torch, counters, smi, device="cuda", h=H, w=W, planes=P, k=K, steps=12):
    """Phase 6: ``train_loop`` at full width with both launch counters, the
    loss falling on a fixed batch, the kernel's gradient, a whole step with
    kernels against one with plain versions, the checkpoint round trip, and
    the times. Returns the launches per train step and the normals timings."""
    import copy
    import tempfile

    from cnmnet_tpu_torch.data.synthetic import train_data_fn
    from cnmnet_tpu_torch.kernels.ablate import device_ms
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.ops import normals as pn
    from cnmnet_tpu_torch.train import CheckpointManager, create_train_state, make_train_step
    from cnmnet_tpu_torch.train import train_loop
    from cnmnet_tpu_torch.tools.profile_train import profile_step
    from cnmnet_tpu_torch.tools.roofline import bound, kernel_cost
    from cnmnet_tpu_torch.train.loop import batch_to_device, loss_and_grads, loss_weights_from_config

    cfg = train_config(h, w, planes, k, steps)
    data_fn = train_data_fn(cfg)
    logged = []

    class Logger:
        def log_scalars(self, step, scalars, prefix=""):
            logged.append((step, scalars))

    # 1. launches over `steps` steps of train_loop, and finite losses
    with tempfile.TemporaryDirectory(prefix="cnm_ckpt_") as ckdir:
        mgr = CheckpointManager(ckdir, max_to_keep=2, device=device)
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        state = train_loop(cfg, data_fn, logger=Logger(), checkpointer=mgr, max_steps=steps,
                           device=device)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
        launches = {name: c.launches for name, c in counters.items()}
        print(f"train_loop: {steps} steps in {loop_s:.2f} s (data made on the host inside the "
              f"loop); launches {launches}")
        assert launches == {"cost_volume": steps, "depth_to_normal": 3 * steps}, launches
        assert state.step == steps and len(logged) == steps - 1  # step `steps` returns first
        for step, scalars in logged:
            bad = {k_: v for k_, v in scalars.items() if not np.isfinite(v)}
            assert not bad, (step, bad)
        assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
        print(f"train_loop losses by step: {[round(s['loss'], 3) for _, s in logged]}; last "
              f"logged grad_norm {logged[-1][1]['grad_norm']:.4e}")

        # 5. checkpoint round trip: bit-equal into a fresh state
        assert mgr.latest_step() == steps
        restored = mgr.restore(steps, create_train_state(cfg, 99, device))
        a, b = state.model.state_dict(), restored.model.state_dict()
        same = all(torch.equal(a[n], b[n]) for n in a)
        same_m = all(torch.equal(state.opt_state[m][n], restored.opt_state[m][n])
                     for m in ("mu", "nu") for n in state.opt_state[m])
        print(f"checkpoint round trip at step {steps}: parameters and statistics equal {same}, "
              f"Adam moments equal {same_m}, step {restored.step}, count "
              f"{restored.opt_state['count']}")
        assert same and same_m and restored.step == steps
        assert restored.opt_state["count"] == state.opt_state["count"] == steps
        del restored

    # 2. the loss falls on one fixed batch
    batch = batch_to_device(next(iter(data_fn())), device)
    fresh = create_train_state(cfg, 1, device)
    step = make_train_step(cfg)
    losses = [float(step(fresh, batch)[1]["loss"]) for _ in range(10)]
    print(f"fixed batch, 10 steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} ({losses})")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]

    # 3. the kernel's gradient at the train shape
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics

    depth = batch["depths"][:, 0].contiguous()  # [2, H, W], invalid pixels 0
    kinv = invert_intrinsics(batch["cams"][:, 0, 1, :3, :3]).contiguous()
    nrm_fwd, nrm_bwd = check_normals_gradient(torch, depth, kinv, k)

    # 4. one whole step with the kernels against one with the plain versions
    a = create_train_state(cfg, 2, device)
    b = copy.deepcopy(a)
    cfg_plain = copy.deepcopy(cfg)
    cfg_plain.model.cv_backend = "torch"
    b.model.cv_backend = "torch"
    for c in counters.values():
        c.launches = 0
    ga, ma, _ = loss_and_grads(a.model.train(), batch, 0, loss_weights_from_config(cfg))
    assert all(c.launches > 0 for c in counters.values())
    for c in counters.values():
        c.launches = 0
    gb, mb, _ = loss_and_grads(b.model.train(), batch, 0, loss_weights_from_config(cfg_plain))
    assert all(c.launches == 0 for c in counters.values())
    term_err = {n: abs(ma[n].item() - mb[n].item()) / max(abs(mb[n].item()), 1e-30) for n in mb}
    num = sum(((x - y) ** 2).sum() for x, y in zip(ga, gb)).sqrt().item()
    den = sum((y ** 2).sum() for y in gb).sqrt().item()
    worst = max(term_err, key=term_err.get)
    print(f"whole step, kernels vs plain versions: worst loss-term relative difference "
          f"{term_err[worst]:.3e} ({worst}; tol 1e-5), gradient relative L2 {num / den:.3e} "
          f"(tol 1e-4)")
    assert all(v <= 1e-5 for v in term_err.values()) and num / den <= 1e-4
    del a, b, ga, gb

    # 6. times: the checked setting (TF32 off), PyTorch's defaults (cuDNN
    # TF32 on, matmul TF32 off), and TF32 off with cuDNN's autotuner
    def flags():
        return (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
                f"{torch.backends.cudnn.allow_tf32}, cudnn.benchmark "
                f"{torch.backends.cudnn.benchmark}")

    def time_steps(warmup=3, reps=10):
        for _ in range(warmup):
            step(fresh, batch)
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            step(fresh, batch)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        ms = statistics.median(ts) * 1e3
        print(f"train step (batch 2, 3 views, {h}x{w}, {planes} planes, k={k}, f32; "
              f"{flags()}): median {ms:.3f} ms, {2e3 / ms:.2f} samples/s, steps "
              f"{[round(x * 1e3, 3) for x in ts]} [{smi}]")
        return ms

    def trace():
        wall, busy, classes, rows, nb_ms = profile_step(step, fresh, batch)
        if busy == 0:
            print("profile train step: the profiler recorded no device time (not measured)")
            return
        shares = ", ".join(f"{c} {ms_:.4f} ms" for c, ms_ in sorted(classes.items(),
                                                                     key=lambda x: -x[1]))
        print(f"profile train step ({flags()}): wall {wall:.3f} ms under the profiler, "
              f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; by class: "
              f"{shares}; the plain depth->normal backward's range (3 calls) spans "
              f"{'not measured' if nb_ms is None else f'{nb_ms:.4f} ms'} [{smi}]")
        for key, ms_, count in rows[:10]:
            print(f"  {ms_:9.4f} ms {count:4d}x {key[:110]}")

    # with TF32 off a step takes seconds: fewer of them
    step_ms = time_steps(2, 5)
    trace()
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    default_ms = time_steps()
    trace()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    tuned_ms = time_steps(2, 5)
    torch.backends.cudnn.benchmark = False
    tf32 = flags()

    cot = torch.randn(depth.shape + (3,), device=depth.device)
    dg = depth.clone().requires_grad_()

    def plain_fwd_bwd():
        return torch.autograd.grad(pn.depth_to_normal(dg, kinv, k)[0], dg, cot)

    def function_fwd_bwd():
        return torch.autograd.grad(kn.DepthToNormal.apply(dg, kinv, k), dg, cot)

    nt = {
        "kernel": device_ms(lambda: kn.depth_to_normal_kernel(depth, kinv, k)),
        "plain": device_ms(lambda: pn.depth_to_normal(depth, kinv, k)),
        "plain_fwd_bwd": device_ms(plain_fwd_bwd),
        "function_fwd_bwd": device_ms(function_fwd_bwd),
    }
    flops, nbytes = kernel_cost("depth_to_normal", tuple(depth.shape) + (k,))
    nt["bound"], nt["by"] = bound(nbytes, flops)
    print(f"depth_to_normal B=2 k={k} ({tf32}): kernel {nt['kernel']:.4f} ms, plain "
          f"{nt['plain']:.4f} ms, bound {nt['bound'] * 1e3:.2f} us ({nt['by']}); with the "
          f"depth gradient: Function (kernel + plain backward) {nt['function_fwd_bwd']:.4f} "
          f"ms, plain {nt['plain_fwd_bwd']:.4f} ms [{smi}]")

    per_step = {n: v // steps for n, v in launches.items()}
    return per_step, nrm_bwd, nt, (step_ms, default_ms, tuned_ms)


# -- phase 7: the evaluation slice ---------------------------------------------

EVAL_SEQS = [("chess", "seq-03"), ("fire", "seq-04")]
EVAL_METRICS = ("l1", "abs_rel", "sq_rel", "rmse", "rmse_log", "scale_inv", "a1", "a2", "a3")


def frame_depth_m(i: int) -> float:
    """The mock tree's depth of frame i (constant over the frame), metres."""
    return 2.0 + 0.025 * i


def write_seven_scenes(root, frames, seed):
    """A 7-Scenes tree of ``EVAL_SEQS`` with the port's ``write_png``:
    ``frames`` frames each at 480x640, a colour texture that slides two
    pixels a frame, 16-bit depth in mm (``frame_depth_m``) with a 65535
    patch, and a camera translating 1 cm a frame along x."""
    import os

    from cnmnet_tpu_torch.data.imageio import write_png

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:480, :640 + 2 * frames]
    tex = np.stack([128 + 90 * np.sin(x / 13.0 + y / 29.0), 128 + 90 * np.cos(x / 23.0 - y / 17.0),
                    128 + 80 * np.sin((x + y) / 11.0)], -1)
    tex = np.clip(tex + rng.normal(0, 12, tex.shape), 0, 255).astype(np.uint8)
    for s, (scene, seq) in enumerate(EVAL_SEQS):
        seq_dir = os.path.join(root, scene, seq)
        os.makedirs(seq_dir)
        for i in range(frames):
            name = os.path.join(seq_dir, f"frame-{i:06d}")
            write_png(f"{name}.color.png", np.ascontiguousarray(tex[:, 2 * i + s:2 * i + s + 640]))
            depth = np.full((480, 640), int(round(frame_depth_m(i) * 1000)), np.uint16)
            depth[:10, :10] = 65535  # the invalid marker
            write_png(f"{name}.depth.png", depth)
            pose = np.eye(4)
            pose[0, 3] = 0.01 * i
            np.savetxt(f"{name}.pose.txt", pose, delimiter="\t ")


def eval_model(torch, device, root, h, w, planes):
    """The full-width CNMModel (``Config()`` with ``planes`` planes), seeded
    He-normal weights, BatchNorm statistics taken from four 3-view frames
    of the mock tree (frames 12, 15, 18 and 21 of its first sequence,
    uint8 wire)."""
    from cnmnet_tpu_torch.config import Config
    from cnmnet_tpu_torch.data.seven_scenes import SevenScenes
    from cnmnet_tpu_torch.models.layers import init_weights
    from cnmnet_tpu_torch.train.state import build_model

    cfg = Config()
    cfg.model.num_planes = planes
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(device)
    ds = SevenScenes(root, h, w, wire_dtype="uint8")
    paths = ds.frame_paths(*EVAL_SEQS[0])
    views = [[ds.load_frame(paths[i + o], with_depth=False) for o in (0, 10, -10)]
             for i in (12, 15, 18, 21)]
    images = torch.from_numpy(np.stack([[v[0] for v in f] for f in views])).to(device)
    cams = torch.from_numpy(np.stack([[v[2] for v in f] for f in views])).to(device)
    calibrate_batch_norm(torch, model, images, cams)
    return model


RATIO_METRICS = ("a1", "a2", "a3")


def metrics_close(a, b, rel, abs_=0.0, ratio_abs=None):
    """Whether every metric of ``a`` is within max(rel |b|, abs_) of ``b``'s
    (a1-a3 within ``ratio_abs`` when given: they are pixel fractions), and
    the largest relative difference with its metric."""
    def tol(m):
        return ratio_abs if ratio_abs is not None and m in RATIO_METRICS else max(rel * abs(b[m]), abs_)

    ok = all(abs(a[m] - b[m]) <= tol(m) for m in EVAL_METRICS)
    worst = max(EVAL_METRICS, key=lambda m: abs(a[m] - b[m]) / max(abs(b[m]), 1e-30))
    return ok, abs(a[worst] - b[worst]) / max(abs(b[worst]), 1e-30), worst


class Recorded:
    """An eval forward that keeps each call's inputs, outputs and host
    seconds (up to a device synchronise) for the checks after a run."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls = torch, fn, []

    def __call__(self, images, cams):
        t = time.perf_counter()
        out = self.fn(images, cams)
        if out[0].is_cuda:
            self.torch.cuda.synchronize()
        self.calls.append((images, cams, out, time.perf_counter() - t))
        return out


def check_eval_vs_plain(counters, name, calls, plain_fwd):
    """Every flush of a kernel run against the plain versions on the same
    inputs: idepth, prob and normal equal (max abs error 0, as both kernels
    round where their plain versions do), and no launch by the plain
    forward."""
    before = {n: c.launches for n, c in counters.items()}
    err = dict.fromkeys(("idepth", "prob", "normal"), 0.0)
    for images, cams, out, _ in calls:
        for key, a, b in zip(err, out, plain_fwd(images, cams)):
            assert (a is None) == (b is None), (name, key)
            if a is not None:
                err[key] = max(err[key], (a - b).abs().max().item())
    assert {n: c.launches for n, c in counters.items()} == before, name
    B, V = calls[0][0].shape[:2]
    print(f"check eval {name}, kernels vs plain versions: {len(calls)} flushes of "
          f"{B * (V - 1)} cost-volume pairs (f32) and {B} depth maps; max abs error "
          f"{ {k: float(f'{v:.3e}') for k, v in err.items()} } (each must be 0)")
    assert all(v == 0 for v in err.values()), (name, err)


def steady_ms(sync, call, reps=30):
    """Median host ms of ``call()`` up to a device synchronise, over
    ``reps`` calls after three warm-up calls."""
    for _ in range(3):
        call()
    sync()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        call()
        sync()
        ts.append(time.perf_counter() - t)
    return statistics.median(ts) * 1e3


def eval_phase(torch, counters, smi, device="cuda", h=H, w=W, planes=P, k=K, frames=40):
    """Phase 7: the four 7-Scenes protocols through ``evaluate_seven_scenes``
    and ``make_eval_forward`` at full width on a mock tree, with both launch
    counters read around each run and every flush held against the plain
    versions; the loader oracle and re-scoring of its artifacts; frame
    batch 4 against 1 under cuDNN TF32 on and off; the ScanNet evals on
    synthetic scenes; steady seconds per frame and one traced flush.
    Returns the eval launches per kernel and the times."""
    import copy
    import math
    import tempfile

    from cnmnet_tpu_torch.data.pipeline import normalize_images
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
    from cnmnet_tpu_torch.evals.cal_metrics import cal_metrics
    from cnmnet_tpu_torch.evals.scannet_eval import evaluate_scannet, evaluate_scannet_planes
    from cnmnet_tpu_torch.tools.profile_forward import profile_call
    from cnmnet_tpu_torch.evals.seven_scenes_eval import (
        evaluate_seven_scenes,
        make_eval_forward,
        protocol_frame_indices,
    )

    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cudnn.benchmark": torch.backends.cudnn.benchmark}
    # PyTorch's defaults: what a user's call to the eval gets
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)

    def flag_text():
        return (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
                f"{torch.backends.cudnn.allow_tf32}, cudnn.benchmark "
                f"{torch.backends.cudnn.benchmark}")

    t_phase = time.perf_counter()
    launches_eval = {name: 0 for name in counters}
    results, recs, steady = {}, {}, {}

    def run(name, forward, num_sources, frame_batch=1, seqs=EVAL_SEQS, max_frames=None, **kw):
        """One counted ``evaluate_seven_scenes`` run. The kernel forward
        launches each kernel once a flush, and each flush is then held
        against the plain versions; an oracle launches nothing."""
        kernels = forward is fwd
        n = len(protocol_frame_indices(num_sources, frames))
        census = [min(n, max_frames or n)] * len(seqs)
        flushes = sum(math.ceil(c / frame_batch) for c in census)
        rec = Recorded(torch, forward)
        t0 = time.perf_counter()
        for c in counters.values():
            c.launches = 0
        res = evaluate_seven_scenes(rec, root, num_sources=num_sources, image_height=h,
                                    image_width=w, seqs=seqs, frame_batch=frame_batch,
                                    max_frames_per_seq=max_frames, **kw)
        launches = {n: c.launches for n, c in counters.items()}
        want = {n: flushes if kernels else 0 for n in counters}
        print(f"eval {name}: {int(res['frames'])} frames in {flushes} flushes, launches "
              f"{launches}; abs_rel {res['abs_rel']:.6f} a1 {res['a1']:.6f} rmse "
              f"{res['rmse']:.6f}; forward {res['seconds_per_frame'] * 1e3:.3f} ms/frame "
              f"(first flush at these shapes included), run {time.perf_counter() - t0:.2f} s "
              f"({flag_text()})")
        assert launches == want, (name, launches, want)
        assert res["frames"] == sum(census), (name, res["frames"], census)
        bad = {m: res[m] for m in EVAL_METRICS if not np.isfinite(res[m])}
        assert not bad, (name, bad)
        if kernels:
            for n, v in launches.items():
                launches_eval[n] += v
            check_eval_vs_plain(counters, name, rec.calls, plain_fwd)
        results[name], recs[name] = res, rec
        return res

    def batch_gap(b1, b4):
        """max |idepth| between the first four frames at frame batch 1 and
        the first flush (the same four frames) at frame batch 4."""
        one = torch.cat([c[2][0] for c in recs[b1].calls[:4]])
        return (one - recs[b4].calls[0][2][0]).abs().max().item()

    with tempfile.TemporaryDirectory(prefix="cnm_7scenes_") as tmp:
        root = f"{tmp}/7scenes"
        t = time.perf_counter()
        write_seven_scenes(root, frames, seed=21)
        print(f"mock 7-Scenes tree: {len(EVAL_SEQS)} sequences x {frames} frames at 480x640 "
              f"written in {time.perf_counter() - t:.2f} s")
        model = eval_model(torch, device, root, h, w, planes)
        fwd = make_eval_forward(model, k_size=k, device=device)
        plain_model = copy.deepcopy(model)
        plain_model.cv_backend = "torch"
        plain_fwd = make_eval_forward(plain_model, k_size=k, device=device)

        # (a) the loader: an oracle of the true inverse depth scores perfectly
        def oracle(images, cams):
            i = np.rint(-np.asarray(cams)[:, 0, 0, 0, 3] / 0.01)
            idepth = (1.0 / frame_depth_m(i)).astype(np.float32)
            t_ = torch.from_numpy(idepth).to(device)[:, None, None, None].expand(-1, h, w, 1)
            return t_, None, None

        res = run("oracle 3-view", oracle, 2, save_dir=f"{tmp}/artifacts")
        assert res["abs_rel"] < 1e-3 and res["a1"] == 1.0, res
        # (d) re-scoring the oracle's artifacts, GT from the artifacts and
        # from the tree's PNGs (read and compared at 480x640)
        for gt_root in (None, root):
            rescored = cal_metrics(f"{tmp}/artifacts", gt_root=gt_root, write_txt=False)
            ok, _, _ = metrics_close(rescored, res, 5e-3, 1e-3)
            diffs = {m: float(f"{abs(rescored[m] - res[m]):.3e}") for m in EVAL_METRICS}
            print(f"check cal_metrics re-scoring of the oracle's artifacts (GT "
                  f"{'PNG' if gt_root else 'npy'}): {int(rescored['frames'])} frames; absolute "
                  f"differences from the inline metrics {diffs} (tol rel 5e-3, abs 1e-3; the "
                  f"artifacts' depth is 1/(idepth + 1e-4))")
            assert rescored["frames"] == res["frames"] and ok, diffs

        # the four protocols at frame batch 1, the 3-view one also at 4;
        # (b) every flush of each against the plain versions (in run);
        # steady time: one flush of each, repeated
        for S, fb in ((1, 1), (2, 1), (4, 1), (6, 1), (2, 4)):
            name = f"{S + 1}-view b{fb}"
            run(name, fwd, S, frame_batch=fb)
            images, cams = recs[name].calls[-1][:2]
            steady[name] = steady_ms(sync, lambda: fwd(images, cams)) / fb

        # (c) batching: cuDNN may take another algorithm at another batch,
        # and under TF32 that moves single pixels across the 1.25^n
        # thresholds of a1-a3 (pixel fractions, held to 3e-5 absolute). The
        # same pair with cuDNN TF32 off, on four frames, shows the cause.
        torch.backends.cudnn.allow_tf32 = False
        for fb in (1, 4):
            run(f"3-view b{fb} TF32 off", fwd, 2, frame_batch=fb, seqs=EVAL_SEQS[:1],
                max_frames=4)
        torch.backends.cudnn.allow_tf32 = True
        for tf32, b1, b4 in (("on", "3-view b1", "3-view b4"),
                             ("off", "3-view b1 TF32 off", "3-view b4 TF32 off")):
            ok, worst, name = metrics_close(results[b4], results[b1], 1e-4, ratio_abs=3e-5)
            diffs = {m: float(f"{abs(results[b4][m] - results[b1][m]):.3e}") for m in EVAL_METRICS}
            print(f"check eval frame_batch 4 vs 1 (3-view, cuDNN TF32 {tf32}, "
                  f"{int(results[b1]['frames'])} frames): largest relative metric difference "
                  f"{worst:.3e} ({name}; tol 1e-4 relative, a1-a3 3e-5 absolute); absolute "
                  f"differences {diffs}; first four frames' idepth max abs difference "
                  f"{batch_gap(b1, b4):.3e}")
            assert ok, (tf32, name, worst)
        off_flush_ms = {fb: [round(c[3] * 1e3, 3) for c in recs[f"3-view b{fb} TF32 off"].calls]
                        for fb in (1, 4)}
        print(f"eval 3-view flushes under cuDNN TF32 off, host ms each (the first at each "
              f"shape chooses algorithms): frame_batch 1 {off_flush_ms[1]}, frame_batch 4 "
              f"{off_flush_ms[4]} [{smi}]")

    # ScanNet: depth and plane evals on normalised synthetic scenes whose
    # top rows have no GT depth, so that every label map holds non-planar
    # pixels (where the JAX package's plane labels and the port's agree)
    scenes = SyntheticScenes(num_samples=4, height=h, width=w, view_num=3, seed=17)

    class Scenes:
        def __len__(self):
            return len(scenes)

        def __getitem__(self, i):
            s = dict(scenes[i])
            s["images"] = normalize_images(s["images"])
            s["depths"] = s["depths"].copy()
            s["depths"][:, :6] = 0.0
            return s

    for name, evaluate in (("scannet depth", evaluate_scannet),
                           ("scannet planes", evaluate_scannet_planes)):
        rec = Recorded(torch, fwd)
        for c in counters.values():
            c.launches = 0
        res = evaluate(rec, Scenes())
        launches = {n: c.launches for n, c in counters.items()}
        print(f"eval {name}: {res}; launches {launches}")
        assert launches == {n: len(scenes) for n in counters}, launches
        assert res["frames"] == len(scenes) and all(np.isfinite(v) for v in res.values()), res
        for n, v in launches.items():
            launches_eval[n] += v
        check_eval_vs_plain(counters, name, rec.calls, plain_fwd)

    # where one 3-view flush's time goes
    traced = {}
    for fb in (1, 4) if device != "cpu" else ():
        images, cams = recs[f"3-view b{fb}"].calls[0][:2]
        wall, busy, classes, rows = profile_call(lambda: fwd(images, cams))
        if busy == 0:
            print(f"profile eval flush b{fb}: the profiler recorded no device time "
                  "(not measured)")
            continue
        traced[fb] = (wall, busy)
        shares = ", ".join(f"{c} {ms:.4f} ms" for c, ms in sorted(classes.items(),
                                                                  key=lambda x: -x[1]))
        print(f"profile eval 3-view flush, frame_batch {fb} ({flag_text()}): wall {wall:.3f} "
              f"ms under the profiler, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}; by class: {shares} [{smi}]")
        for key, ms, count in rows[:8]:
            print(f"  {ms:9.4f} ms {count:4d}x {key[:110]}")

    print(f"phase 7: {time.perf_counter() - t_phase:.2f} s")
    print(f"eval ms per frame, forward only ({flag_text()}), median of 30 repeats of one "
          f"flush: { {n: round(v, 3) for n, v in steady.items()} }; averages over each run: "
          f"{ {n: round(r['seconds_per_frame'] * 1e3, 3) for n, r in results.items()} } [{smi}]")
    torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    torch.backends.cudnn.benchmark = flags["cudnn.benchmark"]
    return launches_eval, {"steady": steady, "traced": traced}


def flush_inputs(frames, views, h, w, seed):
    """``frames`` eval frames of ``views`` views at ``h`` x ``w``: uint8
    noise texture, each frame's sources moved by ``noise_cameras``, and a
    constant GT depth a frame (``frame_depth_m``)."""
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (frames, views, h, w, 3), dtype=np.uint8)
    cams = np.empty((frames, views, 2, 4, 4), np.float32)
    for f in range(frames):
        rc, sc = noise_cameras(rng, views - 1, h, w)
        cams[f, 0], cams[f, 1:] = rc[0], sc
    gt = np.stack([np.full((h, w), frame_depth_m(f), np.float32) for f in range(frames)])
    return u8, cams, gt


def wide_flush_phase(torch, counters, smi, device="cuda", h=480, w=640, planes=P, k=K,
                     frames=19, views=7):
    """The flush the JAX package takes and the port refused before its
    cost volume launched in chunks: ``make_eval_forward`` (f32, PyTorch's
    defaults) on a 7-view flush of 19 frames at 480x640, 114 pairs of 64
    planes (2.24e9 costs): two cost-volume launches and one depth->normal,
    with the launch counters set to 0 just before and read just after;
    finite outputs, its normals equal to the plain version on its own
    depth, and its metrics against frame batch 1 (phase 7's tolerance: 1e-4
    relative, a1-a3 3e-5 absolute). Returns the flush's launches."""
    from cnmnet_tpu_torch.config import Config
    from cnmnet_tpu_torch.evals.cal_metrics import frame_metrics
    from cnmnet_tpu_torch.evals.seven_scenes_eval import aggregate_metrics, make_eval_forward
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.kernels import dispatch
    from cnmnet_tpu_torch.models.layers import init_weights
    from cnmnet_tpu_torch.train.state import build_model

    t_phase = time.perf_counter()
    cuda = device != "cpu"
    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        u8, cams, gt = flush_inputs(frames, views, h, w, seed=70)
        cfg = Config()
        cfg.model.num_planes = planes
        model = build_model(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        model.to(device)
        calibrate_batch_norm(torch, model, torch.from_numpy(u8[:2, :3]).to(device),
                             torch.from_numpy(cams[:2, :3]).to(device))
        fwd = make_eval_forward(model, k_size=k, device=device)
        pairs = frames * (views - 1)
        want = len(kcv.launch_chunks(pairs, h, w, planes))
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        t = time.perf_counter()
        idepth, prob, normal = fwd(u8, cams)
        if cuda:
            torch.cuda.synchronize()
        flush_s = time.perf_counter() - t
        launches = _launches(counters)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        assert tuple(idepth.shape) == (frames, h, w, 1) and tuple(normal.shape) == (frames, h, w, 3)
        assert all(bool(torch.isfinite(o).all()) for o in (idepth, prob, normal))
        if cuda:
            assert want >= 2 and launches == {"cost_volume": want, "depth_to_normal": 1}, launches
        depth = 1.0 / (idepth[..., 0] + 1e-8)
        kinv = invert_intrinsics(torch.from_numpy(cams[:, 0, 1, :3, :3]).to(depth.device))
        plain, _ = dispatch.depth_to_normal(depth, kinv, k, backend="torch")
        n_err = (normal - plain).abs().max().item()
        assert n_err == 0, n_err
        ones = [fwd(u8[i:i + 1], cams[i:i + 1]) for i in range(frames)]
        idepth1 = torch.cat([o[0] for o in ones])
        metrics = [aggregate_metrics([frame_metrics(1.0 / (d[i, :, :, 0] + 1e-8), gt[i])
                                      for i in range(frames)])
                   for d in (idepth.cpu().numpy(), idepth1.cpu().numpy())]
        ok, worst, name = metrics_close(metrics[0], metrics[1], 1e-4, ratio_abs=3e-5)
        diffs = {m: float(f"{abs(metrics[0][m] - metrics[1][m]):.3e}") for m in EVAL_METRICS}
        gap = (idepth - idepth1).abs().max().item()
        l2 = ((idepth - idepth1).norm() / idepth1.norm()).item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
        torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    print(f"eval flush of {frames} frames x {views} views at {h}x{w} ({pairs} pairs x {planes} "
          f"planes = {pairs * planes * h * w} costs, f32, PyTorch's defaults): launches "
          f"{launches}, {flush_s:.3f} s (first flush at this shape), peak "
          f"{peak:.3f} GiB; normals against the plain version on its depth max abs {n_err:.3e} "
          f"(must be 0); against frame batch 1: largest relative metric difference {worst:.3e} "
          f"({name}; tol 1e-4 relative, a1-a3 3e-5 absolute), absolute differences {diffs}, "
          f"idepth max abs {gap:.3e}, "
          f"relative L2 {l2:.3e}; phase {time.perf_counter() - t_phase:.2f} s [{smi}]")
    assert ok, (name, worst)
    return launches


# -- phase 8: serving under load and the command line ------------------------


def gate(session):
    """Hold ``session``'s batcher inside its next dispatch: returns
    ``(entered, release, restore)``; requests submitted between ``entered``
    and ``release`` are collected as one batch."""
    import threading

    entered, release = threading.Event(), threading.Event()
    real = session.predict_async

    def gated(images, cams):
        if not entered.is_set():
            entered.set()
            assert release.wait(120)
        return real(images, cams)

    session.predict_async = gated
    return entered, release, lambda: vars(session).pop("predict_async", None)


def gated_batch(session, first, rest, cancel=()):
    """Submit ``first`` alone, hold its dispatch, submit ``rest`` (one batch
    behind it), cancel the futures at the ``cancel`` indices of ``rest``,
    release: returns the futures of ``rest`` and the batcher's counts."""
    from cnmnet_tpu_torch.serve import MicroBatcher

    entered, release, restore = gate(session)
    mb = MicroBatcher(session, max_batch=8, max_wait_ms=5)
    try:
        head = mb.submit(*first)
        assert entered.wait(120)
        futs = [mb.submit(im, cm) for im, cm in rest]
        for i in cancel:
            assert futs[i].cancel()
        release.set()
        head.result(timeout=120)
        for i, f in enumerate(futs):
            if i not in cancel and f.exception(timeout=120) is None:
                f.result()
    finally:
        release.set()
        mb.close()
        restore()
    return futs, (mb.dispatched, mb.served)


def load_run(session, u8, cams, clients, per_client):
    """``clients`` threads in a closed loop through a ``MicroBatcher``
    (max_batch 8, max_wait 5 ms), ``per_client`` requests each (frame
    ``(client + i) % len(u8)``): wall seconds, ``(i, latency seconds)`` of
    every request (``i`` its place in its client's loop), and the batcher's
    dispatched batches and served requests."""
    import threading

    from cnmnet_tpu_torch.serve import MicroBatcher

    lat, lock, errors = [], threading.Lock(), []
    mb = MicroBatcher(session, max_batch=8, max_wait_ms=5)

    def client(c):
        try:
            for i in range(per_client):
                j = (c + i) % len(u8)
                t = time.perf_counter()
                out = mb.submit(u8[j], cams[j]).result(timeout=300)
                dt = time.perf_counter() - t
                assert out["idepth"].shape == u8.shape[2:4]
                with lock:
                    lat.append((i, dt))
        except Exception as e:  # reported below: the run fails
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        wall = time.perf_counter() - t0
        mb.close()
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert len(lat) == clients * per_client
    return wall, lat, mb.dispatched, mb.served


def batcher_phase(torch, counters, smi, session, weights, u8, cams, device="cuda", clients=16,
                  per_client=8, long_per_client=64):
    """Phase 8a: the serving session (bf16, buckets 1/4/8) under load
    through a ``MicroBatcher`` (max_batch 8, max_wait 5 ms) with the launch
    counters; one client alone against ``predict`` at bucket 1; the chain
    slope of the forward beside its CUDA-event time; the identity of every
    future (f32, TF32 off); the reference faults the port does not copy;
    ``predict_async`` with two handles in flight. Returns the load run's
    launches per kernel and its numbers."""
    from cnmnet_tpu_torch.config import Config
    from cnmnet_tpu_torch.data.pipeline import normalize_images
    from cnmnet_tpu_torch.obs.timing import forward_slope_seconds
    from cnmnet_tpu_torch.serve import InferenceSession, MicroBatcher

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    cfg = Config()
    cfg.model.num_planes = session.cfg.model.num_planes
    cfg.model.k_size = session.k_size
    for B in (1, 4, 8):  # every bucket's first call outside the counted run
        session.predict(u8[:B], cams[:B])

    def loaded(per_client):
        """A closed-loop run with the launch counters set to 0 just before
        and read just after; its numbers, and its launches per kernel. The
        tail is given over all requests and without each client's first
        (the round in which every client starts at once), with the max."""
        for c in counters.values():
            c.launches = 0
        wall, lat, batches, served = load_run(session, u8, cams, clients, per_client)
        sync()
        launches = {n: c.launches for n, c in counters.items()}
        n = clients * per_client
        every = np.array([dt for _, dt in lat]) * 1e3
        later = np.array([dt for i, dt in lat if i > 0]) * 1e3
        run = {"requests": n, "requests_per_s": n / wall, "p50_ms": float(np.percentile(every, 50)),
               "p99_ms": float(np.percentile(every, 99)), "max_ms": float(every.max()),
               "p99_after_first_ms": float(np.percentile(later, 99)),
               "max_after_first_ms": float(later.max()), "mean_batch": served / batches,
               "batches": batches}
        print(f"batcher load: {clients} clients x {per_client} requests in {wall:.3f} s: "
              f"{run['requests_per_s']:.2f} requests/s, latency p50 {run['p50_ms']:.3f} ms p99 "
              f"{run['p99_ms']:.3f} ms max {run['max_ms']:.3f} ms; without each client's first "
              f"request ({len(later)}): p99 {run['p99_after_first_ms']:.3f} ms max "
              f"{run['max_after_first_ms']:.3f} ms; {batches} batches of mean size "
              f"{run['mean_batch']:.3f}; launches {launches} [{smi}]")
        assert served == n and launches == {k: batches for k in counters}, (launches, batches)
        return run, launches

    # the load: 16 clients x 8 requests, closed loop; then 16 x 64 (1024
    # requests), so that p99 is not the slowest few requests of the first round
    load, launches = loaded(per_client)
    load["long"], _ = loaded(long_per_client)

    # one client alone: the batcher's wait is the price of coalescing
    solo = []
    mb = MicroBatcher(session, max_batch=8, max_wait_ms=5)
    try:
        for i in range(20):
            t = time.perf_counter()
            mb.submit(u8[i % len(u8)], cams[i % len(u8)]).result(timeout=120)
            solo.append(time.perf_counter() - t)
    finally:
        mb.close()
    direct = []
    for i in range(20):
        t = time.perf_counter()
        session.predict(u8[i % len(u8)][None], cams[i % len(u8)][None])
        direct.append(time.perf_counter() - t)
    load["solo_ms"] = statistics.median(solo) * 1e3
    load["predict_b1_ms"] = statistics.median(direct) * 1e3
    print(f"one client alone, 20 sequential submits: median {load['solo_ms']:.3f} ms per request "
          f"(max_wait 5 ms); predict at bucket 1: median {load['predict_b1_ms']:.3f} ms [{smi}]")

    # the chain slope of the session's forward at bucket 1 beside CUDA events
    if device != "cpu":
        from cnmnet_tpu_torch.kernels.ablate import device_ms

        layout = session._layout(3)
        img = torch.from_numpy(u8[:1]).to(device)
        cam = torch.from_numpy(cams[:1]).to(device)

        def fwd(im, cm):
            return session._forward(im, cm, layout)

        slope = forward_slope_seconds(fwd, img, cam) * 1e3
        event = device_ms(lambda: fwd(img, cam), runs=10, reps=5)
        print(f"forward at bucket 1: chain slope {slope:.3f} ms per call (obs/timing), CUDA "
              f"events {event:.3f} ms (device time behind a queued sleep) [{smi}]")
        load["slope_ms"], load["event_ms"] = slope, event

    # identity: f32, TF32 off, one bucket (every batch padded to 4, so the
    # convolutions run the same algorithms whatever the batch holds); four
    # distinct frames, each requested twice
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    f32 = InferenceSession(cfg, state_dict=weights, compute_dtype="float32", batch_buckets=(4,),
                           device=device)
    alone = [f32.predict(u8[i:i + 1], cams[i:i + 1])["idepth"][0] for i in range(4)]
    mb = MicroBatcher(f32, max_batch=4, max_wait_ms=5)
    try:
        order = [2, 0, 3, 1, 1, 3, 0, 2]
        futs = [mb.submit(u8[i], cams[i]) for i in order]
        err = max(np.abs(f.result(timeout=300)["idepth"] - alone[i]).max()
                  for i, f in zip(order, futs))
        identity_batches = mb.dispatched
    finally:
        mb.close()
    torch.backends.cudnn.allow_tf32 = tf32
    print(f"check batcher identity (f32, TF32 off, bucket 4): 8 futures over 4 distinct frames "
          f"in {identity_batches} batches, max |idepth - predict alone| {err:.3e} (tol 1e-4)")
    assert err <= 1e-4, err
    del f32

    # the reference faults, each served, on the serving session; each result
    # against predict on the chunk the batcher formed (the same bucket)
    def gap(futs, chunks):
        """max |idepth| between the futures and predict on their chunks."""
        worst = 0.0
        for idx, (images, cams_) in chunks:
            want = session.predict(np.stack(images), np.stack(cams_))["idepth"]
            worst = max(worst, max(np.abs(futs[i].result()["idepth"] - want[j]).max()
                                   for j, i in enumerate(idx)))
        return worst

    fwire = normalize_images(u8.astype(np.float32) / 255.0)
    rest = [(u8[1, :2], cams[1, :2]), (u8[2], cams[2]), (fwire[3], cams[3]),
            (u8[4, :2], cams[4, :2])]
    futs, counts = gated_batch(session, (u8[0], cams[0]), rest)
    mix = gap(futs, [((0, 3), ([u8[1, :2], u8[4, :2]], [cams[1, :2], cams[4, :2]])),
                     ((1,), ([u8[2]], [cams[2]])), ((2,), ([fwire[3]], [cams[3]]))])
    assert counts == (4, 5) and "prob" not in futs[0].result() and mix <= 1e-6, (counts, mix)
    futs, counts = gated_batch(session, (u8[0], cams[0]),
                               [(u8[i], cams[i]) for i in range(1, 4)], cancel=(1,))
    cancel = gap(futs, [((0, 2), ([u8[1], u8[3]], [cams[1], cams[3]]))])
    assert futs[1].cancelled() and counts == (2, 3) and cancel <= 1e-6, (counts, cancel)
    futs, counts = gated_batch(session, (u8[0], cams[0]),
                               [(u8[1], cams[1, :2]), (u8[2], cams[2]), (u8[3, 0], cams[3])])
    bad = [type(futs[i].exception()).__name__ for i in (0, 2)]
    malformed = gap(futs, [((1,), ([u8[2]], [cams[2]]))])
    assert bad == ["ValueError", "ValueError"] and counts == (2, 2) and malformed <= 1e-6
    small = InferenceSession(cfg, state_dict=weights, batch_buckets=(1, 4), device=device)
    futs, counts = gated_batch(small, (u8[0], cams[0]), [(u8[i], cams[i]) for i in range(8)])
    chunks = [small.predict(u8[:4], cams[:4])["idepth"], small.predict(u8[4:], cams[4:])["idepth"]]
    over = max(np.abs(f.result()["idepth"] - chunks[i // 4][i % 4]).max()
               for i, f in enumerate(futs))
    assert counts == (3, 9) and over <= 1e-6, (counts, over)
    print(f"check batcher reference faults (bf16 serving session): 2- and 3-view and a float "
          f"wire in one batch {mix:.3e}; a cancelled future beside live ones {cancel:.3e}; "
          f"malformed requests failed alone ({bad}), their neighbour {malformed:.3e}; max_batch "
          f"8 over buckets (1, 4) served as chunks of 4, {over:.3e} (max |idepth| against predict "
          f"on the same chunk, tol 1e-6)")
    del small

    # predict_async: two handles in flight, fetched against predict (same bucket, same kernels)
    h1 = session.predict_async(u8[:4], cams[:4])
    h2 = session.predict_async(u8[4:], cams[4:])
    got = [session.fetch(h2), session.fetch(h1)]
    want = [session.predict(u8[4:], cams[4:]), session.predict(u8[:4], cams[:4])]
    err = max(np.abs(g[k] - v[k]).max() for g, v in zip(got, want) for k in v)
    print(f"check predict_async: two handles of 4 frames in flight, fetch vs predict max abs "
          f"error {err:.3e} (must be 0)")
    assert err == 0, err
    print(f"phase 8a: {time.perf_counter() - t_phase:.2f} s")
    return launches, load


class Spy:
    """For the span of a ``with``: ``module.name`` records each result, and
    is called with the keywords of ``forced`` on top of the caller's."""

    def __init__(self, module, name, **forced):
        self.module, self.name, self.forced, self.results = module, name, forced, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __call__(self, *args, **kwargs):
        self.results.append(self.real(*args, **{**kwargs, **self.forced}))
        return self.results[-1]

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def run_tool(torch, counters, smi, name, main, argv, device="cuda", show=None):
    """``main(argv)`` in this process with the launch counters set to 0 just
    before and read just after; prints its rc, seconds and launches and the
    last ``show`` lines of its output (all without ``show``), and fails on
    a non-zero rc. Returns (launches, seconds, printed lines)."""
    import contextlib
    import io

    out = io.StringIO()
    for c in counters.values():
        c.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    if device != "cpu":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = {n: c.launches for n, c in counters.items()}
    lines = out.getvalue().splitlines()
    print(f"{name}: rc {rc}, {seconds:.2f} s, launches {launches} [{smi}]")
    for line in lines[-show if show else 0:]:
        print(f"  | {line[:220 if show is None else 160]}")
    assert rc == 0, (name, argv, rc)
    return launches, seconds, lines


def run_cli(torch, counters, smi, argv, device="cuda"):
    """``cnmnet_tpu_torch.cli.main(argv)`` through ``run_tool``, its last four
    lines shown."""
    from cnmnet_tpu_torch import cli

    return run_tool(torch, counters, smi, f"cli {argv[0]}", cli.main, argv, device, show=4)


def cli_phase(torch, counters, smi, device="cuda", h=H, w=W, planes=P, k=K, frames=40, steps=6):
    """Phase 8b: ``cnmnet_tpu_torch.cli.main`` at full width under PyTorch's
    defaults: train, eval, cal-metrics, eval-scannet, infer and export-tb,
    each with the launch counters around it and held to the direct calls.
    Returns the CLI's launches per kernel and each command's seconds."""
    import glob
    import json
    import os
    import tempfile

    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.data.pipeline import quantize_images_u8
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
    from cnmnet_tpu_torch.evals import scannet_eval, seven_scenes_eval
    from cnmnet_tpu_torch.models.layers import init_weights
    from cnmnet_tpu_torch.obs.tb_export import parse_proto, read_records
    from cnmnet_tpu_torch.serve import InferenceSession
    from cnmnet_tpu_torch.train.state import build_model
    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.state import TrainState

    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "cudnn.benchmark": torch.backends.cudnn.benchmark}
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = False
    print(f"phase 8b flags: TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}, cudnn.benchmark {torch.backends.cudnn.benchmark}")
    t_phase = time.perf_counter()
    size = [f"dataset.image_height={h}", f"dataset.image_width={w}",
            f"model.num_planes={planes}", f"model.k_size={k}"]
    total = {n: 0 for n in counters}
    seconds = {}

    def count(name, launches, want):
        assert launches == want, (name, launches, want)
        for n_, v in launches.items():
            total[n_] += v

    with tempfile.TemporaryDirectory(prefix="cnm_cli_") as tmp:
        run = [f"train.log_dir={tmp}/logs", f"train.checkpoint_dir={tmp}/ckpt"]
        cfg = apply_overrides(Config(), size + run)

        # 1. train: the cost volume once a step, depth->normal three times
        launches, seconds["train"], _ = run_cli(
            torch, counters, smi, ["train", "--synthetic", "--max-steps", str(steps),
                                   "--device", device, "dataset.batch_size=2",
                                   "train.print_interval=1"] + size + run, device)
        count("train", launches, {"cost_volume": steps, "depth_to_normal": 3 * steps})
        with open(f"{tmp}/logs/events.jsonl") as f:
            records = [json.loads(line) for line in f]
        scalars = [r for r in records if r["type"] == "scalars"]
        pngs = sorted(glob.glob(f"{tmp}/logs/images/*/*.png"))
        steps_saved = CheckpointManager(f"{tmp}/ckpt", device=device).all_steps()
        print(f"  train: {len(scalars)} scalar records (steps {[r['step'] for r in scalars]}; the "
              f"step that reaches --max-steps returns before its line), {len(pngs)} PNG "
              f"summaries, checkpoints {steps_saved}; losses "
              f"{[round(r['loss'], 3) for r in scalars]}")
        assert [r["step"] for r in scalars] == list(range(1, steps))
        assert all(np.isfinite(r["loss"]) for r in scalars) and len(pngs) == 6
        assert steps_saved[-1] == steps

        # 2. eval on the mock 7-Scenes tree against evaluate_seven_scenes
        root = f"{tmp}/7scenes"
        write_seven_scenes(root, frames, seed=21)
        with Spy(seven_scenes_eval, "evaluate_seven_scenes") as spy:
            launches, seconds["eval"], _ = run_cli(
                torch, counters, smi, ["eval", "--views", "3", "--checkpoint", "latest",
                                       "--max-frames-per-seq", "8", "--save-dir",
                                       f"{tmp}/artifacts", "--device", device,
                                       f"dataset.root_dir={root}"] + size + run, device)
        got = spy.results[0]
        count("eval", launches, {n_: int(got["frames"]) for n_ in counters})
        model = build_model(cfg)
        init_weights(model, torch.Generator().manual_seed(0))
        CheckpointManager(cfg.train.checkpoint_dir, device=device).restore(
            "latest", TrainState(model), with_optimizer=False)
        fwd = seven_scenes_eval.make_eval_forward(model, k_size=k, device=device)
        want = seven_scenes_eval.evaluate_seven_scenes(fwd, root, num_sources=2, image_height=h,
                                                       image_width=w, max_frames_per_seq=8)
        rel = max(abs(got[m] - want[m]) / max(abs(want[m]), 1e-30) for m in EVAL_METRICS)
        print(f"  eval: {int(got['frames'])} frames, abs_rel {got['abs_rel']:.6f}; largest "
              f"relative metric difference from evaluate_seven_scenes with the restored weights "
              f"{rel:.3e} (tol 1e-6)")
        assert got["frames"] == want["frames"] > 0 and rel <= 1e-6

        # 3. cal-metrics on the eval's artifacts
        launches, seconds["cal-metrics"], lines = run_cli(
            torch, counters, smi, ["cal-metrics", f"{tmp}/artifacts"], device)
        count("cal-metrics", launches, {n_: 0 for n_ in counters})
        assert os.path.isfile(f"{tmp}/artifacts/evaluation_errors.txt")
        assert lines[-1] == f"wrote {tmp}/artifacts/evaluation_errors.txt"

        # 4. eval-scannet on synthetic scenes, depth and planes
        with Spy(scannet_eval, "evaluate_scannet") as dspy, \
                Spy(scannet_eval, "evaluate_scannet_planes") as pspy:
            launches, seconds["eval-scannet"], _ = run_cli(
                torch, counters, smi, ["eval-scannet", "--synthetic", "--planes",
                                       "--max-samples", "4", "--checkpoint", "latest",
                                       "--device", device] + size + run, device)
        count("eval-scannet", launches, {n_: 8 for n_ in counters})
        depth, planes_ = dspy.results[0], pspy.results[0]
        print(f"  eval-scannet: abs_rel {depth['abs_rel']:.6f} over {int(depth['frames'])} "
              f"samples; plane_recall_normal_30deg {planes_['plane_recall_normal_30deg']:.6f}")
        assert depth["frames"] == planes_["frames"] == 4
        assert all(np.isfinite(v) for r in (depth, planes_) for v in r.values())

        # 5. infer over 8 .npz frames, batch 4, against InferenceSession on the same batches
        os.makedirs(f"{tmp}/frames")
        scenes = SyntheticScenes(num_samples=8, height=h, width=w, view_num=3, seed=31)
        inputs = [scenes[i] for i in range(8)]
        for i, f in enumerate(inputs):
            np.savez(f"{tmp}/frames/frame{i}.npz", images=quantize_images_u8(f["images"]),
                     cams=f["cams"].astype(np.float32))
        launches, seconds["infer"], _ = run_cli(
            torch, counters, smi, ["infer", "--inputs", f"{tmp}/frames/*.npz", "--out-dir",
                                   f"{tmp}/preds", "--batch", "4", "--checkpoint", "latest",
                                   "--device", device] + size + run, device)
        count("infer", launches, {n_: 2 for n_ in counters})
        session = InferenceSession(cfg, checkpoint="latest", batch_buckets=(1, 4), device=device)
        err = 0.0
        for lo in (0, 4):
            images, cams_ = [], []
            for i in range(lo, lo + 4):
                with np.load(f"{tmp}/frames/frame{i}.npz") as z:
                    images.append(z["images"])
                    cams_.append(z["cams"])
            out = session.predict(np.stack(images), np.stack(cams_))
            for i in range(lo, lo + 4):
                with np.load(f"{tmp}/preds/frame{i}.pred.npz") as z:
                    assert set(z.files) == set(out)
                    err = max(err, max(np.abs(z[k_] - out[k_][i - lo]).max() for k_ in out))
        print(f"  infer: 8 .pred.npz against InferenceSession(checkpoint='latest').predict on the "
              f"same batches of 4: max abs error {err:.3e} (must be 0)")
        assert err == 0, err
        del session, model

        # 6. export-tb: the exported scalars are events.jsonl's
        launches, seconds["export-tb"], _ = run_cli(
            torch, counters, smi, ["export-tb", f"{tmp}/logs", "--out", f"{tmp}/tb"],
            device)
        count("export-tb", launches, {n_: 0 for n_ in counters})
        (path,) = glob.glob(f"{tmp}/tb/events.out.tfevents.*")
        exported = []
        for rec in read_records(path):
            event = parse_proto(rec)
            values = [parse_proto(v) for v in parse_proto(event[5][0])[1]] if 5 in event else []
            if values and all(2 in v for v in values):
                exported.append((event[2][0], {v[1][0].decode(): v[2][0] for v in values}))
        expect = [(r["step"], {k_: float(np.float32(v)) for k_, v in r.items()
                               if k_ not in ("step", "time", "type")}) for r in scalars]
        print(f"  export-tb: {len(exported)} scalar events equal to events.jsonl's "
              f"{exported == expect}")
        assert exported == expect

    torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    torch.backends.cudnn.benchmark = flags["cudnn.benchmark"]
    print(f"phase 8b: {time.perf_counter() - t_phase:.2f} s; seconds per command "
          f"{ {n_: round(v, 3) for n_, v in seconds.items()} }; launches {total} [{smi}]")
    return total, seconds


# -- phase 9: training at scale (bf16, remat, tiled kernels, data parallel) ----

# The CPU tests' bf16 tolerances (tests/test_torch_train.py): loss terms
# within 2e-2 relative, the three normal terms within 5e-2.
BF16_RTOL, BF16_NORMALS_RTOL = 2e-2, 5e-2
# The bf16 gradient against the f32 one from the same weights: the train
# step's grad_norm (relative), and the gradient with BatchNorm on running
# statistics (relative L2). Conv weights that take no gradient through
# their bf16 cast give about 1 in both. The train-mode gradient itself is
# not held: the random net's is chaotic under bf16 rounding.
BF16_GRAD_NORM_TOL = 2e-2
BF16_EVAL_GRAD_TOL = 0.2


def scale_heads(torch, model, factor=0.05):
    """Scale the disparity heads' kernels, as the CPU A/B tests do, so that
    their sigmoids start unsaturated and the loss terms are well-posed."""
    from cnmnet_tpu_torch.models.layers import DispHead

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DispHead):
                m[0].weight.mul_(factor)


def train_state(torch, cfg, seed, device):
    from cnmnet_tpu_torch.train import create_train_state

    state = create_train_state(cfg, seed, device)
    scale_heads(torch, state.model)
    return state


def terms(metrics):
    return {k_: float(v) for k_, v in metrics.items() if k_ not in ("viz", "grad_norm")}


def rel_l2(a, b):
    """Relative L2 distance of two ``{name: tensor}`` over every tensor,
    and the three names that take most of it."""
    parts = {n: float(((a[n].double() - t.double()) ** 2).sum()) for n, t in b.items()}
    den = sum(float((t.double() ** 2).sum()) for t in b.values())
    worst = sorted(parts, key=parts.get, reverse=True)[:3]
    return (sum(parts.values()) / max(den, 1e-300)) ** 0.5, worst


def gradient_errors(metrics_a, mu_a, metrics_b, mu_b):
    """How far one step's gradient is from another's: the relative
    difference of ``grad_norm``, and the relative L2 distance over every
    parameter of Adam's first moment after the step (``opt_state["mu"]``),
    ``(1 - b1) g`` of the clipped gradient when both started from zero."""
    ga, gb = float(metrics_a["grad_norm"]), float(metrics_b["grad_norm"])
    return abs(ga - gb) / max(abs(gb), 1e-30), rel_l2(mu_a, mu_b)[0]


def eval_mode_grads(cfg, model, batch):
    """The full CNM loss's gradient with BatchNorm on its running statistics
    (as ``tests/test_torch_train.py`` compares it with JAX's), by name."""
    from cnmnet_tpu_torch.train.loop import loss_and_grads, loss_weights_from_config

    model.eval()
    try:
        g, _, _ = loss_and_grads(model, batch, 0, loss_weights_from_config(cfg))
    finally:
        model.train()
    return {n: t for (n, _), t in zip(model.named_parameters(), g)}


def median_step_ms(torch, step, state, batch, warmup=3, reps=10):
    for _ in range(warmup):
        step(state, batch)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return statistics.median(ts) * 1e3, ts


def bf16_phase(torch, counters, smi, device="cuda", h=H, w=W, planes=P, k=K, steps=10):
    """Phase 9a: the training step in bf16 (f32 parameters, moments and norm
    statistics; convs in bf16): launches, f32 state, the first step's loss
    terms against the f32 step from the same weights, the median step time
    and one trace. Returns (launches per step, median ms, idle share)."""
    import copy

    from cnmnet_tpu_torch.data.synthetic import train_data_fn
    from cnmnet_tpu_torch.tools.profile_train import profile_step
    from cnmnet_tpu_torch.train import make_train_step
    from cnmnet_tpu_torch.train.loop import batch_to_device

    t_phase = time.perf_counter()
    cfg32 = train_config(h, w, planes, k)
    cfg16 = copy.deepcopy(cfg32)
    cfg16.model.compute_dtype = "bfloat16"
    batch = batch_to_device(next(iter(train_data_fn(cfg32)())), device)
    s16, s32 = train_state(torch, cfg16, 3, device), train_state(torch, cfg32, 3, device)
    conv = s16.model.depth_net.conv1[0]
    conv_dtype = conv(batch["images"].new_zeros(1, conv.in_channels, 8, 8)).dtype
    err_eval, worst_eval = rel_l2(eval_mode_grads(cfg16, s16.model, batch),
                                  eval_mode_grads(cfg32, s32.model, batch))
    step16 = make_train_step(cfg16)
    for c in counters.values():
        c.launches = 0
    s16, m16 = step16(s16, batch)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    s32, m32 = make_train_step(cfg32)(s32, batch)
    got, want = terms(m16), terms(m32)
    err = {n: abs(got[n] - want[n]) / max(abs(want[n]), 1e-30) for n in want}
    worst = max(err, key=err.get)
    err_gn, err_mu = gradient_errors(m16, s16.opt_state["mu"], m32, s32.opt_state["mu"])
    floats = [t for t in list(s16.model.state_dict().values())
              + [v for m in ("mu", "nu") for v in s16.opt_state[m].values()]
              if t.is_floating_point()]
    f32_state = all(t.dtype == torch.float32 for t in floats)
    print(f"bf16 step (batch 2, 3 views, {h}x{w}, {planes} planes, k={k}): launches {launches}; "
          f"parameters, moments and statistics f32 {f32_state}; loss terms against the f32 step "
          f"(TF32 off) from the same weights: worst {err[worst]:.3e} ({worst}; tol {BF16_RTOL}, "
          f"normal terms {BF16_NORMALS_RTOL}); loss bf16 {got['loss']:.5f} f32 {want['loss']:.5f}; "
          f"a conv's output {conv_dtype}; against the f32 step: grad_norm {err_gn:.3e} (tol "
          f"{BF16_GRAD_NORM_TOL}), Adam's first moment {err_mu:.3e} relative L2 (train mode: "
          f"not held); gradient with running statistics {err_eval:.3e} relative L2 (tol "
          f"{BF16_EVAL_GRAD_TOL}; most from {worst_eval})")
    assert launches == {"cost_volume": 1, "depth_to_normal": 3}, launches
    assert f32_state and all(np.isfinite(v) for v in got.values())
    assert conv_dtype == torch.bfloat16, conv_dtype
    assert err_gn <= BF16_GRAD_NORM_TOL and err_eval <= BF16_EVAL_GRAD_TOL, (err_gn, err_eval)
    for n, e in err.items():
        assert e <= (BF16_NORMALS_RTOL if "normal" in n else BF16_RTOL), (n, e)
    del s32
    if device == "cpu":
        return {n: v for n, v in launches.items()}, None, None
    ms, ts = median_step_ms(torch, step16, s16, batch, reps=steps)
    print(f"bf16 train step: median {ms:.3f} ms over {steps} steps after 3 warm-ups, "
          f"{2e3 / ms:.2f} samples/s, steps {[round(x * 1e3, 3) for x in ts]} (TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}) "
          f"[{smi}]")
    wall, busy, classes, rows, _ = profile_step(step16, s16, batch)
    idle = None if busy == 0 else 1 - busy / wall
    if busy:
        shares = ", ".join(f"{c} {v:.4f} ms" for c, v in sorted(classes.items(),
                                                                key=lambda x: -x[1]))
        print(f"profile bf16 train step: wall {wall:.3f} ms under the profiler, device busy "
              f"{busy:.3f} ms, idle share {idle:.3f}; by class: {shares} [{smi}]")
        for key, v, count in rows[:8]:
            print(f"  {v:9.4f} ms {count:4d}x {key[:110]}")
    else:
        print("profile bf16 train step: the profiler recorded no device time (not measured)")
    print(f"phase 9a: {time.perf_counter() - t_phase:.2f} s")
    return launches, ms, idle


REMAT_CONFIGS = (("off", False, -1, False), ("remat_stages=-1", True, -1, False),
                 ("remat_stages=2", True, 2, False),
                 ("remat_stages=2 + remat_refiner", True, 2, True))
# Loss terms and running statistics of a remat step against the plain step
# on the card: cuDNN may choose other algorithms in the recompute, so
# equality is not asked for; the first forward is the same code either way.
# The bf16 step's gradient is not deterministic on the card, and the random
# net's train-mode gradient magnifies that: two runs of the same plain step
# gave grad_norm 6.7e-4 and Adam's first moment, (1 - b1) g, 9.8e-3 apart
# in relative L2. So grad_norm is held to 5e-3 and the moment to 5e-2; a
# block whose recompute lost its gradient takes that block's share of both.
REMAT_TOL = 1e-3
REMAT_GRAD_NORM_TOL = 5e-3
REMAT_MU_TOL = 5e-2


def remat_phase(torch, counters, smi, device="cuda", h=480, w=640, batch_size=4, planes=P, k=K,
                steps=5):
    """Phase 9b: the bf16 step at 480x640, batch 4, with remat off, all
    encoder stages, two, and two plus the RefineNet (the JAX package's
    native-resolution configuration): peak memory, median step time,
    launches, and each remat step's loss terms and running statistics
    against the plain step's. Returns {config: (peak GiB, ms)} and the
    launches of the last configuration's first step."""
    from cnmnet_tpu_torch.data.synthetic import train_data_fn
    from cnmnet_tpu_torch.train import make_train_step
    from cnmnet_tpu_torch.train.loop import batch_to_device

    t_phase = time.perf_counter()
    cfg = train_config(h, w, planes, k)
    cfg.dataset.batch_size = batch_size
    cfg.dataset.synthetic_size = batch_size
    batch = batch_to_device(next(iter(train_data_fn(cfg)())), device)
    result, base = {}, None
    for name, remat, stages, refiner in REMAT_CONFIGS:
        cfg.model.compute_dtype = "bfloat16"
        cfg.model.remat, cfg.model.remat_stages, cfg.model.remat_refiner = remat, stages, refiner
        state = train_state(torch, cfg, 4, device)
        step = make_train_step(cfg)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        state, metrics = step(state, batch)
        launches = {n: c.launches for n, c in counters.items()}
        assert launches == {"cost_volume": 1, "depth_to_normal": 3}, (name, launches)
        peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" else float("nan")
        stats = {n: t.clone() for n, t in state.model.state_dict().items() if "running" in n}
        got = terms(metrics)
        assert all(np.isfinite(v) for v in got.values()), (name, got)
        first = (metrics, {n: t.clone() for n, t in state.opt_state["mu"].items()})
        if base is None:
            base = (got, stats, first)
            err_terms = err_stats = 0.0
            # The same step again from the same weights: the card's backward
            # is not deterministic, and the random net's train-mode gradient
            # magnifies that.
            again, m_again = step(train_state(torch, cfg, 4, device), batch)
            err_gn, err_mu = floor = gradient_errors(m_again, again.opt_state["mu"], *first)
            del again
        else:
            err_terms = max(abs(got[n] - v) / max(abs(v), 1e-30) for n, v in base[0].items())
            err_stats = max(((stats[n] - v).abs() / v.abs().clamp_min(1e-12)).max().item()
                            for n, v in base[1].items() if n.endswith("running_var"))
            err_gn, err_mu = gradient_errors(*first, *base[2])
            assert max(err_terms, err_stats) <= REMAT_TOL, (name, err_terms, err_stats)
            assert err_gn <= REMAT_GRAD_NORM_TOL and err_mu <= REMAT_MU_TOL, (name, err_gn, err_mu)
        ms = (median_step_ms(torch, step, state, batch, warmup=2, reps=steps)[0]
              if device != "cpu" else float("nan"))
        result[name] = (peak, ms)
        print(f"remat {name} (bf16, batch {batch_size}, 3 views, {h}x{w}): peak memory "
              f"{peak:.3f} GiB (max_memory_allocated over the first step, state included), "
              f"median step {ms:.3f} ms over {steps} after 2 warm-ups; launches {launches}; "
              f"against remat off: loss terms {err_terms:.3e}, running variances "
              f"{err_stats:.3e} (tol {REMAT_TOL}), grad_norm {err_gn:.3e} (tol "
              f"{REMAT_GRAD_NORM_TOL}), Adam's first moment "
              f"{err_mu:.3e} relative L2 (tol {REMAT_MU_TOL}); for remat off, the same step "
              f"again [{smi}]")
        del state, step, first
        if device != "cpu":
            torch.cuda.empty_cache()
    if device != "cpu":
        # The kernels at this path's shapes: 8 pairs at 480x640 (f32 and the
        # bf16 writeback that bf16 training asks for), and 4 depth maps.
        check_cost_volume(torch, h, w, planes, 2 * batch_size, 8)
        check_normals(torch, *normals_inputs(torch, batch_size, h, w, seed=32), k)
    print(f"phase 9b: {time.perf_counter() - t_phase:.2f} s; the plain step against itself: "
          f"grad_norm {floor[0]:.3e}, first moment {floor[1]:.3e}")
    return result, launches


def tiled_phase(torch, counters, smi, device="cuda", sizes=((H, W), (480, 640)), tiles=(2, 4),
                planes=P, k=K, runs=5):
    """Phase 9c: the tile axis emulated on one card. For each size and tile
    count, every row shard's kernel launch with its global row offset (the
    depth rows with their k // 2 halo rows, as the exchange delivers them;
    the reference rows against the whole source): the shards together
    must equal the untiled kernel, and each shard the plain version with
    the same offset (max abs 0 both). Times each shard's launch against
    the untiled one, with the shard's bound. Returns the launches and the
    timing table."""
    from cnmnet_tpu_torch.kernels.ablate import device_ms
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.ops import cost_volume as pcv
    from cnmnet_tpu_torch.ops import normals as pn
    from cnmnet_tpu_torch.parallel import sharding, tiled_ops
    from cnmnet_tpu_torch.tools.roofline import CV_FLOPS, bound, normals_flops

    t_phase = time.perf_counter()
    total = {n: 0 for n in counters}
    table = {}
    halo = k // 2
    for h, w in sizes:
        batch = synthetic_batch(2, h, w, 3, seed=50 + h)
        ref, src, rc, sc = cv_inputs(torch, 4, h, w, 0, batch)  # the train step's 4 pairs
        depth, kinv = normals_inputs(torch, 2, h, w, seed=60 + h)
        coefs = kcv.pack_coefs(rc, sc)
        idepths = pcv.idepth_hypotheses(3.0, planes, ref.device)
        untiled_n = kn.depth_to_normal_kernel(depth, kinv, k)
        untiled_cv = kcv.cost_volume_kernel(ref, src, coefs, idepths)
        n_ms = device_ms(lambda: kn.depth_to_normal_kernel(depth, kinv, k), runs=runs)
        cv_ms = device_ms(lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths), runs=runs)
        for tile in tiles:
            hl = h // tile
            rows = [slice(i * hl, (i + 1) * hl) for i in range(tile)]
            ranges = [(r.start, r.stop) for r in rows]
            depth_halo = [sharding.rows_from_shards([depth[:, r] for r in rows], ranges,
                                                    (a - halo, b + halo), 1).contiguous()
                          for a, b in ranges]
            refs = [ref[:, r].contiguous() for r in rows]
            for c in counters.values():
                c.launches = 0
            normals = [tiled_ops.depth_to_normal_shard(d, kinv, i * hl, halo, k)
                       for i, d in enumerate(depth_halo)]
            volumes = [tiled_ops.cost_volume_shard(r, src, rc, sc, i * hl, 3.0, planes)
                       for i, r in enumerate(refs)]
            torch.cuda.synchronize()
            launches = {n: c.launches for n, c in counters.items()}
            assert launches == {"cost_volume": tile, "depth_to_normal": tile}, launches
            for n in total:
                total[n] += launches[n]
            err_n = (torch.cat(normals, 1) - untiled_n).abs().max().item()
            err_cv = (torch.cat(volumes, 1) - untiled_cv.permute(0, 2, 3, 1)).abs().max().item()
            plain_n = max((normals[i] - pn.depth_to_normal(
                d, kinv, k, row_offset=i * hl - halo)[0][:, halo:halo + hl]).abs().max().item()
                for i, d in enumerate(depth_halo))
            plain_cv = max((volumes[i] - pcv.cost_volume_from_cameras(
                r, src, rc, sc, 3.0, planes, row_offset=i * hl)).abs().max().item()
                for i, r in enumerate(refs))
            print(f"tiled {h}x{w} tile {tile}: shards against the untiled kernel: depth->normal "
                  f"{err_n:.3e}, cost volume {err_cv:.3e}; each shard against the plain version "
                  f"with its row offset: {plain_n:.3e}, {plain_cv:.3e} (all must be 0); "
                  f"launches {launches}")
            assert err_n == err_cv == plain_n == plain_cv == 0, (err_n, err_cv, plain_n, plain_cv)
            shard_n = [device_ms(lambda d=d, i=i: kn.depth_to_normal_kernel(
                d, kinv, k, row_offset=i * hl - halo), runs=runs) for i, d in enumerate(depth_halo)]
            shard_cv = [device_ms(lambda r=r, i=i: kcv.cost_volume_kernel(
                r, src, coefs, idepths, row_offset=i * hl), runs=runs) for i, r in enumerate(refs)]
            # one shard's bounds: its halo-extended depth rows read and its
            # rows' normals written, the operations on all h + 2 halo rows;
            # its reference rows and the whole source read, its volume rows
            # written (f32), the operations of its rows
            rows_n = hl + 2 * halo
            bn = bound(2 * rows_n * w * 4 + 2 * 36 + 2 * hl * w * 12,
                       2 * rows_n * w * normals_flops(k))
            bcv = bound(4 * hl * w * 12 + 4 * h * w * 12 + 4 * 48 + planes * 4
                        + 4 * planes * hl * w * 4, 4 * planes * hl * w * CV_FLOPS)
            table[f"{h}x{w} tile {tile}"] = {
                "depth_to_normal": {"untiled_ms": n_ms, "shard_ms": shard_n,
                                    "shard_bound_ms": bn[0], "bound_by": bn[1]},
                "cost_volume": {"untiled_ms": cv_ms, "shard_ms": shard_cv,
                                "shard_bound_ms": bcv[0], "bound_by": bcv[1]}}
            print(f"  times (CUDA events, median of {runs} runs of 10 launches): depth->normal "
                  f"B=2 k={k} untiled {n_ms:.4f} ms, shards {[round(x, 4) for x in shard_n]} ms "
                  f"(shard bound {bn[0] * 1e3:.2f} us, {bn[1]}); cost volume 4 pairs f32 "
                  f"untiled {cv_ms:.4f} ms, shards {[round(x, 4) for x in shard_cv]} ms (shard "
                  f"bound {bcv[0] * 1e3:.2f} us, {bcv[1]}) [{smi}]")
    print(f"phase 9c: {time.perf_counter() - t_phase:.2f} s; launches {total}")
    return total, table


# One data-parallel step at world size 1 against the plain step (f32, TF32
# off): the global BatchNorm normalises with its own formula (flax's), so
# the two agree to rounding, not bit for bit.
DDP_TOL = 1e-3
# Adam's first moment after the step (relative L2): 2.4e-2 apart on the
# card, most of it in the first convs, whose train-mode gradient the random
# net makes chaotic; a global BatchNorm without a gradient through its
# statistics gives 6 (CPU, gloo, 32x64).
DDP_MU_TOL = 0.1


def ddp_phase(torch, counters, smi, device="cuda", backend="nccl", h=H, w=W, planes=P, k=K):
    """Phase 9d: ``torch.distributed`` at world size 1 (NCCL on the card):
    one ``make_train_step(cfg, make_mesh())`` step, which runs the global
    BatchNorm, the global loss reductions and the gradient all-reduce over
    the one-rank group, against the plain step from the same weights; then
    ``cli train`` with ``parallel.coordinator_address``: 2 steps into a
    checkpoint directory, and a resume to step 3. Returns the launches of
    the data-parallel step and of the two CLI runs."""
    import copy
    import os
    import tempfile

    import torch.distributed as dist

    from cnmnet_tpu_torch.data.synthetic import train_data_fn
    from cnmnet_tpu_torch.parallel.mesh import make_mesh
    from cnmnet_tpu_torch.tools._ranks import free_port
    from cnmnet_tpu_torch.train import make_train_step
    from cnmnet_tpu_torch.train.loop import batch_to_device

    t_phase = time.perf_counter()
    cfg = train_config(h, w, planes, k)
    batch = batch_to_device(next(iter(train_data_fn(cfg)())), device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        a = train_state(torch, cfg, 5, device)
        b = copy.deepcopy(a)
        for c in counters.values():
            c.launches = 0
        a, ma = make_train_step(cfg, mesh)(a, batch)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        backend_used = dist.get_backend(mesh.data_group)
    finally:
        dist.destroy_process_group()
    c = copy.deepcopy(b)
    b, mb = make_train_step(cfg)(b, batch)
    c, mc = make_train_step(cfg)(c, batch)
    floor = gradient_errors(mc, c.opt_state["mu"], mb, b.opt_state["mu"])
    del c
    got, want = terms(ma), terms(mb)
    err_gn = gradient_errors(ma, a.opt_state["mu"], mb, b.opt_state["mu"])[0]
    err_mu, worst_mu = rel_l2(a.opt_state["mu"], b.opt_state["mu"])
    err_terms = max(abs(got[n] - v) / max(abs(v), 1e-30) for n, v in want.items())
    sa, sb = a.model.state_dict(), b.model.state_dict()
    err_var = max(((sa[n] - sb[n]).abs() / sb[n].abs()).max().item() for n in sb
                  if n.endswith("running_var"))
    err_mean = max(((sa[n] - sb[n]).abs() / sb[n.replace("running_mean", "running_var")].sqrt())
                   .max().item() for n in sb if n.endswith("running_mean"))
    tracked = all(torch.equal(sa[n], sb[n]) for n in sb if n.endswith("num_batches_tracked"))
    print(f"data-parallel step at world size 1 ({backend_used}, mesh {mesh.shape}): launches "
          f"{launches}; against the plain step: loss terms {err_terms:.3e}, running variances "
          f"{err_var:.3e}, running means {err_mean:.3e} of the running std, grad_norm "
          f"{err_gn:.3e} (tol {DDP_TOL}), Adam's first moment {err_mu:.3e} relative L2 (most "
          f"from {worst_mu}; tol {DDP_MU_TOL}), num_batches_tracked equal {tracked}; the plain "
          f"step against itself: grad_norm {floor[0]:.3e}, first moment {floor[1]:.3e}")
    assert launches == {"cost_volume": 1, "depth_to_normal": 3}, launches
    assert max(err_terms, err_var, err_mean, err_gn) <= DDP_TOL and tracked
    assert err_mu <= DDP_MU_TOL, err_mu
    del a, b

    cli_launches = {n: 0 for n in counters}
    with tempfile.TemporaryDirectory(prefix="cnm_ddp_") as tmp:
        ckpt = f"{tmp}/ckpt"
        argv = ["--synthetic", "--device", device, f"dataset.image_height={h}",
                f"dataset.image_width={w}", f"model.num_planes={planes}", f"model.k_size={k}",
                "dataset.batch_size=2", "train.ckpt_interval=100", "train.ckpt_keep=1",
                "parallel.num_processes=1", "parallel.process_id=0",
                f"train.checkpoint_dir={ckpt}", f"train.log_dir={tmp}/logs"]
        for max_steps, extra, want_steps, want_dirs in (
                (2, [], 2, ["2"]), (3, [f"train.resume_dir={ckpt}"], 1, ["3"])):
            address = f"parallel.coordinator_address=127.0.0.1:{free_port()}"
            launches_cli, seconds, lines = run_cli(
                torch, counters, smi, ["train", "--max-steps", str(max_steps)] + argv
                + [address] + extra, device)
            assert launches_cli == {"cost_volume": want_steps,
                                    "depth_to_normal": 3 * want_steps}, launches_cli
            assert sorted(os.listdir(ckpt)) == want_dirs, os.listdir(ckpt)
            assert lines[-1] == f"done: step {max_steps}", lines[-1]
            assert not dist.is_initialized()
            for n in cli_launches:
                cli_launches[n] += launches_cli[n]
    print(f"cli train with a coordinator address (world size 1): 2 steps, checkpoint 2, resumed "
          f"to 3; launches {cli_launches}")
    print(f"phase 9d: {time.perf_counter() - t_phase:.2f} s [{smi}]")
    return launches, cli_launches


# -- phase 10: the tile axis and the mesh, two processes on the one card -------

# The f32 step (TF32 off) over a mesh of two ranks against the one-process
# step from the same weights, relative: loss terms, grad_norm and the
# BatchNorm running statistics (variances; means relative to the running
# standard deviation). PR 6's bar for the data-parallel step at world size
# 1 (flax's one-pass variance against cuDNN's); the row shards add convs on
# other shapes, which cuDNN may run with other algorithms. grad_norm is held
# to phase 9b's remat bar instead: the first run of this phase gave
# 1.099e-03 at 2 x 1 (batch-1 convs against batch 2; 5.803e-04 at 1 x 2),
# where the data-parallel step at world size 1 gave 1.873e-04 (PR 6): the
# random net's train-mode gradient magnifies rounding. The f64 CPU tests
# hold the same steps to 1e-10 (tests/test_torch_ranks.py); a halved
# gradient or per-rank BatchNorm statistics move grad_norm by 1e-2 or more.
MESH_TOL, MESH_GRAD_NORM_TOL = 1e-3, 5e-3
# The eval flush and the session over the mesh against one process (f32,
# TF32 off): phase 3's bar for two paths that differ by rounding, idepth and
# prob max |d| 1e-2 and idepth relative L2 1e-4 (random weights amplify an
# ulp through the conv stack at the most sensitive pixels). The normals of
# a random net's depth are ill-conditioned (a rounding of the depth turns
# them, as tests/test_multichip.py notes), so the mesh's normals are held
# instead to the untiled kernel on the mesh's own depth: max abs 0.
MESH_MAP_TOL, MESH_L2_TOL = 1e-2, 1e-4
MESH_CELLS = ((1, 2), (2, 1))


class KernelRecorder:
    """Within the block, every launch of either kernel through its wrapper
    (``kernels/cost_volume.cost_volume``, ``kernels/normals.depth_to_normal``)
    keeps its inputs and output; ``errors()`` then runs the plain versions
    on them (no launch) and returns each kernel's largest difference."""

    def __init__(self, torch):
        from cnmnet_tpu_torch.kernels import cost_volume as kcv
        from cnmnet_tpu_torch.kernels import normals as kn

        self.torch, self.kcv, self.kn = torch, kcv, kn
        self.calls = {"cost_volume": [], "depth_to_normal": []}

    def __enter__(self):
        kcv, kn = self.kcv, self.kn
        self._cv, self._dn = kcv.cost_volume, kn.depth_to_normal

        def cost_volume(*args, **kwargs):
            out = self._cv(*args, **kwargs)
            self.calls["cost_volume"].append((args, kwargs, out.detach().clone()))
            return out

        def depth_to_normal(depth, intrinsics_inv, k_size=9, row_offset=0):
            out = self._dn(depth, intrinsics_inv, k_size, row_offset)
            self.calls["depth_to_normal"].append(
                ((depth.detach().float().clone(), intrinsics_inv.detach().float().clone(),
                  k_size, row_offset), {}, out[0].detach().clone()))
            return out

        kcv.cost_volume, kn.depth_to_normal = cost_volume, depth_to_normal
        return self

    def __exit__(self, *exc):
        self.kcv.cost_volume, self.kn.depth_to_normal = self._cv, self._dn

    def errors(self):
        import inspect

        from cnmnet_tpu_torch.ops import cost_volume as pcv
        from cnmnet_tpu_torch.ops import normals as pn

        err = {n: 0.0 for n in self.calls}
        sig = inspect.signature(self._cv)
        for args, kwargs, out in self.calls["cost_volume"]:
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            p = a.arguments
            plain = pcv.cost_volume_from_cameras(
                p["ref_images"], p["src_images"], p["ref_cam"], p["src_cam"], p["idepth_scale"],
                p["num_planes"], p["row_offset"]).to(p["out_dtype"])
            err["cost_volume"] = max(err["cost_volume"], (out - plain).abs().max().item())
        for (depth, kinv, k, offset), _, out in self.calls["depth_to_normal"]:
            plain, _ = pn.depth_to_normal(depth, kinv, k, row_offset=offset)
            err["depth_to_normal"] = max(err["depth_to_normal"], (out - plain).abs().max().item())
        return err


def _launches(counters):
    return {n: c.launches for n, c in counters.items()}


def _zero(counters):
    for c in counters.values():
        c.launches = 0


def _map_errors(torch, got, want, cams, k, device):
    """Two ``(idepth [B, H, W], prob, normal)`` triples (numpy): idepth and
    prob max |d|, idepth relative L2, and the first triple's normals against
    the untiled kernel on its own depth, ``1 / (idepth + 1e-8)``."""
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
    from cnmnet_tpu_torch.kernels import dispatch

    d = [float(np.abs(g - w).max()) for g, w in zip(got[:2], want[:2])]
    l2 = float(np.linalg.norm(got[0] - want[0]) / max(np.linalg.norm(want[0]), 1e-30))
    depth = 1.0 / (torch.from_numpy(got[0]).to(device) + 1e-8)
    kinv = invert_intrinsics(torch.from_numpy(cams).to(device)[:, 0, 1, :3, :3])
    untiled = dispatch.depth_to_normal(depth, kinv, k)[0].cpu().numpy()
    return {"idepth_max": d[0], "prob_max": d[1], "idepth_l2": l2,
            "normal_vs_untiled": float(np.abs(got[2] - untiled).max())}


def _step_errors(torch, ma, sa, mb, sb):
    """Loss terms, grad_norm and running statistics of step a against step b."""
    ga, gb = terms(ma), terms(mb)
    out = {"terms": max(abs(ga[n] - v) / max(abs(v), 1e-30) for n, v in gb.items()),
           "worst_term": max(gb, key=lambda n: abs(ga[n] - gb[n]) / max(abs(gb[n]), 1e-30)),
           "grad_norm": abs(float(ma["grad_norm"]) - float(mb["grad_norm"]))
           / float(mb["grad_norm"])}
    a, b = sa.model.state_dict(), sb.model.state_dict()
    out["running_var"] = max(((a[n] - b[n]).abs() / b[n].abs()).max().item() for n in b
                             if n.endswith("running_var"))
    out["running_mean"] = max(((a[n] - b[n]).abs() / b[n.replace("running_mean", "running_var")]
                               .sqrt()).max().item() for n in b if n.endswith("running_mean"))
    return out


def mesh_cell(torch, counters, mesh, device, h, w, big, planes, k, steps):
    """One mesh's checks on this rank (see ``mesh_phase``); the first rank
    also runs the one-process computations and the differences."""
    import copy

    from cnmnet_tpu_torch.config import Config
    from cnmnet_tpu_torch.data.pipeline import normalize_images, quantize_images_u8
    from cnmnet_tpu_torch.data.synthetic import train_data_fn
    from cnmnet_tpu_torch.evals.seven_scenes_eval import make_eval_forward
    from cnmnet_tpu_torch.models.layers import init_weights
    from cnmnet_tpu_torch.parallel import collectives
    from cnmnet_tpu_torch.parallel.sharding import shard_batch
    from cnmnet_tpu_torch.serve import InferenceSession
    from cnmnet_tpu_torch.train import make_train_step
    from cnmnet_tpu_torch.train.loop import batch_to_device
    from cnmnet_tpu_torch.train.state import build_model

    lead = mesh.rank == 0
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out, launches, errors = {}, {}, {n: 0.0 for n in counters}

    def kernels_equal(rec):
        for n, e in rec.errors().items():
            errors[n] = max(errors[n], e)

    # (a) the f32 train step over the mesh against one process
    cfg = train_config(h, w, planes, k)
    batch = batch_to_device(next(iter(train_data_fn(cfg)())), device)
    state = train_state(torch, cfg, 6, device)
    step = make_train_step(cfg, mesh)
    _zero(counters)
    with KernelRecorder(torch) as rec:
        t = time.perf_counter()
        state, metrics = step(state, shard_batch(mesh, batch))
        sync()
        out["step_s"] = time.perf_counter() - t
    launches["step"] = _launches(counters)
    kernels_equal(rec)
    del rec
    if lead:
        ref, mref = make_train_step(cfg)(train_state(torch, cfg, 6, device), batch)
        out["step"] = _step_errors(torch, metrics, state, mref, ref)
        del ref
    del state, step

    # (b) the bf16 step at native resolution over the tile axis: memory, time
    if mesh.tile > 1:
        cfg16 = train_config(*big, planes, k)
        cfg16.dataset.batch_size = cfg16.dataset.synthetic_size = 4
        cfg16.model.compute_dtype = "bfloat16"
        big_batch = batch_to_device(next(iter(train_data_fn(cfg16)())), device)
        state = train_state(torch, cfg16, 4, device)
        step = make_train_step(cfg16, mesh)
        if cuda:
            torch.cuda.empty_cache()
            sync()
            torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        state, m16 = step(state, big_batch)
        sync()
        launches["bf16_step"] = _launches(counters)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
        out["bf16_ms"], ts = (median_step_ms(torch, step, state, big_batch, warmup=1, reps=steps)
                              if cuda else (float("nan"), []))
        out["bf16_loss"] = float(m16["loss"])
        del state, step, big_batch

    # weights for the eval flush and the session: seeded, BatchNorm
    # statistics from frames (the first rank's, sent to every rank)
    weights_cfg = Config()
    weights_cfg.model.num_planes, weights_cfg.model.k_size = planes, k
    model = build_model(weights_cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(device)
    calib = synthetic_batch(2, h, w, 3, seed=12)
    calibrate_batch_norm(torch, model, torch.from_numpy(quantize_images_u8(calib["images"]))
                         .to(device), torch.from_numpy(calib["cams"].astype(np.float32))
                         .to(device))
    src = mesh.ranks[0]
    for t in model.state_dict().values():
        collectives.broadcast_(t, src, mesh.mesh_group)
    weights = {n: t.clone() for n, t in model.state_dict().items()}

    # (c) a 3-view eval flush at native resolution over the mesh
    frames = synthetic_batch(mesh.data, *big, 3, seed=21)
    images = normalize_images(frames["images"])
    cams = frames["cams"].astype(np.float32)
    fwd = make_eval_forward(model, k_size=k, device=device, mesh=mesh)
    fwd(images, cams)  # loads cuDNN's algorithms for these shapes
    sync()
    _zero(counters)
    with KernelRecorder(torch) as rec:
        got = fwd(images, cams)
        sync()
    launches["flush"] = _launches(counters)
    kernels_equal(rec)
    del rec
    if lead:
        plain = build_model(weights_cfg)
        plain.load_state_dict(weights)
        want = make_eval_forward(plain, k_size=k, device=device)(images, cams)
        squeeze = lambda t: t.float().cpu().numpy().squeeze(-1) if t.shape[-1] == 1 \
            else t.float().cpu().numpy()  # noqa: E731
        out["flush"] = _map_errors(torch, [squeeze(g) for g in got], [squeeze(x) for x in want],
                                   cams, k, device)
        del plain, want
    del got, fwd, model

    # (d) the mesh session: the first rank answers, the other follows
    kw = dict(cfg=weights_cfg, state_dict=weights, compute_dtype="float32", device=device,
              batch_buckets=(1, 4))
    session = InferenceSession(mesh=mesh, **kw)
    req = synthetic_batch(3, h, w, 3, seed=31)
    u8, rcams = quantize_images_u8(req["images"]), req["cams"].astype(np.float32)
    _zero(counters)
    with KernelRecorder(torch) as rec:
        if lead:
            got = session.predict(u8, rcams)
            session.close()
        else:
            out["served"] = session.follow()
        sync()
    launches["session"] = _launches(counters)
    kernels_equal(rec)
    del rec
    if lead:
        want = InferenceSession(**kw).predict(u8, rcams)
        out["session"] = _map_errors(torch, [got[n] for n in ("idepth", "prob", "normal")],
                                     [want[n] for n in ("idepth", "prob", "normal")], rcams, k,
                                     device)
        out["buckets"] = list(session.buckets)
    out["launches"], out["kernel_errors"] = launches, errors
    return out


def mesh_worker(rank, port, out_dir, device="cuda", h=H, w=W, big=(480, 640), planes=P, k=K,
                steps=3):
    """One rank of phase 10: joins a gloo group of two on ``port`` and runs
    ``mesh_cell`` over each mesh of ``MESH_CELLS``; writes
    ``out_dir/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device != "cpu":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    counters = {"cost_volume": kcv.cost_volume_kernel, "depth_to_normal": kn.depth_to_normal_kernel}
    result = {"backend": dist.get_backend()}
    try:
        for data, tile in MESH_CELLS:
            t = time.perf_counter()
            mesh = make_mesh(data=data, tile=tile)
            result[f"{data}x{tile}"] = mesh_cell(torch, counters, mesh, device, h, w, big,
                                                 planes, k, steps)
            result[f"{data}x{tile}"]["seconds"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(result, f)
    return 0


def mesh_phase(torch, counters, smi, device="cuda", timeout=900, **sizes):
    """Phase 10: the tile axis through the conv stack and serving and
    evaluation on a mesh, two processes on the one card (gloo; a CUDA
    tensor crosses through host memory, ``parallel/collectives.py``), over
    a 1 x 2 mesh, then a 2 x 1 mesh, at full width (``Config()``, 64 planes,
    k = 9): (a) the f32 step at 192x256, batch 2, TF32 off, against the
    one-process step from the same weights (``MESH_TOL``,
    ``MESH_GRAD_NORM_TOL``); (b) at tile 2,
    the bf16 step at 480x640, batch 4, remat off: each rank's peak
    ``max_memory_allocated`` and median step ms; (c) a 3-view eval flush at
    480x640 (1/32 has 15 rows: 7/8) against the one-process flush; (d) the
    mesh session (rank 0 answers, rank 1 follows) against the one-process
    session (``MESH_MAP_TOL``, ``MESH_L2_TOL``; the normals against the
    untiled kernel on the same depth). Every kernel launch of every rank, held
    to its plain version on its own inputs (max abs 0), and the per-rank
    launch counters of each path. Returns the two ranks' results."""
    import os
    import tempfile

    from cnmnet_tpu_torch.tools._ranks import free_port

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cnm_mesh_") as out:
        port = str(free_port())
        args = [json.dumps({"device": device, **sizes})]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker",
                                   str(r), port, out] + args, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                print(f"mesh worker {r} failed (rc {p.returncode}):\n{log[-6000:]}")
        assert all(p.returncode == 0 for p in procs), [p.returncode for p in procs]
        ranks = []
        for r in range(2):
            with open(f"{out}/rank{r}.json") as f:
                ranks.append(json.load(f))
    print(f"phase 10 transport: torch.distributed {ranks[0]['backend']}, two processes on one "
          "card; CUDA tensors cross through host memory (gloo has no CUDA all_gather, NCCL "
          "refuses two ranks on one device); compute and both kernels on the card in each rank")
    cuda = device != "cpu"
    for data, tile in MESH_CELLS:
        key = f"{data}x{tile}"
        lead, other = ranks[0][key], ranks[1][key]
        s, f, se = lead["step"], lead["flush"], lead["session"]
        print(f"mesh {key} (data x tile; {sizes.get('h', H)}x{sizes.get('w', W)} step and "
              f"session, native flush): f32 step against one process (TF32 off): loss terms "
              f"{s['terms']:.3e} (worst {s['worst_term']}), grad_norm {s['grad_norm']:.3e}, "
              f"running variances {s['running_var']:.3e}, running means {s['running_mean']:.3e} "
              f"of the running std (tol {MESH_TOL}; grad_norm {MESH_GRAD_NORM_TOL}); step host "
              f"seconds rank 0 {lead['step_s']:.3f}, rank 1 {other['step_s']:.3f}")
        for name, e in (("eval flush", f), ("session", se)):
            print(f"  {name} against one process: idepth max|d| {e['idepth_max']:.3e}, prob "
                  f"max|d| {e['prob_max']:.3e} (tol {MESH_MAP_TOL}), idepth relative L2 "
                  f"{e['idepth_l2']:.3e} (tol {MESH_L2_TOL}); normals against the untiled "
                  f"kernel on the mesh's depth: max abs {e['normal_vs_untiled']:.3e} (must be 0)")
        for r, d in enumerate((lead, other)):
            print(f"  rank {r}: launches {d['launches']}; every launch against its plain "
                  f"version: max abs {d['kernel_errors']} (must be 0); {d['seconds']:.2f} s")
        if "peak_gib" in lead:
            print(f"  bf16 step 480x640 batch 4, remat off, tile 2: peak max_memory_allocated rank "
                  f"0 {lead['peak_gib']:.3f} GiB, rank 1 {other['peak_gib']:.3f} GiB (phase 9b "
                  f"untiled: 13.890 GiB, PR 6); median step rank 0 {lead['bf16_ms']:.3f} ms, rank "
                  f"1 {other['bf16_ms']:.3f} ms [{smi}]")
        assert max(s["terms"], s["running_var"], s["running_mean"]) <= MESH_TOL, s
        assert s["grad_norm"] <= MESH_GRAD_NORM_TOL, s
        for e in (f, se):
            assert max(e["idepth_max"], e["prob_max"]) <= MESH_MAP_TOL, e
            assert e["idepth_l2"] <= MESH_L2_TOL and e["normal_vs_untiled"] == 0, e
        assert lead["buckets"] == ([2, 4] if data == 2 else [1, 4]), lead["buckets"]
        assert other["served"] == 1, other["served"]
        if cuda:
            for d in (lead, other):
                assert all(v == 0 for v in d["kernel_errors"].values()), d["kernel_errors"]
                per_step = {"cost_volume": 1, "depth_to_normal": 3}
                assert d["launches"]["step"] == per_step, d["launches"]
                if "bf16_step" in d["launches"]:
                    assert d["launches"]["bf16_step"] == per_step, d["launches"]
                once = {"cost_volume": 1, "depth_to_normal": 1}
                assert d["launches"]["flush"] == d["launches"]["session"] == once, d["launches"]
    print(f"phase 10: {time.perf_counter() - t_phase:.2f} s [{smi}]")
    return ranks


# -- phase 11: the offline tools, the native loader and imported checkpoints --

RAW_H, RAW_W, RAW_FRAMES = 480, 640, 30
JPEG_QUALITY = 95
# The native decode against the array the JPEG was written from, at quality
# 95 with libjpeg's default 4:2:0 chroma on the raw scene's texture: JPEG's
# loss, in levels of 255 (mean 0.56 and max 10 with libjpeg-turbo 62 on
# x86-64; another libjpeg may round differently).
JPEG_MEAN_TOL, JPEG_MAX_TOL = 1.5, 32
# ``load_rgb_normalized`` against ``load_rgb_u8`` on the same file: the u8
# path rounds the resized value to a level, half a level at most (divided
# by the smallest ImageNet std), plus the f32 rounding of the two affines.
U8_ROUND_TOL = 0.5 / 255 / 0.224 + 1e-5

# The fixture writer of the raw scene's JPEGs, built against the same libjpeg
# as the native loader: not a part of the port.
JPEG_WRITER = r"""
#include <stdio.h>
#include <jpeglib.h>
int write_jpeg(const char* path, const unsigned char* rgb, int w, int h, int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, f);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(rgb + (size_t)c.next_scanline * w * 3);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(f);
  return 0;
}
"""


def native_toolchain():
    """What the native loader's build needs, looked up before building: the
    path of ``g++`` and, for each of ``jpeglib.h`` and ``png.h``, the
    directory of the compiler's include path that holds it (None where
    absent). The phase decides by this, never by catching a build error."""
    import os
    import shutil

    gxx = shutil.which("g++")
    dirs = []
    if gxx:
        out = subprocess.run([gxx, "-E", "-x", "c++", "-", "-v"], input="", capture_output=True,
                             text=True, timeout=60).stderr.splitlines()
        if "#include <...> search starts here:" in out:
            start = out.index("#include <...> search starts here:") + 1
            dirs = [line.strip() for line in out[start:] if line.startswith(" ")]
    found = {hdr: next((d for d in dirs if os.path.isfile(os.path.join(d, hdr))), None)
             for hdr in ("jpeglib.h", "png.h")}
    return gxx, found


def build_jpeg_writer(directory):
    """``write(path, rgb u8 [H, W, 3], quality)`` through ``JPEG_WRITER``,
    compiled with gcc into ``directory``."""
    import ctypes
    import os

    src = os.path.join(directory, "jpeg_writer.c")
    lib = os.path.join(directory, "jpeg_writer.so")
    with open(src, "w") as f:
        f.write(JPEG_WRITER)
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", src, "-o", lib, "-ljpeg"], check=True,
                   capture_output=True, timeout=120)
    fn = ctypes.CDLL(lib).write_jpeg
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int

    def write(path, rgb, quality=JPEG_QUALITY):
        rgb = np.ascontiguousarray(rgb, np.uint8)
        assert fn(path.encode(), rgb.ctypes.data, rgb.shape[1], rgb.shape[0], quality) == 0, path

    return write


def write_raw_scene(scene, write_jpeg, frames=RAW_FRAMES, h=RAW_H, w=RAW_W, seed=11):
    """A raw ScanNet-layout scene (``tests/test_prep_planes.py``'s
    ``mock_scene`` layout) at ``h x w``: ``pose/`` (camera to world),
    ``intrinsic/``, 16-bit ``depth/`` in mm, ``annotation/planes.npy`` (world
    planes, offset times unit normal) with RGB-packed global plane ids in
    ``annotation/segmentation/``, ``lg_normal/`` and, with a JPEG writer,
    ``color/`` JPEGs (``rgb/`` links to it, the loader's name). The geometry
    is one ``data/synthetic`` room ray-cast from a camera that moves 2 cm a
    frame along x and turns slowly. Returns the world planes."""
    import os

    from cnmnet_tpu_torch.data.imageio import write_png
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes

    for sub in ("pose", "intrinsic", "depth", "lg_normal", "annotation/segmentation"):
        os.makedirs(os.path.join(scene, sub))
    ds = SyntheticScenes(num_samples=1, height=h, width=w, seed=seed)
    rng = np.random.default_rng(seed)
    planes = ds._planes(rng)
    K = ds._camera(rng)
    K4 = np.eye(4)
    K4[:3, :3] = K
    for name in ("intrinsic_color.txt", "intrinsic_depth.txt"):
        np.savetxt(os.path.join(scene, "intrinsic", name), K4)
    world = np.stack([p["n"] * p["d"] for p in planes]).astype(np.float32)
    np.save(os.path.join(scene, "annotation", "planes.npy"), world)
    if write_jpeg is not None:
        os.makedirs(os.path.join(scene, "color"))
        os.symlink("color", os.path.join(scene, "rgb"))
    for i in range(frames):
        E = np.eye(4, dtype=np.float32)
        a = 0.004 * i
        E[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        E[0, 3] = -0.02 * i
        depth, normal, label, pts_w = ds._raycast(K, E, planes)
        np.savetxt(os.path.join(scene, "pose", f"{i}.txt"), np.linalg.inv(E.astype(np.float64)))
        write_png(os.path.join(scene, "depth", f"{i}.png"),
                  np.round(depth * 1000).astype(np.uint16))
        np.save(os.path.join(scene, "lg_normal", f"{i}.npy"), normal)
        packed = label.astype(np.int64) + 1
        seg = np.stack([packed // 65536, (packed // 256) % 256, packed % 256], -1)
        write_png(os.path.join(scene, "annotation", "segmentation", f"{i}.png"),
                  seg.astype(np.uint8))
        if write_jpeg is not None:
            rgb = np.round(ds._texture(pts_w, label) * 255).astype(np.uint8)
            np.save(os.path.join(scene, "color", f"{i}.src.npy"), rgb)
            write_jpeg(os.path.join(scene, "color", f"{i}.jpg"), rgb)
    return world


def cv2_jpeg_writer():
    """``write(path, rgb u8 [H, W, 3], quality)`` through cv2's JPEG encoder
    (cv2 takes BGR), or None where cv2 does not import: the raw scene's
    JPEGs where the native loader's headers are missing."""
    try:
        import cv2
    except ImportError:
        return None

    def write(path, rgb, quality=JPEG_QUALITY):
        bgr = np.ascontiguousarray(np.asarray(rgb, np.uint8)[..., ::-1])
        assert cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, quality]), path

    return write


def native_phase(torch, smi, scene, write_jpeg, tmp):
    """11b: the native loader on this host against the arrays the JPEGs
    were written from (JPEG's loss), ``load_rgb_normalized`` against
    ``load_rgb_u8``, ``load_depth_meters`` exactly against ``read_png`` +
    ``resize_nearest`` + the clamp, and ``load_frames`` ms per frame at 1
    and 4 threads from 1296x968 to 192x256."""
    import os

    from cnmnet_tpu_torch.data import native
    from cnmnet_tpu_torch.data.imageio import read_png, resize_nearest, write_png

    err_mean = err_max = norm_err = 0.0
    for i in range(0, RAW_FRAMES, 7):
        path = os.path.join(scene, "color", f"{i}.jpg")
        src = np.load(os.path.join(scene, "color", f"{i}.src.npy")).astype(np.int32)
        full = native.load_rgb_u8(path, RAW_W, RAW_H).astype(np.int32)  # no resize: the decode
        diff = np.abs(full - src)
        err_mean, err_max = max(err_mean, float(diff.mean())), max(err_max, int(diff.max()))
        u8 = native.load_rgb_u8(path, W, H).astype(np.float32) / 255.0
        f32 = native.load_rgb_normalized(path, W, H)
        norm_err = max(norm_err, float(np.abs(f32 - (u8 - native.IMAGENET_MEAN)
                                              / native.IMAGENET_STD).max()))
        got = native.load_depth_meters(os.path.join(scene, "depth", f"{i}.png"), W, H, 0.1, 5.0)
        want = resize_nearest(read_png(os.path.join(scene, "depth", f"{i}.png")), H, W)
        want = want.astype(np.float32) * np.float32(0.001)
        want[(want < np.float32(0.1)) | (want > np.float32(5.0))] = 0.0
        assert np.array_equal(got, want), f"native depth of frame {i} differs"
    print(f"  11b native decode (quality {JPEG_QUALITY}): against the source arrays mean |d| "
          f"{err_mean:.4f} (tol {JPEG_MEAN_TOL}), max {err_max} levels (tol {JPEG_MAX_TOL}); "
          f"load_rgb_normalized against load_rgb_u8 {norm_err:.3e} (tol {U8_ROUND_TOL:.3e}); "
          f"load_depth_meters equal to read_png + resize_nearest + clamp")
    assert err_mean <= JPEG_MEAN_TOL and err_max <= JPEG_MAX_TOL and norm_err <= U8_ROUND_TOL

    big = os.path.join(tmp, "big")
    os.makedirs(big)
    rng = np.random.default_rng(3)
    y, x = np.mgrid[:968, :1296]
    rgbs, depths = [], []
    for i in range(8):
        tex = np.stack([128 + 90 * np.sin((x + 9 * i) / 13.0 + y / 29.0),
                        128 + 90 * np.cos((x + 9 * i) / 23.0 - y / 17.0),
                        128 + 80 * np.sin((x + y + 9 * i) / 11.0)], -1)
        tex = np.clip(tex + rng.normal(0, 8, tex.shape), 0, 255).astype(np.uint8)
        rgbs.append(os.path.join(big, f"{i}.jpg"))
        write_jpeg(rgbs[-1], tex)
        depths.append(os.path.join(big, f"{i}.png"))
        write_png(depths[-1], (1500 + 10 * x + y).astype(np.uint16) % 6000)
    ms = {}
    for threads in (1, 4):
        native.load_frames(rgbs, depths, W, H, num_threads=threads)  # warm the page cache
        ts = []
        for _ in range(3):
            t = time.perf_counter()
            native.load_frames(rgbs, depths, W, H, num_threads=threads)
            ts.append(time.perf_counter() - t)
        ms[threads] = statistics.median(ts) * 1e3 / len(rgbs)
    print(f"  11b load_frames 1296x968 -> {H}x{W}, one JPEG and one depth PNG a frame: "
          f"{ms[1]:.3f} ms/frame at 1 thread, {ms[4]:.3f} ms/frame at 4 threads [{smi}]")
    return {"jpeg_mean": err_mean, "jpeg_max": err_max, "ms_per_frame": ms}


def reference_state_dict(torch, model, seed):
    """A reference-format checkpoint (``{depth_network_state_dict,
    depth_refine_network_state_dict, global_step}``, Sequential names,
    BatchNorm counters, DataParallel's prefix on the DepthNet), built as
    ``tests/test_torch_import.py`` builds one: random values in the shapes
    of ``model``'s tensors, heads scaled so their sigmoids stay unsaturated.
    Returns it and the port ``state_dict`` that holds the same values."""
    g = torch.Generator().manual_seed(seed)
    port, ref = {}, {"depth_network_state_dict": {}, "depth_refine_network_state_dict": {}}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            value = torch.tensor(100)
        elif name.endswith("running_var"):
            value = torch.rand(t.shape, generator=g) + 0.5
        elif name.endswith("weight") and t.dim() == 4:
            fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            scale = 0.05 if "disp" in name or "prob" in name else 1.0
            value = torch.randn(t.shape, generator=g) * (scale * (2.0 / fan_in) ** 0.5)
        else:
            value = torch.randn(t.shape, generator=g) * 0.1 + (1.0 if name.endswith("weight")
                                                                else 0.0)
        port[name] = value
        net, _, rest = name.partition(".")
        key = {"depth_net": "depth_network_state_dict",
               "refine_net": "depth_refine_network_state_dict"}[net]
        ref[key][("module." if net == "depth_net" else "") + rest] = value
    ref["global_step"] = 1234
    return ref, port


def converter_npz(torch, model, seed, step):
    """``tools/orbax_to_npz.py``'s layout from seeded port tensors: flax
    keys (``models/transplant.key_map``, OIHW kernels back to HWIO), Adam's
    moments under ``opt_state/{mu,nu}/``, ``step`` and ``epoch``. Returns the
    arrays and the port ``state_dict`` and moments that they hold."""
    from cnmnet_tpu_torch.models.transplant import key_map

    g = torch.Generator().manual_seed(seed)
    _, port = reference_state_dict(torch, model, seed)
    arrays, moments = {}, {"mu": {}, "nu": {}}
    for fkey, (tkey, transform) in key_map(model).items():
        value = port[tkey].numpy()
        inverse = (lambda a: np.transpose(a, (2, 3, 1, 0))) if value.ndim == 4 else (lambda a: a)
        arrays[fkey] = inverse(value)
        if fkey.startswith("params/"):
            mu = torch.randn(port[tkey].shape, generator=g) * 1e-3
            nu = torch.rand(port[tkey].shape, generator=g) * 1e-6
            moments["mu"][tkey], moments["nu"][tkey] = mu, nu
            arrays[f"opt_state/mu/{fkey[7:]}"] = inverse(mu.numpy())
            arrays[f"opt_state/nu/{fkey[7:]}"] = inverse(nu.numpy())
    arrays["step"], arrays["epoch"] = np.asarray(step), np.asarray(1)
    return arrays, port, moments


def import_phase(torch, counters, smi, tmp, size, device="cuda", h=H, w=W):
    """11c: a reference checkpoint through ``--torch-ckpt`` and a converter
    ``.npz`` through ``--npz``, each served by ``cli infer --checkpoint``
    and held to ``InferenceSession(state_dict=...)`` on the same weights
    (max abs 0); one train step resumed from the ``.npz`` import, whose
    restored moments equal the ones written. Returns the launches and the
    seconds per command."""
    import glob
    import os

    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.data.pipeline import quantize_images_u8
    from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
    from cnmnet_tpu_torch.serve import InferenceSession
    from cnmnet_tpu_torch.train import import_checkpoint
    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.state import build_model, create_train_state

    cfg = apply_overrides(Config(), size)
    model = build_model(cfg)
    total = {n: 0 for n in counters}
    seconds = {}
    os.makedirs(f"{tmp}/frames")
    scenes = SyntheticScenes(num_samples=4, height=h, width=w, view_num=3, seed=41)
    frames = [scenes[i] for i in range(4)]
    for i, f in enumerate(frames):
        np.savez(f"{tmp}/frames/frame{i}.npz", images=quantize_images_u8(f["images"]),
                 cams=f["cams"].astype(np.float32))
    images = np.stack([quantize_images_u8(f["images"]) for f in frames])
    cams = np.stack([f["cams"].astype(np.float32) for f in frames])

    def serve_and_compare(name, ckpt_dir, state_dict):
        out_dir = f"{tmp}/preds_{name}"
        launches, seconds[f"infer {name}"], _ = run_cli(
            torch, counters, smi, ["infer", "--inputs", f"{tmp}/frames/*.npz", "--out-dir",
                                   out_dir, "--batch", "4", "--checkpoint", ckpt_dir,
                                   "--device", device] + size, device)
        assert launches == {n: 1 for n in counters}, launches
        for n, v in launches.items():
            total[n] += v
        want = InferenceSession(cfg, state_dict=state_dict, batch_buckets=(1, 4),
                                device=device).predict(images, cams)
        assert all(np.isfinite(v).all() for v in want.values()), name
        err = 0.0
        for i in range(4):
            with np.load(f"{out_dir}/frame{i}.pred.npz") as z:
                assert set(z.files) == set(want)
                err = max(err, max(float(np.abs(z[k] - want[k][i]).max()) for k in want))
        print(f"  11c infer --checkpoint ({name} import) against InferenceSession(state_dict=) "
              f"on the same weights: max abs {err:.3e} (must be 0)")
        assert err == 0, err
        assert len(glob.glob(f"{out_dir}/*.pred.npz")) == 4

    # the reference's checkpoint
    ref, port = reference_state_dict(torch, model, seed=51)
    torch.save(ref, f"{tmp}/reference.pt")
    t = time.perf_counter()
    assert import_checkpoint.main(["--torch-ckpt", f"{tmp}/reference.pt", "--out",
                                   f"{tmp}/from_reference"] + size) == 0
    seconds["import --torch-ckpt"] = time.perf_counter() - t
    assert CheckpointManager(f"{tmp}/from_reference", device="cpu").latest_step() == 1234
    serve_and_compare("reference", f"{tmp}/from_reference", port)

    # a converted JAX checkpoint
    arrays, port, moments = converter_npz(torch, model, seed=52, step=5)
    np.savez(f"{tmp}/state.npz", **arrays)
    t = time.perf_counter()
    assert import_checkpoint.main(["--npz", f"{tmp}/state.npz", "--out", f"{tmp}/from_npz"]
                                  + size) == 0
    seconds["import --npz"] = time.perf_counter() - t
    serve_and_compare("npz", f"{tmp}/from_npz", port)

    # resume from the npz import: the restored moments are the ones written
    template = create_train_state(cfg, 0, device)
    state = CheckpointManager(f"{tmp}/resume", device=device).restore(f"{tmp}/from_npz", template)
    assert state.step == 5 and state.opt_state["count"] == 5
    for m in ("mu", "nu"):
        for name, value in moments[m].items():
            assert torch.equal(state.opt_state[m][name].cpu(), value), (m, name)
    del state, template
    launches, seconds["train (resumed)"], _ = run_cli(
        torch, counters, smi, ["train", "--synthetic", "--max-steps", "6", "--device", device]
        + size + ["dataset.batch_size=2", f"train.resume_dir={tmp}/from_npz",
                  f"train.checkpoint_dir={tmp}/resume", f"train.log_dir={tmp}/logs"], device)
    assert launches == {"cost_volume": 1, "depth_to_normal": 3}, launches
    for n, v in launches.items():
        total[n] += v
    assert CheckpointManager(f"{tmp}/resume", device="cpu").latest_step() == 6
    print(f"  11c resumed the npz import at step 5 (moments equal to the ones written) and "
          f"trained to step 6")
    return total, seconds


def offline_phase(torch, counters, smi, device="cuda", h=H, w=W, planes=P, k=K, steps=3,
                  keep=None):
    """Phase 11: the offline tools, the native loader and imported
    checkpoints at full width, under PyTorch's defaults (cuDNN TF32 on).
    With ``g++``, ``jpeglib.h`` and ``png.h`` on the host, or else with cv2:
    a raw ScanNet-layout scene (its JPEGs written by libjpeg or by cv2)
    through ``cli prep-cameras``, ``prep-planes`` and ``prep-list``, ``cli
    train`` on the prepared tree fed by the native loader, or by
    ``ScanNetDataset(use_native=False)``'s cv2 path (every sample on that
    path, one cost volume and three depth->normals a step, finite losses)
    and ``cli eval-scannet --planes`` on its checkpoint (11a); with the
    headers, the native decode against the source arrays (11b). With
    neither, the steps that need no JPEG run: ``prep-cameras`` and
    ``prep-planes``. Then ``cli eval --save-dir`` on a mock 7-Scenes tree and
    ``cli report`` over it, and the imported checkpoints (11c); ``keep``, a
    path, receives the ``.npz`` import's checkpoint directory. Returns the
    launches per kernel, the seconds per command and 11b's figures."""
    import glob
    import os
    import shutil
    import tempfile

    from cnmnet_tpu_torch.data import native, scannet

    gxx, headers = native_toolchain()
    jpeg = gxx is not None and all(headers.values())
    cv2_write = None if jpeg else cv2_jpeg_writer()
    loader = "native" if jpeg else "cv2" if cv2_write is not None else None
    print(f"phase 11: g++ {gxx}; headers {headers}; the JPEG path: {loader}")
    if loader == "cv2":
        print("phase 11: the host lacks g++ or the libjpeg/libpng headers: the native "
              "loader cannot be built and its decode is left out; cv2 imports, so the raw "
              "scene's JPEGs are written by cv2 and read by ScanNetDataset(use_native=False)")
    elif loader is None:
        print("phase 11: the host lacks the libjpeg/libpng headers and cv2: the steps that "
              "read or write a JPEG are left out (prep-list, train and eval-scannet on the "
              "prepared tree, the native decode)")
    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    t_phase = time.perf_counter()
    size = [f"dataset.image_height={h}", f"dataset.image_width={w}",
            f"model.num_planes={planes}", f"model.k_size={k}"]
    total = {n: 0 for n in counters}
    seconds, decode = {}, None

    def count(name, launches, want):
        assert launches == want, (name, launches, want)
        for n_, v in launches.items():
            total[n_] += v

    with tempfile.TemporaryDirectory(prefix="cnm_offline_") as tmp:
        root = f"{tmp}/scannet"
        scene = f"{root}/scene0000_00"
        write_jpeg = cv2_write
        if jpeg:
            t = time.perf_counter()
            native_ok = native.available()
            print(f"  native loader: built {native.library_path()} in "
                  f"{time.perf_counter() - t:.2f} s")
            assert native_ok, native.build_error()
            write_jpeg = build_jpeg_writer(tmp)
        t = time.perf_counter()
        world = write_raw_scene(scene, write_jpeg)
        print(f"  raw scene: {RAW_FRAMES} frames at {RAW_H}x{RAW_W}, {len(world)} world planes, "
              f"JPEGs by {({'native': 'libjpeg', 'cv2': 'cv2'}).get(loader, 'nothing')}, "
              f"written in {time.perf_counter() - t:.2f} s")

        # 11a: the raw scene through the offline tools
        launches, seconds["prep-cameras"], lines = run_cli(
            torch, counters, smi, ["prep-cameras", "--scene-dir", scene, "--out-width",
                                   str(RAW_W), "--out-height", str(RAW_H)], device)
        count("prep-cameras", launches, {n_: 0 for n_ in counters})
        assert lines[-1] == f"wrote {RAW_FRAMES} camera files", lines
        launches, seconds["prep-planes"], lines = run_cli(
            torch, counters, smi, ["prep-planes", "--scene-dir", scene, "--num-workers", "4"],
            device)
        count("prep-planes", launches, {n_: 0 for n_ in counters})
        written = int(lines[-1].split()[1])
        per_frame = [len(np.load(p)) for p in
                     sorted(glob.glob(f"{scene}/planercnn_para_003/*.npy"))]
        print(f"  prep-planes: {written} of {RAW_FRAMES} frames annotated, planes per frame "
              f"{sorted(set(per_frame))}")
        assert written >= RAW_FRAMES - 2 and len(per_frame) == written
        assert all(n >= 2 for n in per_frame)

        trained = False
        forced = {"use_native": False} if loader == "cv2" else {}
        if loader:
            launches, seconds["prep-list"], lines = run_cli(
                torch, counters, smi, ["prep-list", "--root-dir", root, "--out",
                                       f"{root}/train.txt", "--frame-stride", "1"], device)
            count("prep-list", launches, {n_: 0 for n_ in counters})
            samples = int(lines[-1].split()[1])
            assert samples >= 2 * steps, lines
            run = [f"dataset.root_dir={root}", f"dataset.list_filepath={root}/train.txt",
                   f"train.log_dir={tmp}/logs", f"train.checkpoint_dir={tmp}/ckpt"]
            with Spy(scannet, "ScanNetDataset", **forced) as built:
                launches, seconds["train"], _ = run_cli(
                    torch, counters, smi, ["train", "--max-steps", str(steps), "--device",
                                           device, "dataset.batch_size=2",
                                           "train.print_interval=1"] + size + run, device)
            count("train", launches, {"cost_volume": steps, "depth_to_normal": 3 * steps})
            paths = [ds.path for ds in built.results]
            with open(f"{tmp}/logs/events.jsonl") as f:
                losses = [json.loads(line)["loss"] for line in f
                          if json.loads(line)["type"] == "scalars"]
            print(f"  train on the prepared tree ({samples} samples): the loader's path "
                  f"{paths}, losses {[round(v, 4) for v in losses]}, {seconds['train']:.2f} s "
                  f"for {steps} steps")
            assert paths == [loader], paths
            assert losses and all(np.isfinite(losses))
            trained = True
            with Spy(scannet, "ScanNetDataset", **forced) as built:
                launches, seconds["eval-scannet"], lines = run_cli(
                    torch, counters, smi, ["eval-scannet", "--planes", "--max-samples", "4",
                                           "--checkpoint", "latest", "--device", device,
                                           f"dataset.test_list_filepath={root}/train.txt"]
                    + size + run, device)
            count("eval-scannet", launches, {n_: 8 for n_ in counters})
            assert [ds.path for ds in built.results] == [loader]
            metrics = dict(line.split(": ") for line in lines if ": " in line)
            assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
            print(f"  eval-scannet on the prepared tree ({loader} path): "
                  f"{ {n_: round(float(v), 4) for n_, v in metrics.items()} }")
            if jpeg:
                decode = native_phase(torch, smi, scene, write_jpeg, tmp)

        # cli eval --save-dir on a mock 7-Scenes tree, and cli report over it
        seven = f"{tmp}/7scenes"
        write_seven_scenes(seven, 30, seed=23)
        ckpt = ["--checkpoint", "latest"] if trained else []
        launches, seconds["eval"], _ = run_cli(
            torch, counters, smi, ["eval", "--views", "3", "--max-frames-per-seq", "3",
                                   "--save-dir", f"{tmp}/artifacts", "--device", device] + ckpt
            + [f"dataset.root_dir={seven}", f"train.checkpoint_dir={tmp}/ckpt"] + size, device)
        count("eval", launches, {n_: 6 for n_ in counters})
        launches, seconds["report"], lines = run_cli(
            torch, counters, smi, ["report", f"{tmp}/artifacts"], device)
        count("report", launches, {n_: 0 for n_ in counters})
        pngs = sorted(glob.glob(f"{tmp}/artifacts/*/*/*/*.png"))
        pages = {}
        for scene_, seq in EVAL_SEQS:
            with open(f"{tmp}/artifacts/{scene_}/{seq}/index.html") as f:
                pages[f"{scene_}/{seq}"] = f.read()
        missing = [p for p in pngs if os.path.relpath(p, os.path.dirname(os.path.dirname(p)))
                   not in pages["/".join(p.split(os.sep)[-4:-2])]]
        with open(f"{tmp}/artifacts/index.html") as f:
            index = f.read()
        print(f"  report: {lines[-1][:100]}; {len(pngs)} artifact PNGs, each referenced by its "
              f"sequence page: {not missing}")
        assert pngs and not missing and all(f"{s}/index.html" in index for s in pages)

        # 11c: imported checkpoints
        launches, import_s = import_phase(torch, counters, smi, f"{tmp}/import",
                                          size + [f"train.checkpoint_dir={tmp}/ckpt"], device,
                                          h, w)
        for n_, v in launches.items():
            total[n_] += v
        seconds.update(import_s)
        if keep is not None:
            shutil.move(f"{tmp}/import/from_npz", keep)

    torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]
    print(f"phase 11: {time.perf_counter() - t_phase:.2f} s; seconds per command "
          f"{ {n_: round(v, 3) for n_, v in seconds.items()} }; launches {total} [{smi}]")
    return total, seconds, decode


# -- phase 12: the measurement surface -----------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_kind"}
# the tools that run the model: both launch counters must move in each
MODEL_TOOLS = ("bench 192x256", "bench 480x640", "bench_batched", "bench_protocols",
               "bench_protocols 480x640", "roofline", "bench_serving", "train_synth",
               "two_stage_recipe")
SERVING_FRACTIONS = (0.25, 0.5, 0.75, 0.9)


def measure_phase(torch, counters, smi, rate, checkpoint, device="cuda", h=H, w=W, native=(480, 640),
                  iters=16, ks="1,3", requests=200):
    """Phase 12: ``cli bench`` and every ``cnmnet_tpu_torch.tools`` module in
    this process at full width under PyTorch's defaults, each with the
    launch counters around it: bench at 192x256 and 480x640; bench_batched
    at 1, 4, 8, 16; bench_protocols (3/5/7 views at 192x256, 3 at 480x640);
    the roofline's eight phases; profile_forward at batch 8 and
    profile_train (bf16, batch 2); bench_serving open loop at
    ``SERVING_FRACTIONS`` of ``rate`` (phase 8a's requests/s), ``requests``
    each; bench_cv (1, 8, 16 pairs bf16, 4 pairs f32: the train shape) and
    bench_normals, equal to their plain versions; check_gt_normal on 4
    synthetic samples; visualize from ``checkpoint`` (phase 11's import);
    train_synth for 4 steps; two_stage_recipe with 3 steps a stage. Fails
    where a tool exits non-zero, a kernel differs from its plain version, a
    model tool leaves a launch counter at 0 or a roofline share passes
    100%. Returns the launches per kernel, each tool's seconds and its
    rows."""
    import os
    import tempfile

    from cnmnet_tpu_torch import cli
    from cnmnet_tpu_torch.tools import (bench_batched, bench_cv, bench_normals, bench_protocols,
                                        bench_serving, check_gt_normal, profile_forward,
                                        profile_train, roofline, train_synth, two_stage_recipe,
                                        visualize)

    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    t_phase = time.perf_counter()
    dev = ["--device", device]
    it = ["--iters", str(iters)]
    short = ["--iters", str(max(2, iters // 2))]  # the tools with the longest calls
    size = [f"--height={h}", f"--width={w}"]
    loads = ",".join(f"{f * rate:.3f}" for f in SERVING_FRACTIONS)
    total = {n: 0 for n in counters}
    seconds, rows = {}, {}
    with tempfile.TemporaryDirectory(prefix="cnm_measure_") as tmp:
        tools = [
            ("bench 192x256", cli.main, ["bench", f"--height={h}", f"--width={w}"] + dev),
            ("bench 480x640", cli.main, ["bench", f"--height={native[0]}",
                                         f"--width={native[1]}"] + dev),
            ("bench_batched", bench_batched.main, ["--batches", "1,4,8,16"] + short + size + dev),
            ("bench_protocols", bench_protocols.main, ["--views", "3,5,7", "--sizes",
                                                       f"{h}x{w}"] + it + dev),
            ("bench_protocols 480x640", bench_protocols.main,
             ["--views", "3", "--sizes", f"{native[0]}x{native[1]}"] + it + dev),
            ("roofline", roofline.main, ["--phases", ",".join(roofline.TITLES), "--ks", ks]
             + short + dev),
            ("profile_forward", profile_forward.main, ["--batch", "8", "--iters", "5",
                                                       "--top", "15"] + size + dev),
            ("profile_train", profile_train.main, ["--batch", "2", "--iters", "2", "--top",
                                                   "15"] + size + dev),
            ("bench_serving", bench_serving.main, ["--loads", loads, "--requests",
                                                   str(requests), "--max-wait-ms", "5"]
             + size + dev),
            ("bench_cv", bench_cv.main, ["--batches", "1,8,16"] + it + size + dev),
            ("bench_cv train shape", bench_cv.main, ["--batches", "4", "--dtype", "float32"]
             + it + size + dev),
            ("bench_normals", bench_normals.main, ["4", str(h), str(w), "9", str(iters)] + dev),
            ("check_gt_normal", check_gt_normal.main, ["--num-samples", "4"] + size + dev),
            ("visualize", visualize.main, ["--checkpoint", checkpoint, "--out",
                                           f"{tmp}/viz", "--samples", "2"] + size + dev),
            ("train_synth", train_synth.main, ["--steps", "4", "--pool", "4", "--batch", "2",
                                               "--print-every", "2", "--eval-scenes", "2",
                                               "--out", f"{tmp}/synth"] + size + dev),
            ("two_stage_recipe", two_stage_recipe.main, ["--steps", "3", "--workdir",
                                                         f"{tmp}/two_stage"] + dev),
        ]
        launches = {}
        for name, main, argv in tools:
            launches[name], seconds[name], lines = run_tool(
                torch, counters, smi, f"tool {name}", main, argv, device)
            rows[name] = [json.loads(line) for line in lines if line.startswith("{")]
            for n, v in launches[name].items():
                total[n] += v
        pngs = sorted(os.listdir(f"{tmp}/viz"))
    torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
    torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]

    for name in ("bench 192x256", "bench 480x640"):
        (line,) = rows[name]
        assert set(line) == BENCH_KEYS and line["value"] > 0, line
    if device != "cpu":
        for name in MODEL_TOOLS:
            assert all(v > 0 for v in launches[name].values()), (name, launches[name])
        for row in rows["roofline"]:
            assert row["mfu_pct"] <= 100 and row["hbm_pct"] <= 100, row
    kernel_rows = rows["bench_cv"] + rows["bench_cv train shape"] + rows["bench_normals"]
    assert all(r["max_abs_err"] == 0 for r in kernel_rows), kernel_rows
    assert len(rows["roofline"]) == len(roofline.TITLES)
    assert len(rows["bench_serving"]) == len(SERVING_FRACTIONS)
    assert all(r["answered"] == requests for r in rows["bench_serving"]), rows["bench_serving"]
    assert rows["two_stage_recipe"][0]["ok"] and pngs == ["sample_0.png", "sample_1.png"], pngs
    took = time.perf_counter() - t_phase
    print(f"phase 12: {took:.2f} s (budget 120 s); seconds per tool "
          f"{ {n: round(v, 3) for n, v in seconds.items()} }; launches {total} [{smi}]")
    return total, seconds, rows


# -- phase 13: the scale-out surface -------------------------------------------------

SCALE_VARIANTS = "base,no_normals,k5,f32,rematr,s2d"
SCALE_TOOLS = ("dryrun_multichip 1", "scaling_sweep", "probe_multichip_hlo 1 1", "bwd_probe",
               "verify_step_time")


def wide_k_paths(torch, counters, smi, device="cuda", h=H, w=W, planes=P, k=19):
    """``model.k_size`` above the unrolled k through the kernel: one f32
    train step of ``Config()`` at ``k`` (three depth->normals with a
    gradient, finite loss) and one eval flush of ``make_eval_forward(model,
    k)`` (one launch), whose normals equal the plain version's on the
    flush's own depth (max abs 0). Returns the launches of each."""
    from cnmnet_tpu_torch.data.pipeline import quantize_images_u8
    from cnmnet_tpu_torch.evals.seven_scenes_eval import make_eval_forward
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
    from cnmnet_tpu_torch.kernels import dispatch
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    cfg = train_config(h, w, planes, k)
    state = create_train_state(cfg, 0, device)
    batch = tiny_batch(2, h, w, device=device)
    _zero(counters)
    state, metrics = make_train_step(cfg)(state, batch)
    loss = float(metrics["loss"])
    train = _launches(counters)
    assert math.isfinite(loss), metrics
    scenes = synthetic_batch(2, h, w, 3, seed=60)
    u8, cams = quantize_images_u8(scenes["images"]), scenes["cams"].astype(np.float32)
    forward = make_eval_forward(state.model, k, device)
    _zero(counters)
    idepth, _, normal = forward(u8, cams)
    if device != "cpu":
        torch.cuda.synchronize()
    flush = _launches(counters)
    depth = 1.0 / (idepth[..., 0] + 1e-8)
    kinv = invert_intrinsics(torch.from_numpy(cams[:, 0, 1, :3, :3]).to(depth.device))
    plain, _ = dispatch.depth_to_normal(depth, kinv, k, backend="torch")
    err = (normal - plain).abs().max().item()
    print(f"model.k_size={k}: f32 train step loss {loss:.4f}, launches {train}; eval flush "
          f"(2 frames) launches {flush}, normals against the plain version on its depth: max "
          f"abs {err:.3e} (must be 0) [{smi}]")
    assert torch.isfinite(normal).all() and err == 0, err
    if device != "cpu":
        assert train == {"cost_volume": 1, "depth_to_normal": 3}, train
        assert flush == {"cost_volume": 1, "depth_to_normal": 1}, flush
    return {"train_step": train, "eval_flush": flush}


def scale_phase(torch, counters, smi, device="cuda", h=H, w=W, batch=8, ks="2,4,12", reps=10,
                iters=5):
    """Phase 13: the scale-out surface, each tool through its ``main`` with
    the launch counters around it (a tool whose ranks are processes reports
    each rank's counters): (a) ``entry()``'s flagship forward (f32, TF32
    off) against the same model with ``cv_backend="torch"`` (phase 3's f32
    bar: idepth and prob max |d| 1e-2, idepth relative L2 1e-4), one
    cost-volume launch and no depth->normal (JAX's ``fn`` runs none);
    then under PyTorch's defaults: (b) ``dryrun_multichip(1)`` on NCCL at
    world size 1, and ``dryrun_multichip(2)`` refused on one card; (c)
    ``scaling_sweep`` over 1x1, 2x1 and 1x2 at ``h`` x ``w``, 64 planes,
    per-device batch 2 (one measured row, two skips); (d)
    ``probe_multichip_hlo 1 1`` (the census at world size 1); (e)
    ``bwd_probe`` at ``batch`` over ``SCALE_VARIANTS``; (f)
    ``verify_step_time 2``; (g) ``model.k_size=19`` in a train step and an
    eval flush (``wide_k_paths``). Fails where a tool exits non-zero, a loss
    is not finite or a model tool leaves a launch counter at 0. Returns the
    launches per tool, each tool's seconds and its rows."""
    from cnmnet_tpu_torch import entry
    from cnmnet_tpu_torch.tools import (bwd_probe, probe_multichip_hlo, scaling_sweep,
                                        verify_step_time)

    t_phase = time.perf_counter()
    cuda = device != "cpu"
    dev = ["--device", device]
    seconds, rows, launches = {}, {}, {}

    # (a) entry()'s single-card forward against its plain versions (TF32 off)
    t = time.perf_counter()
    fn, (images, cams) = entry.entry(device)
    fn(images, cams)
    _zero(counters)
    got = fn(images, cams)
    if cuda:
        torch.cuda.synchronize()
    launches["entry"] = _launches(counters)
    fn.model.cv_backend = "torch"
    want = fn(images, cams)
    fn.model.cv_backend = None
    shapes = [tuple(o.shape) for o in got]
    d_idepth = (got[0] - want[0]).abs().max().item()
    d_prob = (got[1] - want[1]).abs().max().item()
    l2 = ((got[0] - want[0]).norm() / want[0].norm()).item()
    seconds["entry"] = time.perf_counter() - t
    print(f"entry ok: {shapes}; launches {launches['entry']}; against cv_backend='torch' (f32, "
          f"TF32 off): idepth max|d| {d_idepth:.3e}, prob max|d| {d_prob:.3e} (tol 1e-2), "
          f"idepth relative L2 {l2:.3e} (tol 1e-4) [{smi}]")
    assert shapes == [(1, H, W, 1)] * 2 and all(torch.isfinite(o).all() for o in got)
    assert max(d_idepth, d_prob) <= 1e-2 and l2 <= 1e-4, (d_idepth, d_prob, l2)
    if cuda:
        assert launches["entry"] == {"cost_volume": 1, "depth_to_normal": 0}, launches["entry"]
    del fn, images, cams, got, want

    flags = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    try:
        # (b) the multi-card dryrun at world size 1; two ranks need two cards
        dryrun = {}

        def dryrun_main(argv):
            dryrun.update(entry.dryrun_multichip(int(argv[1]), device))
            return 0

        _, seconds["dryrun_multichip 1"], lines = run_tool(
            torch, counters, smi, "tool dryrun_multichip 1", dryrun_main, ["multichip", "1"],
            device)
        launches["dryrun_multichip 1"] = dryrun["ranks"][0]["launches"]
        assert lines[-1] == (f"dryrun_multichip ok: mesh={ {'data': 1, 'tile': 1} } "
                             f"loss={dryrun['loss']:.4f}") and math.isfinite(dryrun["loss"])
        if cuda and torch.cuda.device_count() == 1:
            try:
                entry.dryrun_multichip(2, device)
            except ValueError as e:
                print(f"dryrun_multichip 2 on one card refused: {e}")
            else:
                raise AssertionError("dryrun_multichip(2) ran two ranks on one card")

        tools = [
            ("scaling_sweep", scaling_sweep.main,
             ["--meshes", "1x1,2x1,1x2", f"--height={h}", f"--width={w}", "--planes", "64",
              "--per-device-batch", "2", "--iters", str(iters)] + dev),
            ("probe_multichip_hlo 1 1", probe_multichip_hlo.main, ["1", "1"] + dev),
            ("bwd_probe", bwd_probe.main, ["--batch", str(batch), f"--height={h}",
                                           f"--width={w}", "--variants", SCALE_VARIANTS,
                                           "--ks", ks] + dev),
            ("verify_step_time", verify_step_time.main, ["2", f"--height={h}", f"--width={w}",
                                                         "--reps", str(reps)] + dev),
        ]
        texts = {}
        for name, main, argv in tools:
            here, seconds[name], texts[name] = run_tool(torch, counters, smi, f"tool {name}",
                                                        main, argv, device)
            rows[name] = [json.loads(line) for line in texts[name] if line.startswith("{")]
            launches[name] = here
        # (g) k above the unrolled instances, in training and evaluation
        t = time.perf_counter()
        launches["model.k_size=19"] = wide_k_paths(torch, counters, smi, device, h, w)
        seconds["model.k_size=19"] = time.perf_counter() - t
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags["cuda.matmul.allow_tf32"]
        torch.backends.cudnn.allow_tf32 = flags["cudnn.allow_tf32"]

    # the ranks of the sweep and the census count in their own processes
    *swept, closing = rows["scaling_sweep"]
    measured = swept[0]
    skips = [line for line in texts["scaling_sweep"] if line.startswith("skip ")]
    launches["scaling_sweep"] = measured["launches"][0]
    assert measured["mesh"] == "1x1" and closing == {"sweep": swept}, rows["scaling_sweep"]
    if cuda and torch.cuda.device_count() == 1:
        assert len(swept) == 1, swept
        assert skips == ["skip 2x1: only 1 devices", "skip 1x2: only 1 devices"], skips
    (census,) = rows["probe_multichip_hlo 1 1"]
    launches["probe_multichip_hlo 1 1"] = census["launches"]
    assert census["by_caller"]["gradients"]["bytes"] == 4 * census["params"], census
    assert "row_fetch" not in census["by_caller"]
    bwd = {r["variant"]: r for r in rows["bwd_probe"]}
    assert list(bwd) == SCALE_VARIANTS.split(","), list(bwd)
    assert bwd["k5"]["gflop"] < bwd["base"]["gflop"] and bwd["s2d"]["gflop"] == bwd["base"]["gflop"]
    (verify,) = rows["verify_step_time"]
    assert len(verify["losses"]) == reps
    losses = ([dryrun["loss"], measured["loss"], census["loss"]] + verify["losses"])
    assert all(math.isfinite(v) for v in losses), losses
    if cuda:
        for name in SCALE_TOOLS:  # train steps: both kernels, never the upsampling (NCHW)
            got = launches[name]
            assert all(got[n] > 0 for n in counters) and got.get("upsample", 0) == 0, (name, got)
        for name, r in bwd.items():  # the timed steps: one cost volume each
            assert r["launches"]["cost_volume"] == r["steps_timed"], (name, r["launches"])
    took = time.perf_counter() - t_phase
    print(f"phase 13: {took:.2f} s (budget 90 s); seconds per tool "
          f"{ {n: round(v, 3) for n, v in seconds.items()} }; launches {launches} [{smi}]")
    return launches, seconds, rows


def main() -> int:
    import os
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an "
              "NVIDIA card", file=sys.stderr)
        return 2

    from cnmnet_tpu_torch.kernels import build
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.kernels.ablate import device_ms
    from cnmnet_tpu_torch.kernels import normals as kn
    from cnmnet_tpu_torch.kernels import upsample as kups
    from cnmnet_tpu_torch.ops import cost_volume as pcv
    from cnmnet_tpu_torch.ops import normals as pn
    from cnmnet_tpu_torch.tools.profile_forward import profile_call
    from cnmnet_tpu_torch.tools.roofline import bound, kernel_cost

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {build_s:.2f} s for {len(logs)} sources")

    # 2. kernels against their plain versions
    main_batch = synthetic_batch(1, H, W, 3, seed=5)
    _, cv_err = check_cost_volume(torch, H, W, P, 2, 0, main_batch)
    check_cost_volume(torch, 30, 100, 6, 2, 1)
    check_cost_volume(torch, 40, 130, 9, 2, 2)
    check_cost_volume(torch, 31, 97, 5, 3, 7)
    check_cost_volume(torch, 480, 640, 64, 2, 3)
    batch4 = synthetic_batch(4, H, W, 3, seed=7)
    check_cost_volume(torch, H, W, P, 8, 0, batch4)  # bucket 4: 8 pairs
    batch8 = synthetic_batch(8, H, W, 3, seed=6)
    check_cost_volume(torch, H, W, P, 16, 0, batch8)  # bucket 8: 16 pairs
    check_cost_volume(torch, H, W, P, 48, 0, synthetic_batch(8, H, W, 7, seed=8))  # 7 views: 48
    check_cost_volume_edges(torch, 4)
    nrm_err = None
    for B in (1, 4, 8):  # the serving buckets' depth maps
        depth, kinv = normals_inputs(torch, B, H, W, seed=20 + B)
        for k in (5, 9):
            e = check_normals(torch, depth, kinv, k)
            if B == 1 and k == K:
                nrm_err = e
    check_normals(torch, *normals_inputs(torch, 1, 480, 640, seed=30), K)
    check_normals(torch, *normals_inputs(torch, 2, 157, 203, seed=31), K)
    wide_k = check_wide_k(torch, smi)
    chunked = check_cost_volume_chunks(torch, smi)
    normals_chunks = check_normals_batch_chunks(torch)

    # 3. the serving slice, with the launch counters
    counters = {"cost_volume": kcv.cost_volume_kernel, "depth_to_normal": kn.depth_to_normal_kernel}
    session, weights, u8, cams, launches, up_launches, served = serve_phase(torch, counters)

    # 4. times at the serving shapes (bucket 1: 2 pairs, one depth map;
    # bucket 8: 16 pairs, eight depth maps)
    ref, src, rc, sc = cv_inputs(torch, 2, H, W, 0, main_batch)
    coefs = kcv.pack_coefs(rc, sc)
    idepths = pcv.idepth_hypotheses(3.0, P, ref.device)
    cv_ms = device_ms(lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths, torch.bfloat16))
    cv_plain_ms = device_ms(
        lambda: pcv.cost_volume_from_cameras(ref, src, rc, sc, 3.0, P).to(torch.bfloat16))
    flops, nbytes = kernel_cost("cost_volume", (2, H, W, P), out_bytes=2)
    cv_bound, cv_by = bound(nbytes, flops)
    cv32_ms = device_ms(lambda: kcv.cost_volume_kernel(ref, src, coefs, idepths))
    flops, nbytes = kernel_cost("cost_volume", (2, H, W, P), out_bytes=4)
    cv32_bound, cv32_by = bound(nbytes, flops)
    r16, s16, rc16, sc16 = cv_inputs(torch, 16, H, W, 0, batch8)
    c16 = kcv.pack_coefs(rc16, sc16)
    cv16_ms = device_ms(lambda: kcv.cost_volume_kernel(r16, s16, c16, idepths, torch.bfloat16))
    flops, nbytes = kernel_cost("cost_volume", (16, H, W, P), out_bytes=2)
    cv16_bound, cv16_by = bound(nbytes, flops)
    print(f"cost_volume bf16 writeback: 2 pairs kernel {cv_ms:.4f} ms, bound "
          f"{cv_bound * 1e3:.2f} us ({cv_by}), ratio {cv_ms / cv_bound:.2f}; 16 pairs kernel "
          f"{cv16_ms:.4f} ms, bound {cv16_bound * 1e3:.2f} us ({cv16_by}), ratio "
          f"{cv16_ms / cv16_bound:.2f}")

    rows = {}
    for B in (1, 8):
        depth, kinv = normals_inputs(torch, B, H, W, seed=40 + B)
        ms = device_ms(lambda: kn.depth_to_normal_kernel(depth, kinv, K))
        plain_ms = device_ms(lambda: pn.depth_to_normal(depth, kinv, K))
        flops, nbytes = kernel_cost("depth_to_normal", (B, H, W, K))
        rows[B] = (ms, plain_ms) + bound(nbytes, flops)
    print(f"cost_volume f32 writeback (2 pairs): kernel {cv32_ms:.4f} ms, bound "
          f"{cv32_bound * 1e3:.2f} us ({cv32_by})")
    for B in (1, 8):
        print(f"depth_to_normal B={B} k=9: kernel {rows[B][0]:.4f} ms, plain {rows[B][1]:.4f} "
              f"ms, bound {rows[B][2] * 1e3:.2f} us ({rows[B][3]}), ratio "
              f"{rows[B][0] / rows[B][2]:.2f}")

    upsample = check_upsample(torch, smi, served)
    del served

    rates = {}
    for B in (1, 8):
        imgs, cm = u8[:B], cams[:B]
        for _ in range(3):
            session.predict(imgs, cm)
        ts = []
        for _ in range(20):
            t = time.perf_counter()
            session.predict(imgs, cm)
            ts.append(time.perf_counter() - t)
        t = statistics.median(ts)
        rates[B] = (t * 1e3 / B, B / t)
        print(f"predict bucket {B} (uint8, bf16, all outputs): {t * 1e3:.3f} ms/request, "
              f"{t * 1e3 / B:.3f} ms/frame, {B / t:.2f} frames/s")

    # 5. where the time goes inside predict
    for B in (1, 8):
        wall, busy, classes, prof_rows = profile_call(
            lambda: session.predict(u8[:B], cams[:B]))
        if busy == 0:
            print(f"profile bucket {B}: the profiler recorded no device time (not measured)")
            continue
        shares = ", ".join(f"{c} {ms:.4f} ms" for c, ms in sorted(classes.items(), key=lambda x: -x[1]))
        print(f"profile bucket {B}: wall {wall:.3f} ms under the profiler, device busy "
              f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; by class: {shares}")
        for key, ms, count in prof_rows[:8]:
            print(f"  {ms:9.4f} ms {count:4d}x {key[:110]}")
        check_batch_norm_kernels(prof_rows)

    # 6. the training slice (this and phase 7 run NCHW: never the upsampling kernel)
    up_before = kups.upsample2x_bilinear_kernel.launches
    per_step, nrm_grad_err, nt, step_ms = train_phase(torch, counters, smi, steps=8)

    # 7. the evaluation slice
    launches_eval, eval_s = eval_phase(torch, counters, smi)
    # 7e. the 7-view flush of 19 frames at 480x640: 114 pairs, past 2^31 costs
    launches_wide_flush = wide_flush_phase(torch, counters, smi)
    up_train_eval = kups.upsample2x_bilinear_kernel.launches - up_before
    assert up_train_eval == 0, up_train_eval

    # 8. serving under load and the command line
    launches_batcher, load = batcher_phase(torch, counters, smi, session, weights, u8, cams)
    launches_cli, cli_s = cli_phase(torch, counters, smi)

    # 9. training at scale: bf16, remat, the tiled kernels, data parallel
    launches_bf16, bf16_ms, bf16_idle = bf16_phase(torch, counters, smi)
    remat, launches_remat = remat_phase(torch, counters, smi)
    launches_tiled, tiled = tiled_phase(torch, counters, smi)
    launches_ddp, launches_ddp_cli = ddp_phase(torch, counters, smi)

    # 10. the tile axis through the conv stack, serving and evaluation on a
    # mesh: two processes on the one card, beside this one's cached blocks
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"before phase 10: this process {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved; the card "
          f"{free / 2**30:.3f} of {total / 2**30:.3f} GiB free")
    mesh = mesh_phase(torch, counters, smi)

    with tempfile.TemporaryDirectory(prefix="cnm_kept_") as kept:
        # 11. the offline tools, the native loader and imported checkpoints
        imported = os.path.join(kept, "from_npz")
        launches_offline, offline_s, decode = offline_phase(torch, counters, smi, keep=imported)

        # 12. the measurement surface: cli bench and the tools, at full width
        # (open-loop serving at fractions of phase 8a's closed-loop rate)
        launches_measure, measure_s, measure = measure_phase(
            torch, counters, smi, load["long"]["requests_per_s"], imported)

    # 13. the scale-out surface: the entry points, the sweep, the
    # collective census, the backward probe, the hard-synced step; k = 19
    launches_scale, scale_s, scale = scale_phase(torch, counters, smi)

    def more(name):
        """The kernel's launches on the paths after phase 3, and its total."""
        paths = {"launches_train_step": per_step[name], "launches_eval": launches_eval[name],
                 "launches_wide_flush": launches_wide_flush[name],
                 "launches_batcher": launches_batcher[name], "launches_cli": launches_cli[name],
                 "launches_bf16_step": launches_bf16[name],
                 "launches_remat_step": launches_remat[name],
                 "launches_tiled": launches_tiled[name], "launches_ddp_step": launches_ddp[name],
                 "launches_ddp_cli": launches_ddp_cli[name],
                 "launches_offline": launches_offline[name],
                 "launches_measure": launches_measure[name]}
        # phase 13: in this process, or each tool's one rank (its counters)
        scale = {tool: n[name] if name in n else {p: c[name] for p, c in n.items()}
                 for tool, n in launches_scale.items()}
        scale_total = sum(v if isinstance(v, int) else sum(v.values()) for v in scale.values())
        # phase 10: each rank's launches on each mesh path (its counters)
        on_mesh = {f"{cell} rank {r}": {p: n[name] for p, n in mesh[r][cell]["launches"].items()}
                   for cell in (f"{d}x{t}" for d, t in MESH_CELLS) for r in range(2)}
        mesh_total = sum(sum(v.values()) for v in on_mesh.values())
        return {**paths, "launches_mesh": on_mesh, "launches_scale": scale,
                "launches_total": launches[name] + sum(paths.values()) + mesh_total + scale_total,
                "tiled": {shape: t[name] for shape, t in tiled.items()}}

    (train_cv,) = measure["bench_cv train shape"]  # 4 pairs, f32: a train step's volume
    kernels = [
        {"name": "cost_volume", "route": "cuda",
         "source": "cnmnet_tpu_torch/kernels/csrc/cost_volume.cu",
         "replaces": "cnmnet_tpu/kernels/cost_volume_pallas.py:417",
         "launches": launches["cost_volume"], "max_abs_err": cv_err, "ms": cv_ms,
         "plain_ms": cv_plain_ms, "bound_ms": cv_bound, "bound_by": cv_by, "library_ms": None,
         **more("cost_volume"), "train_shape_ms": train_cv["ms"],
         "train_shape_plain_ms": train_cv["plain_ms"], "train_shape_bound_ms": train_cv["bound_ms"],
         "chunked": chunked},
        {"name": "depth_to_normal", "route": "cuda",
         "source": "cnmnet_tpu_torch/kernels/csrc/depth_to_normal.cu",
         "replaces": "cnmnet_tpu/kernels/normals_pallas.py:168",
         "launches": launches["depth_to_normal"], "max_abs_err": nrm_err, "ms": rows[1][0],
         "plain_ms": rows[1][1], "bound_ms": rows[1][2], "bound_by": rows[1][3],
         "library_ms": None, **more("depth_to_normal"), "train_shape_ms": nt["kernel"], "train_shape_plain_ms": nt["plain"],
         "train_shape_bound_ms": nt["bound"], "backward": "plain autograd",
         "grad_max_abs_err": nrm_grad_err, "batch_chunk_launches": normals_chunks,
         "k_generic": {f"k{k}_b2": row for k, row in wide_k.items()}},
        {"name": "upsample2x_bilinear", "route": "cuda",
         "source": "cnmnet_tpu_torch/kernels/csrc/upsample.cu",
         "replaces": None,  # the JAX package's upsamplings are XLA's
         "launches": up_launches["capture"] + up_launches["replayed"],
         "launches_serve": up_launches, "launches_train_eval": up_train_eval,
         **{k: upsample["3v_b1"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
         "served": upsample},
    ]
    print(f"build_s {build_s:.2f}; predict ms/frame b1 {rates[1][0]:.3f} b8 {rates[8][0]:.3f}; "
          f"frames/s b1 {rates[1][1]:.2f} b8 {rates[8][1]:.2f}; train step ms: TF32 off "
          f"{step_ms[0]:.3f}, PyTorch defaults {step_ms[1]:.3f}, TF32 off + cudnn.benchmark "
          f"{step_ms[2]:.3f}; eval 3-view ms/frame b1 {eval_s['steady']['3-view b1']:.3f} b4 "
          f"{eval_s['steady']['3-view b4']:.3f}; batcher {load['requests_per_s']:.2f} requests/s, "
          f"p50 {load['p50_ms']:.3f} ms, p99 {load['p99_ms']:.3f} ms, max {load['max_ms']:.3f} "
          f"ms, mean batch {load['mean_batch']:.3f}; over {load['long']['requests']} requests "
          f"{load['long']['requests_per_s']:.2f} requests/s, p99 {load['long']['p99_ms']:.3f} ms "
          f"({load['long']['p99_after_first_ms']:.3f} ms without the first round); "
          f"cli seconds { {n: round(v, 3) for n, v in cli_s.items()} }; bf16 train step "
          f"{bf16_ms:.3f} ms (idle {bf16_idle}); remat at 480x640 batch 4 (GiB, ms) "
          f"{ {n: (round(g, 3), round(t, 3)) for n, (g, t) in remat.items()} }; tile 2 at "
          f"480x640 batch 4, per rank (GiB, ms) "
          f"{[(round(r['1x2']['peak_gib'], 3), round(r['1x2']['bf16_ms'], 3)) for r in mesh]}; "
          f"offline seconds { {n: round(v, 3) for n, v in offline_s.items()} }; native "
          f"load_frames ms/frame "
          f"{decode['ms_per_frame'] if decode else 'not measured (no libjpeg/libpng headers)'}; "
          f"cli bench frames/s {[r[0]['value'] for n, r in measure.items() if n.startswith('bench ')]}; "
          f"roofline MFU% / HBM% "
          f"{ {r['phase']: (round(r['mfu_pct'], 3), round(r['hbm_pct'], 3)) for r in measure['roofline']} }; "
          f"open loop (offered, achieved req/s, p50, p99 ms) "
          f"{[(round(r['offered_rps'], 2), round(r['achieved_rps'], 2), round(r['p50_ms'], 3), round(r['p99_ms'], 3)) for r in measure['bench_serving']]}; "
          f"phase 12 seconds {sum(measure_s.values()):.2f}; sweep 1x1 step ms "
          f"{scale['scaling_sweep'][0]['step_ms']:.3f}; bwd_probe (GFLOP, ms/step) "
          f"{ {r['variant']: (round(r['gflop'], 3), round(r['ms_per_step'], 3)) for r in scale['bwd_probe']} }; "
          f"verify_step_time fwd+loss {scale['verify_step_time'][0]['fwd_loss_ms']:.3f} ms, step "
          f"median {scale['verify_step_time'][0]['step_median_ms']:.3f} ms; phase 13 seconds "
          f"{sum(scale_s.values()):.2f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:  # one rank of phase 10, started by mesh_phase
        sys.exit(mesh_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                             **json.loads(sys.argv[5])))
    sys.exit(main())
