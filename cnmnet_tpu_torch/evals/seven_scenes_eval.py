"""7-Scenes cross-dataset evaluation harness.

Implements every protocol of the reference's `eval.py` as one parameterized
function (`num_sources` replaces the four near-duplicate sacred commands):

* 2-view  (`eval`,   `eval.py:162-319`): index % 10, source +10, no refiner;
* 3-view  (`eval_refine`, `:321-520`): index % 3, sources +/-10, refined;
* 5-view  (`eval_refine_five_views`, `:523-712`): index % 3, sources
  +10,-10,+5,-5 batched through one DepthNet call, pair-averaged into the
  refiner;
* 7-view  (`eval_refine_seven_views`, `:715-993`): index % 9, +/-10, +/-5,
  +/-20.

Offsets are ordered so the model's even/odd grouping reproduces the
reference's pair averaging. Metrics follow `cal_metrics`
(`eval.py:995-1090`): predictions resized to the native GT resolution,
clamped to [0.3, 8.0] m, GT masked to the same range, nine metrics averaged
per frame then over frames.

A copy of ``cnmnet_tpu/evals/seven_scenes_eval.py`` for the port: the
per-frame compute (cost volumes + DepthNet + RefineNet + depth->normal)
runs on the device through ``make_eval_forward``, with both CUDA kernels
on CUDA tensors; loading, metrics and artifacts are numpy on the host
(``data/imageio`` in place of cv2 and PIL).

On a ``parallel/mesh.Mesh`` of ranks (one process a card, every rank
running the same call) each flush's frames go over "data" and their rows
over "tile": ``make_eval_forward(mesh=)`` runs this rank's frames and rows
(``parallel/sharding.shard_frames``; the tiled layers and kernels) and
gathers the outputs to every rank, so every rank scores every frame and
returns the one-process metrics. ``evaluate_seven_scenes(mesh=)`` holds
the frame batch to a multiple of the data axis (the CLI rounds it up),
warns at a height where the JAX package's partitioner would miscompile,
as the JAX function does, and writes artifacts from rank 0 alone.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from cnmnet_tpu_torch.data.imageio import write_png
from cnmnet_tpu_torch.data.pipeline import denormalize_images
from cnmnet_tpu_torch.data.seven_scenes import SevenScenes
from cnmnet_tpu_torch.evals.cal_metrics import frame_metrics
from cnmnet_tpu_torch.obs.colorize import colorize_depth, colorize_prob, normal_to_color
from cnmnet_tpu_torch.obs.meters import synchronize

EVAL_PROTOCOLS = {
    # num_sources: source offsets in reference order plus the reference's
    # EXACT loop structure — `for index in range(start, len - end_margin):
    # if index % modulus != 0: continue` (`eval.py:239-240, 408-409,
    # 581-582, 817-818`): the frame census is part of metric parity.
    # Quirks preserved deliberately: the 5-view command reuses the 7-view's
    # end margin (len-20 although its max forward offset is 10), and the
    # 7-view's start of 10 < its max backward offset 20, so index 18 reads
    # filepaths[index-20] < 0 — Python wraps that to the sequence END, and
    # so do we (list indexing).
    1: dict(modulus=10, offsets=(10,), start=0, end_margin=10),
    2: dict(modulus=3, offsets=(10, -10), start=10, end_margin=10),
    4: dict(modulus=3, offsets=(10, -10, 5, -5), start=10, end_margin=20),
    6: dict(modulus=9, offsets=(10, -10, 5, -5, 20, -20), start=10, end_margin=20),
}


def protocol_frame_indices(num_sources: int, num_frames: int) -> List[int]:
    """Reference-frame indices a protocol visits in a sequence of
    ``num_frames`` frames — the exact census of the reference loops
    (`eval.py:239-240,408-409,581-582,817-818`)."""
    proto = EVAL_PROTOCOLS[num_sources]
    return [
        i
        for i in range(proto["start"], num_frames - proto["end_margin"])
        if i % proto["modulus"] == 0
    ]


def aggregate_metrics(per_frame: List[Dict[str, float]]) -> Dict[str, float]:
    """Mean of each metric over frames (reference averages per-frame values)."""
    if not per_frame:
        return {}
    keys = per_frame[0].keys()
    return {k: float(np.mean([f[k] for f in per_frame])) for k in keys}


def _save_frame_artifacts(save_dir, p, idepth, prob_map, normal):
    """Per-frame artifact dumps, layout + content parity with the
    reference (`eval.py:394-404,461-510`): five directories per sequence,
    each frame saved as raw npy plus a colorized png."""
    base = os.path.join(save_dir, p["scene"], p["seq"])
    dirs = {}
    for kind in ("rgb", "gt_depth", "pred_depth", "pred_normal", "prob_map"):
        dirs[kind] = os.path.join(base, kind)
        os.makedirs(dirs[kind], exist_ok=True)
    name = p["name"]

    def save_png(kind, suffix, img_uint8):
        write_png(os.path.join(dirs[kind], f"{name}.{suffix}.png"), img_uint8)

    def save_npy(kind, suffix, arr):
        np.save(os.path.join(dirs[kind], f"{name}.{suffix}.npy"), arr)

    rgb = denormalize_images(p["images"][0])
    save_png("rgb", "color", (np.clip(rgb, 0, 1) * 255).astype(np.uint8))

    save_npy("gt_depth", "gt_depth", p["gt_depth"])
    save_png("gt_depth", "gt_depth", colorize_depth(p["gt_depth"]))

    # the reference's artifact conversion (`eval.py:490-492`):
    # depth = 1/(idepth + 1e-4), > 100 m zeroed
    pred_depth = np.reciprocal(idepth + 1e-4)
    pred_depth = np.where(pred_depth > 100.0, 0.0, pred_depth)
    save_npy("pred_depth", "pred_depth", pred_depth)
    save_png("pred_depth", "pred_depth", colorize_depth(pred_depth))

    if normal is not None:
        save_npy("pred_normal", "pred_normal", normal)
        save_png("pred_normal", "pred_normal", normal_to_color(normal))
    if prob_map is not None:
        save_npy("prob_map", "prob_map", prob_map)
        save_png("prob_map", "prob_map", colorize_prob(prob_map))


def _fetch(outputs):
    """``(idepth, prob | None, normal | None)`` as float32 numpy, packed on
    the device along the channel axis and copied to the host at once."""
    parts = [torch.as_tensor(o) for o in outputs if o is not None]
    packed = torch.cat([p.float() for p in parts], -1).cpu().numpy()
    out, c = [], 0
    for o in outputs:
        if o is None:
            out.append(None)
            continue
        n = o.shape[-1]
        out.append(packed[..., c : c + n])
        c += n
    return out


def evaluate_seven_scenes(
    forward_fn,
    root_dir: str,
    num_sources: int = 2,
    image_height: int = 192,
    image_width: int = 256,
    save_dir: Optional[str] = None,
    max_frames_per_seq: Optional[int] = None,
    seqs: Optional[list] = None,
    logger=None,
    frame_batch: int = 1,
    mesh=None,
    wire_dtype: str = "float32",
) -> Dict[str, float]:
    """Run a protocol over the 18 test sequences.

    Args:
      forward_fn: ``(images [B, V, h, w, 3], cams [B, V, 2, 4, 4]) ->
        (idepth [B, h, w, 1], prob_map [B, h, w, 1] | None, normal [B, h,
        w, 3] | None)``, tensors on any device (build with
        ``make_eval_forward``); idepth is refined when V > 2, single-pair
        disp1 when V == 2. Each call gets numpy arrays of ``frame_batch``
        frames: a short last flush repeats its last frame.
      root_dir: 7-Scenes root.
      logger: anything with ``log_scalars(step, dict, prefix=)``; called
        after each sequence.
      mesh: the ``parallel/mesh.Mesh`` that ``forward_fn`` was built on
        (``make_eval_forward(mesh=)``); see the module docstring.

    Returns:
      dict of the nine aggregate metrics, ``seconds_per_frame`` (the mean
      time of the forward alone, up to a device synchronise) and ``frames``.
    """
    proto = EVAL_PROTOCOLS[num_sources]
    if mesh is not None:
        from cnmnet_tpu_torch.parallel.sharding import tile_partition_safe

        if frame_batch % mesh.data:
            raise ValueError(f"frame_batch {frame_batch} does not split over the mesh's "
                             f"{mesh.data} data ranks")
        safe, reason = tile_partition_safe(image_height, mesh.tile)
        if not safe:
            warnings.warn(f"tile-sharded eval at this height risks GSPMD's silent halo "
                          f"miscompile in the JAX package: {reason}", stacklevel=2)
        if mesh.rank != 0:
            save_dir = None
    ds = SevenScenes(root_dir, image_height, image_width, wire_dtype=wire_dtype)
    per_frame: List[Dict[str, float]] = []
    total_time, count = 0.0, 0

    # pending frames for batched inference
    pending: List[dict] = []

    def flush():
        """Run one batched forward over the pending frames (padding the tail
        so every flush has the same batch shape)."""
        nonlocal total_time, count
        if not pending:
            return
        n = len(pending)
        images = np.stack([p["images"] for p in pending])
        cams = np.stack([p["cams"] for p in pending])
        if n < frame_batch:  # pad to the fixed batch shape
            reps = frame_batch - n
            images = np.concatenate([images, np.repeat(images[-1:], reps, 0)])
            cams = np.concatenate([cams, np.repeat(cams[-1:], reps, 0)])
        t0 = time.monotonic()
        out = forward_fn(images, cams)
        synchronize(out)  # the forward returns before a CUDA device finishes
        total_time += time.monotonic() - t0
        count += n
        idepth, prob_map, normal = _fetch(out)
        for i, p in enumerate(pending):
            pred_depth = 1.0 / (idepth[i, :, :, 0] + 1e-8)
            per_frame.append(frame_metrics(pred_depth, p["gt_depth"]))
            if save_dir:
                _save_frame_artifacts(
                    save_dir, p, idepth[i, :, :, 0],
                    prob_map[i, :, :, 0] if prob_map is not None else None,
                    normal[i] if normal is not None else None,
                )
        pending.clear()

    for scene, seq in (seqs or ds.test_seqs_list):
        paths = ds.frame_paths(scene, seq)
        done = 0
        for index in protocol_frame_indices(num_sources, len(paths)):
            if max_frames_per_seq and done >= max_frames_per_seq:
                break
            try:
                ref_rgb, gt_depth, ref_cam = ds.load_frame(paths[index])
                views = [(ref_rgb, ref_cam)]
                for off in proto["offsets"]:
                    rgb, _, cam = ds.load_frame(
                        paths[index + off], with_depth=False
                    )
                    views.append((rgb, cam))
            except (ValueError, FileNotFoundError, OSError):
                continue  # invalid cameras are skipped (`eval.py:594-617`)

            pending.append(
                {
                    "images": np.stack([v[0] for v in views]),
                    "cams": np.stack([v[1] for v in views]),
                    "gt_depth": gt_depth,
                    "scene": scene,
                    "seq": seq,
                    "name": paths[index]["name"],
                }
            )
            done += 1
            if len(pending) >= frame_batch:
                flush()
        flush()
        if logger is not None and count:
            logger.log_scalars(
                count, aggregate_metrics(per_frame), prefix=f"{scene}/{seq}"
            )

    result = aggregate_metrics(per_frame)
    result["seconds_per_frame"] = total_time / max(count, 1)
    result["frames"] = float(count)
    return result


def make_eval_forward(model, k_size: int = 9, device="cuda", compute_dtype: str = "float32",
                      mesh=None):
    """Build the eval forward of a port ``CNMModel`` for any view count.

    Puts ``model`` in eval mode and casts it in place with
    ``cast_for_compute`` to ``compute_dtype`` on ``device`` (f32, the
    config's ``compute_dtype``, unless asked; serving's bf16 default does
    not apply). Returns ``fn(images, cams) -> (idepth [B, h, w, 1],
    prob_map | None, normal [B, h, w, 3])`` as tensors on the device,
    computed under ``torch.inference_mode``: idepth is the refined map
    when V > 2, the single-pair disp1 when V == 2; normals follow the
    reference's eval-time ``depth2normal(1/idepth, K^-1)``
    (`eval.py:449-455`) through ``dispatch.depth_to_normal`` with the
    model's ``cv_backend`` (the CUDA kernel for CUDA tensors by default).
    With ``mesh`` (several ranks), each call runs this rank's frames and
    rows and returns the whole batch's outputs on every rank.
    """
    from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
    from cnmnet_tpu_torch.kernels import dispatch
    from cnmnet_tpu_torch.models.cnm import cast_for_compute
    from cnmnet_tpu_torch.ops.images import prepare_images
    from cnmnet_tpu_torch.parallel.sharding import gather_frames, shard_frames, spatial_parallel
    from cnmnet_tpu_torch.parallel.tiled_ops import depth_to_normal_tiled
    from cnmnet_tpu_torch.serve import resolve_device

    dev = resolve_device(device)
    model = cast_for_compute(model, getattr(torch, compute_dtype), dev).eval()
    mesh = mesh if mesh is not None and mesh.size > 1 else None

    @torch.inference_mode()
    def fn(images, cams):
        images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        cams = torch.from_numpy(np.ascontiguousarray(cams, np.float32)).to(dev)
        spatial = None
        if mesh is not None:
            spatial, images, cams = shard_frames(mesh, images, cams)
        with spatial_parallel(model, spatial):
            out = model(prepare_images(images.contiguous()), cams)
        if out.idepth_refined is not None:
            idepth, prob = out.idepth_refined, out.prob_map
        else:
            idepth, prob = out.disps[0][:, 0], None
        depth = 1.0 / (idepth[..., 0] + 1e-8)
        K_inv = invert_intrinsics(cams[:, 0, 1, :3, :3])
        if spatial is not None:
            normal = depth_to_normal_tiled(depth, K_inv, spatial, k_size, model.cv_backend)
        else:
            normal, _ = dispatch.depth_to_normal(depth, K_inv, k_size, backend=model.cv_backend)
        if mesh is None:
            return idepth, prob, normal
        return tuple(None if o is None else gather_frames(mesh, spatial, o.contiguous())
                     for o in (idepth, prob, normal))

    return fn
