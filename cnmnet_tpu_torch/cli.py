"""Command-line entry of the port (``cnmnet_tpu/cli.py``): train, evaluate,
re-score, infer, benchmark and export.

    python -m cnmnet_tpu_torch.cli train --synthetic --max-steps 100 dataset.batch_size=2
    python -m cnmnet_tpu_torch.cli eval --views 3 --checkpoint latest dataset.root_dir=/data/7scenes
    python -m cnmnet_tpu_torch.cli infer --inputs 'frames/*.npz' --out-dir preds --checkpoint latest
    python -m cnmnet_tpu_torch.cli bench [--height 192 --width 256]

The subcommands, their arguments and their defaults are the JAX package's.
Dotted overrides set config fields (``dataset.batch_size=2``), typed by the
field's current value.

The commands that run the model (``train``, ``eval``, ``eval-scannet``,
``infer``, ``bench``) take one more argument, ``--device`` (default ``cuda``): the
device the model runs on, the port's way of asking for the CPU where the
JAX CLI reads ``JAX_PLATFORMS``. Without a card, ``cuda`` raises
(``serve.resolve_device``) instead of running on the CPU; pass ``--device
cpu`` for a CPU run. ``cal-metrics``, ``export-tb`` and the offline tools
(``prep-cameras``, ``prep-planes``, ``prep-list``, ``report``) compute on
the host and have no ``--device``:

    python -m cnmnet_tpu_torch.cli prep-cameras --scene-dir /data/scannet/scene0000_00
    python -m cnmnet_tpu_torch.cli prep-planes --scene-dir /data/scannet/scene0000_00
    python -m cnmnet_tpu_torch.cli prep-list --root-dir /data/scannet --out /data/scannet/train.txt
    python -m cnmnet_tpu_torch.cli report runs/eval_artifacts [--compare runs/other]

``train`` and ``eval`` run on several processes, one card each, when
``parallel.coordinator_address`` is set (``cnmnet_tpu/cli.py:139-187``):

    python -m cnmnet_tpu_torch.cli train parallel.coordinator_address=host:port \
        parallel.num_processes=N parallel.process_id=i parallel.tile_axis=T ...

Each process calls ``torch.distributed.init_process_group`` on
``tcp://host:port`` (NCCL on cards, gloo on the CPU; one already
initialised is used as it is) and takes ``cuda:{LOCAL_RANK}``, or ``cuda:{rank
% device count}``. ``train`` lays the ranks out as a ``data x tile`` mesh
(``parallel.data_axis`` and ``parallel.tile_axis``): the loader shards
samples over the data axis (``PrefetchLoader(shard_index=data index,
shard_count=data)``; ``--synthetic`` gives every process the same scenes,
as in JAX), and the ranks of one data index split each sample's rows. All
processes share one checkpoint directory, checked at start: the first
writes, the others wait at a barrier, and every process resumes from the
same step. A tile axis above 1 needs that many processes.

``eval`` over N processes follows the JAX CLI's multi-device eval: with
``--frame-batch`` above 1 or ``--eval-tile`` above 1 the ranks form a
``data x tile`` mesh (tile ``--eval-tile``, or 1 where it does not divide N
or ``sharding.tile_partition_safe`` refuses the height, each said in a
printed line), the frame batch rounds up to a multiple of the data axis,
and every process prints the metrics of the whole run. On one process the
eval runs unsharded.

``bench`` runs ``cnmnet_tpu_torch/bench.py`` (the JAX CLI runs the
repository's ``bench.py``) and takes its ``--height`` and ``--width``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from cnmnet_tpu_torch.config import Config, apply_overrides, load_config, to_dict


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cnmnet_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def add(name, **kw):
        """A subcommand that runs the model, and so takes ``--device``."""
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--device", default="cuda",
                        help="device of the model: cuda (default) or cpu")
        return sp

    t = add("train", help="train the CNM pipeline")
    t.add_argument("--config", default=None)
    t.add_argument("--synthetic", action="store_true", help="procedural data")
    t.add_argument("--wo-normal", action="store_true", help="train_wo_normal recipe")
    t.add_argument("--max-steps", type=int, default=None)
    t.add_argument("overrides", nargs="*")

    e = add("eval", help="7-Scenes evaluation")
    e.add_argument("--config", default=None)
    e.add_argument("--views", type=int, default=3, choices=[2, 3, 5, 7])
    e.add_argument("--checkpoint", default=None)
    e.add_argument("--save-dir", default=None)
    e.add_argument("--max-frames-per-seq", type=int, default=None)
    e.add_argument("--frame-batch", type=int, default=1,
                   help="frames per batched forward")
    e.add_argument("--eval-tile", type=int, default=1,
                   help="row tiles per frame over several processes (one process runs "
                        "unsharded)")
    e.add_argument("overrides", nargs="*")

    cm = sub.add_parser("cal-metrics",
             help="re-aggregate metrics over a saved eval artifact dir")
    cm.add_argument("data_dir", help="artifact root: <scene>/<seq>/{pred,gt}_depth")
    cm.add_argument("--gt-root", default=None,
                    help="7-Scenes dataset root; GT read from its depth.png "
                         "instead of the saved gt_depth npy")
    cm.add_argument("--min-depth", type=float, default=0.3)
    cm.add_argument("--max-depth", type=float, default=8.0)

    es = add("eval-scannet", help="ScanNet test-set evaluation")
    es.add_argument("--config", default=None)
    es.add_argument("--checkpoint", default=None)
    es.add_argument("--synthetic", action="store_true", help="procedural data")
    es.add_argument("--planes", action="store_true",
                    help="also run the per-plane PlaneNet metric suite")
    es.add_argument("--max-samples", type=int, default=None)
    es.add_argument("overrides", nargs="*")

    b = add("bench", help="single-card throughput benchmark")
    b.add_argument("--height", type=int, default=192)
    b.add_argument("--width", type=int, default=256)

    inf = add("infer", help="offline batched inference over .npz frames (serve.InferenceSession)")
    inf.add_argument("--config", default=None)
    inf.add_argument("--checkpoint", default=None)
    inf.add_argument("--inputs", required=True,
                     help="glob of .npz files with arrays images [V,H,W,3] "
                          "(uint8 or normalized f32) and cams [V,2,4,4]")
    inf.add_argument("--out-dir", required=True)
    inf.add_argument("--batch", type=int, default=8)
    inf.add_argument("overrides", nargs="*")

    pc = sub.add_parser("prep-cameras", help="ScanNet pose+K -> cameras/*_cam.txt")
    pc.add_argument("--scene-dir", required=True)
    pc.add_argument("--out-width", type=int, default=256)
    pc.add_argument("--out-height", type=int, default=192)

    pp = sub.add_parser("prep-planes", help="PlaneRCNN annotations -> per-frame plane segs/params")
    pp.add_argument("--scene-dir", required=True)
    pp.add_argument("--num-workers", type=int, default=4)
    pp.add_argument("--limit", type=int, default=None)

    rp = sub.add_parser("report", help="HTML galleries over an eval artifact dir")
    rp.add_argument("run_dir")
    rp.add_argument("--compare", nargs="*", default=None,
                    help="additional run dirs for a side-by-side page")
    rp.add_argument("--image-width", type=int, default=256)

    tb = sub.add_parser("export-tb", help="convert a run dir's events.jsonl to TensorBoard format")
    tb.add_argument("run_dir")
    tb.add_argument("--out", default=None)

    pl_ = sub.add_parser("prep-list", help="generate a train list")
    pl_.add_argument("--root-dir", required=True)
    pl_.add_argument("--out", required=True)
    pl_.add_argument("--interval", type=int, default=10)
    pl_.add_argument("--view-num", type=int, default=3)
    pl_.add_argument("--frame-stride", type=int, default=5)
    return p


def _build_config(args) -> Config:
    cfg = load_config(getattr(args, "config", None))
    overrides = list(getattr(args, "overrides", []))
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def _restored_model(cfg: Config, checkpoint):
    """A ``CNMModel`` with seed-0 weights, then ``checkpoint``'s (a step
    directory, a manager root or ``"latest"`` under
    ``train.checkpoint_dir``) when one is given."""
    import torch

    from cnmnet_tpu_torch.models.layers import init_weights
    from cnmnet_tpu_torch.serve import restore_weights
    from cnmnet_tpu_torch.train.state import build_model

    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    if checkpoint:
        restore_weights(model, checkpoint, cfg.train.checkpoint_dir)
    return model


def _print_metrics(result) -> None:
    for k, v in result.items():
        print(f"{k}: {v:.4f}")


def cmd_train(args) -> int:
    cfg = _build_config(args)
    if args.wo_normal:
        cfg.train.use_normal_loss = False
    if args.synthetic:
        cfg.dataset.synthetic = True

    from cnmnet_tpu_torch.serve import resolve_device

    device = resolve_device(args.device)
    p = cfg.parallel
    if not p.coordinator_address:
        if p.tile_axis > 1:
            raise ValueError(f"parallel.tile_axis={p.tile_axis} splits rows over that many "
                             "processes: set parallel.coordinator_address")
        return _train(cfg, args, device, None)
    device, joined = _join_processes(cfg, device)
    try:
        import torch.distributed as dist

        from cnmnet_tpu_torch.parallel.mesh import make_mesh

        paths = [None] * dist.get_world_size()
        dist.all_gather_object(paths, os.path.abspath(cfg.train.checkpoint_dir))
        if len(set(paths)) != 1:
            raise ValueError("train.checkpoint_dir must be one shared path across processes: "
                             "the first process writes every checkpoint and all resume from it")
        return _train(cfg, args, device, make_mesh(data=p.data_axis, tile=p.tile_axis))
    finally:
        _leave(joined)


def _leave(joined: bool) -> None:
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()


def _join_processes(cfg: Config, device):
    """Initialise the process group of ``cfg.parallel`` (unless one is) and
    pick this process's card; returns ``(device, whether this call
    initialised the group)``."""
    import torch
    import torch.distributed as dist

    p = cfg.parallel
    joined = not dist.is_initialized()
    rank = p.process_id if joined else dist.get_rank()
    if device.type == "cuda" and device.index is None:
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None
                              else rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if joined:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://{p.coordinator_address}",
                                world_size=p.num_processes, rank=p.process_id)
    if dist.get_world_size() != p.num_processes or rank != p.process_id:
        raise ValueError(f"process group of {dist.get_world_size()} with rank {dist.get_rank()} "
                         f"!= parallel.num_processes={p.num_processes}, "
                         f"process_id={p.process_id}")
    return device, joined


def _train(cfg: Config, args, device, mesh) -> int:
    from cnmnet_tpu_torch.obs.logger import MetricLogger
    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.loop import train_loop

    logger = MetricLogger(cfg.train.log_dir, config=to_dict(cfg))
    checkpointer = CheckpointManager(cfg.train.checkpoint_dir, max_to_keep=cfg.train.ckpt_keep,
                                     device=device)
    if cfg.dataset.synthetic:
        from cnmnet_tpu_torch.data.synthetic import train_data_fn

        data_iter = train_data_fn(cfg)
        epoch_len = cfg.dataset.synthetic_size // cfg.dataset.batch_size
    else:
        from cnmnet_tpu_torch.data.pipeline import PrefetchLoader
        from cnmnet_tpu_torch.data.scannet import ScanNetDataset

        ds = ScanNetDataset(
            list_filepath=cfg.dataset.list_filepath,
            root_dir=cfg.dataset.root_dir,
            view_num=cfg.dataset.view_num,
            interval=cfg.dataset.interval,
            depth_scale=cfg.dataset.depth_scale,
            image_height=cfg.dataset.image_height,
            image_width=cfg.dataset.image_width,
            max_planes=cfg.dataset.max_planes,
            wire_dtype=cfg.dataset.wire_dtype,
        )
        shard = (mesh.data_index, mesh.data) if mesh is not None else (0, 1)
        loader = PrefetchLoader(ds, batch_size=cfg.dataset.batch_size,
                                num_workers=cfg.dataset.num_workers, seed=cfg.train.seed,
                                shard_index=shard[0], shard_count=shard[1])

        def data_iter():
            return iter(loader)

        epoch_len = len(loader)

    if cfg.train.ckpt_interval is None:
        # the reference's 8x/epoch cadence (`train.py:402-410`)
        if cfg.train.steps_per_epoch:
            epoch_len = min(epoch_len, cfg.train.steps_per_epoch)
        cfg.train.ckpt_interval = max(1, epoch_len // 8)

    try:
        state = train_loop(cfg, data_iter, logger=logger, checkpointer=checkpointer,
                           max_steps=args.max_steps, device=device, mesh=mesh)
    finally:
        logger.close()
    print(f"done: step {state.step}")
    return 0


def cmd_eval(args) -> int:
    cfg = _build_config(args)
    from cnmnet_tpu_torch.evals.seven_scenes_eval import evaluate_seven_scenes, make_eval_forward
    from cnmnet_tpu_torch.serve import resolve_device

    device = resolve_device(args.device)
    num_sources = {2: 1, 3: 2, 5: 4, 7: 6}[args.views]
    joined = False
    if cfg.parallel.coordinator_address:
        device, joined = _join_processes(cfg, device)
    try:
        mesh, frame_batch = _eval_mesh(cfg, args)
        model = _restored_model(cfg, args.checkpoint)
        forward = make_eval_forward(model, k_size=cfg.model.k_size, device=device,
                                    compute_dtype=cfg.model.compute_dtype, mesh=mesh)
        result = evaluate_seven_scenes(
            forward,
            cfg.dataset.root_dir,
            num_sources=num_sources,
            image_height=cfg.dataset.image_height,
            image_width=cfg.dataset.image_width,
            save_dir=args.save_dir,
            max_frames_per_seq=args.max_frames_per_seq,
            frame_batch=frame_batch,
            mesh=mesh,
            wire_dtype=cfg.dataset.wire_dtype,
        )
    finally:
        _leave(joined)
    _print_metrics(result)
    return 0


def _eval_mesh(cfg: Config, args):
    """``(mesh or None, frame batch)`` of a multi-process eval, with the JAX
    CLI's rules and messages (``cnmnet_tpu/cli.py:292-324``)."""
    import torch.distributed as dist

    frame_batch, tile = args.frame_batch, max(1, args.eval_tile)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if not ((frame_batch > 1 or tile > 1) and n > 1):
        return None, frame_batch
    from cnmnet_tpu_torch.parallel.mesh import make_mesh
    from cnmnet_tpu_torch.parallel.sharding import tile_partition_safe

    if n % tile:
        print(f"eval-tile={tile} does not divide {n} devices; running unsharded")
        tile = 1
    if tile > 1:
        safe, reason = tile_partition_safe(cfg.dataset.image_height, tile)
        if not safe:
            print(f"eval-tile={tile} DISABLED (falling back to pure data-parallel): {reason}")
            tile = 1
    data = n // tile
    if data > 1 and frame_batch % data:
        frame_batch = ((frame_batch + data - 1) // data) * data
        print(f"frame-batch rounded up {args.frame_batch} -> {frame_batch} so all {data} "
              "data-axis devices are used")
    print(f"eval mesh: data={data} tile={tile}")
    return make_mesh(data=data, tile=tile), frame_batch


def cmd_cal_metrics(args) -> int:
    from cnmnet_tpu_torch.evals.cal_metrics import cal_metrics

    result = cal_metrics(args.data_dir, gt_root=args.gt_root, min_depth=args.min_depth,
                         max_depth=args.max_depth)
    _print_metrics(result)
    print(f"wrote {args.data_dir}/evaluation_errors.txt")
    return 0


def cmd_eval_scannet(args) -> int:
    cfg = _build_config(args)
    from cnmnet_tpu_torch.evals.scannet_eval import evaluate_scannet, evaluate_scannet_planes
    from cnmnet_tpu_torch.evals.seven_scenes_eval import make_eval_forward
    from cnmnet_tpu_torch.serve import resolve_device

    device = resolve_device(args.device)
    if args.synthetic:
        from cnmnet_tpu_torch.data.pipeline import normalize_images
        from cnmnet_tpu_torch.data.synthetic import SyntheticScenes

        ds = SyntheticScenes(
            num_samples=cfg.dataset.synthetic_size,
            height=cfg.dataset.image_height,
            width=cfg.dataset.image_width,
            view_num=cfg.dataset.view_num,
            seed=cfg.train.seed,
        )

        class _Normalized:
            def __len__(self):
                return len(ds)

            def __getitem__(self, i):
                s = dict(ds[i])
                s["images"] = normalize_images(s["images"])
                return s

        dataset = _Normalized()
    else:
        from cnmnet_tpu_torch.data.scannet import ScanNetDataset

        dataset = ScanNetDataset(
            list_filepath=cfg.dataset.test_list_filepath or cfg.dataset.list_filepath,
            root_dir=cfg.dataset.root_dir,
            view_num=cfg.dataset.view_num,
            interval=cfg.dataset.interval,
            depth_scale=cfg.dataset.depth_scale,
            image_height=cfg.dataset.image_height,
            image_width=cfg.dataset.image_width,
            max_planes=cfg.dataset.max_planes,
            wire_dtype=cfg.dataset.wire_dtype,
        )

    model = _restored_model(cfg, args.checkpoint)
    forward = make_eval_forward(model, k_size=cfg.model.k_size, device=device,
                                compute_dtype=cfg.model.compute_dtype)
    _print_metrics(evaluate_scannet(forward, dataset, max_samples=args.max_samples))
    if args.planes:
        _print_metrics(evaluate_scannet_planes(forward, dataset, max_samples=args.max_samples))
    return 0


def cmd_bench(args) -> int:
    from cnmnet_tpu_torch import bench

    bench.main(height=args.height, width=args.width, device=args.device)
    return 0


def cmd_infer(args) -> int:
    """Offline batched inference: .npz frames -> ``<stem>.pred.npz`` with the
    session's output keys."""
    import numpy as np

    from cnmnet_tpu_torch.serve import InferenceSession

    cfg = _build_config(args)
    paths = sorted(glob.glob(args.inputs))
    if not paths:
        print(f"no inputs match {args.inputs!r}")
        return 1
    session = InferenceSession(cfg, checkpoint=args.checkpoint,
                               batch_buckets=(1, args.batch), device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    pending, names = [], []

    def flush():
        if not pending:
            return
        out = session.predict(np.stack([p[0] for p in pending]), np.stack([p[1] for p in pending]))
        for i, name in enumerate(names):
            np.savez(os.path.join(args.out_dir, name + ".pred.npz"),
                     **{k: v[i] for k, v in out.items()})
        pending.clear()
        names.clear()

    for path in paths:
        with np.load(path) as z:
            pending.append((np.asarray(z["images"]), np.asarray(z["cams"])))
        names.append(os.path.splitext(os.path.basename(path))[0])
        if len(pending) >= args.batch:
            flush()
    flush()
    print(f"wrote {len(paths)} predictions to {args.out_dir}")
    return 0


def cmd_prep_cameras(args) -> int:
    from cnmnet_tpu_torch.data.prep import make_camera_files

    n = make_camera_files(args.scene_dir, args.out_width, args.out_height)
    print(f"wrote {n} camera files")
    return 0


def cmd_prep_planes(args) -> int:
    from cnmnet_tpu_torch.data.prep_planes import prepare_scene

    n = prepare_scene(args.scene_dir, num_workers=args.num_workers, limit=args.limit)
    print(f"wrote {n} frames")
    return 0


def cmd_prep_list(args) -> int:
    from cnmnet_tpu_torch.data.prep import make_train_list

    n = make_train_list(args.root_dir, args.out, interval=args.interval,
                        view_num=args.view_num, frame_stride=args.frame_stride)
    print(f"wrote {n} samples to {args.out}")
    return 0


def cmd_report(args) -> int:
    from cnmnet_tpu_torch.evals.html_report import write_comparison, write_report

    if args.compare:
        out = os.path.join(args.run_dir, "comparison.html")
        write_comparison(out, [args.run_dir] + list(args.compare), image_width=args.image_width)
        print(f"wrote {out}")
    else:
        pages = write_report(args.run_dir, image_width=args.image_width)
        print(f"wrote {len(pages)} sequence pages + index under {args.run_dir}")
    return 0


def cmd_export_tb(args) -> int:
    from cnmnet_tpu_torch.obs.tb_export import convert_run

    convert_run(args.run_dir, args.out)
    return 0


COMMANDS = {
    "train": cmd_train,
    "eval": cmd_eval,
    "cal-metrics": cmd_cal_metrics,
    "eval-scannet": cmd_eval_scannet,
    "bench": cmd_bench,
    "infer": cmd_infer,
    "prep-cameras": cmd_prep_cameras,
    "prep-planes": cmd_prep_planes,
    "prep-list": cmd_prep_list,
    "export-tb": cmd_export_tb,
    "report": cmd_report,
}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv if argv is not None else sys.argv[1:])
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    raise SystemExit(main())
