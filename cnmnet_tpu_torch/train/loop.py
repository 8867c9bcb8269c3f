"""The training step and the epoch driver (``cnmnet_tpu/train/loop.py``).

``make_train_step(cfg)`` gives ``step(state, batch) -> (state, metrics)``:
a train-mode forward of ``CNMModel`` on ``prepare_images(batch["images"])``
(BatchNorm normalises with batch statistics and moves its running ones),
``compute_losses``, the gradients of the loss, and one optimizer update.
The state is updated in place and returned. ``metrics`` holds the loss
terms and ``grad_norm``, the global norm of the unclipped gradients, as
detached scalars on the device, and ``viz``: the detached maps of the image
summaries (``pred_idepth_01``, and ``pred_idepth_refined`` and ``prob_map``
when the refiner runs), from microbatch 0 under ``grad_accum``.

With ``train.grad_accum = A > 1`` the batch is split into A microbatches of
consecutive samples; each runs forward and backward in turn (the BatchNorm
statistics move once per microbatch, chained), the gradients and metrics
are averaged, and one update follows.

``make_train_step(cfg, mesh)`` with a ``parallel/mesh.Mesh`` of several
ranks is the data-parallel step: each rank passes its own samples, and the
step computes what the one-process step computes on the global batch (the
JAX step is one program over it):

* the BatchNorm layers take their statistics over the data group
  (``parallel/sharding.data_parallel``) and move their running statistics
  by them;
* every loss term is the global batch's (``train/losses.py``), so each
  rank holds the same loss and metrics;
* the gradients are averaged over the data group by one all-reduce before
  the optimizer (the all-reduces inside the loss make each rank's gradient
  ``world`` times its samples' share), so ``grad_clip_norm`` and
  ``grad_norm`` see the global gradient; under ``grad_accum`` that is one
  all-reduce per update, after the microbatches. Microbatch ``i`` is then
  every rank's ``i``-th local microbatch: the one-process step on the
  global batch ordered so that its microbatches are those unions;
* the parameters and statistics are broadcast from the first rank of the
  data group at the first step, as ``DistributedDataParallel`` does.

A tile axis above 1 raises ``NotImplementedError``: row-sharding the conv
stack waits for its ROADMAP item.

``train_loop`` is the JAX epoch loop: checkpoints every
``train.ckpt_interval`` steps, at every epoch end and at ``max_steps``; a
watchdog that halts after three consecutive non-finite losses (it reads the
previous step's loss, which is ready by then); SIGTERM and ^C raised as
``KeyboardInterrupt`` once the running step has finished; a checkpoint
saved on every way out; ``train.steps_per_epoch``; resume from
``train.resume_dir``; scalars every ``train.print_interval`` steps and the
image summaries (``_log_images``) every ten of those. The trainer sets no
global precision flag (TF32 stays as the caller left it). Under a mesh of
several ranks every rank resumes from the same step of the one shared
checkpoint directory, and the first rank alone writes each checkpoint
while the others wait at a barrier.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from cnmnet_tpu_torch.config import Config
from cnmnet_tpu_torch.ops.images import prepare_images
from cnmnet_tpu_torch.parallel.mesh import Mesh
from cnmnet_tpu_torch.parallel.sharding import data_parallel
from cnmnet_tpu_torch.train.losses import LossWeights, compute_losses
from cnmnet_tpu_torch.train.state import TrainState, create_train_state, global_norm, make_optimizer


def loss_weights_from_config(cfg: Config) -> LossWeights:
    return LossWeights(
        use_normal_loss=cfg.train.use_normal_loss,
        use_normal_refined_by_planes=cfg.train.use_normal_refined_by_planes,
        curriculum_epochs=cfg.train.curriculum_epochs,
        prob_weight=cfg.train.prob_weight,
        include_prob_map_loss=cfg.train.include_prob_map_loss,
        k_size=cfg.model.k_size,
        backend=cfg.model.cv_backend,
    )


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch fields -> tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v)
            .to(device) for k, v in batch.items()}


def loss_and_grads(model, batch: Dict[str, torch.Tensor], epoch: int, w: LossWeights,
                   group=None):
    """One forward of ``model`` (in the mode it is in) on a batch of tensors:
    the gradient of the loss for every parameter, in ``model.parameters()``
    order (zeros where a parameter took no part), the loss terms, and the
    detached maps of the image summaries. ``group``: a data group whose
    ranks run the same call on their own samples (BatchNorm statistics and
    loss terms over all of them; see the module docstring)."""
    params = list(model.parameters())
    with data_parallel(model, group):
        out = model(prepare_images(batch["images"]), batch["cams"])
        loss, metrics = compute_losses(out, batch, epoch, w, group)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    viz = {"pred_idepth_01": out.disps[0][:, 0].detach()}
    if out.idepth_refined is not None:
        viz["pred_idepth_refined"] = out.idepth_refined.detach()
        viz["prob_map"] = out.prob_map.detach()
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    return grads, metrics, viz


def _data_group(mesh: Optional[Mesh]):
    """The data group of ``mesh`` (None: one process, or one data shard)."""
    if mesh is None:
        return None
    if mesh.tile > 1:
        raise NotImplementedError(
            f"parallel.tile_axis={mesh.tile}: row-sharding the conv stack over a tile axis is "
            "not ported (ROADMAP, Queue 1: the tile axis through the conv stack)")
    return mesh.data_group


def _all_reduce_mean(grads, group):
    """Average the gradients over ``group`` with one all-reduce of their
    concatenation."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    return [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)]


@torch.no_grad()
def _broadcast_state(model, group):
    """Every parameter and buffer from the data group's first rank."""
    src = dist.get_global_rank(group, 0)
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t, src, group=group)


def make_train_step(cfg: Config, mesh: Optional[Mesh] = None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``; see the module
    docstring. ``batch`` is a dict of numpy arrays or tensors, moved to the
    model's device; under a mesh, this rank's samples."""
    w = loss_weights_from_config(cfg)
    accum = max(1, int(cfg.train.grad_accum))
    opt = make_optimizer(cfg)
    group = _data_group(mesh)
    synced = False

    def step(state: TrainState, batch: Dict):
        nonlocal synced
        params = state.params()
        device = next(iter(params.values())).device
        batch = batch_to_device(batch, device)
        state.model.train()
        if group is not None and not synced:
            _broadcast_state(state.model, group)
            synced = True
        if accum == 1:
            grads, metrics, viz = loss_and_grads(state.model, batch, state.epoch, w, group)
        else:
            for k, v in batch.items():
                if v.shape[0] % accum:
                    raise ValueError(f"train.grad_accum={accum} requires the batch divisible "
                                     f"by it; {k!r} has leading dim {v.shape[0]}")
            m = next(iter(batch.values())).shape[0] // accum
            grads = metrics = viz = None
            for i in range(accum):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                g, mm, vz = loss_and_grads(state.model, mb, state.epoch, w, group)
                grads = g if grads is None else [a + b for a, b in zip(grads, g)]
                metrics = mm if metrics is None else {k: metrics[k] + mm[k] for k in metrics}
                if i == 0:
                    viz = vz
            inv = 1.0 / accum
            grads = [g * inv for g in grads]
            metrics = {k: v * inv for k, v in metrics.items()}
        if group is not None:
            grads = _all_reduce_mean(grads, group)
        updates, state.opt_state = opt.update(dict(zip(params, grads)), state.opt_state, params)
        opt.apply(params, updates)
        state.step += 1
        metrics["grad_norm"] = global_norm(grads)
        metrics["viz"] = viz
        return state, metrics

    return step


def _log_images(logger, step: int, batch, viz):
    """The periodic image and histogram summaries of the first sample
    (``cnmnet_tpu/train/loop.py:_log_images``). Only that sample's maps
    cross to the host, so the histograms summarise it, where the JAX
    package's summarise the batch. The copy runs outside the ``try``: a
    device failure raises; a failure of the logging itself is printed and
    training goes on."""
    from cnmnet_tpu_torch.data.pipeline import denormalize_images
    from cnmnet_tpu_torch.obs.colorize import colorize_idepth, colorize_prob, normal_to_color

    host = {k: v[:1].float().cpu().numpy() for k, v in viz.items()}
    first = {k: np.asarray(batch[k][:1].cpu() if isinstance(batch[k], torch.Tensor)
                           else batch[k][:1]) for k in ("images", "disparity", "normals")}
    try:
        logger.log_image(step, "rgb", np.clip(denormalize_images(first["images"][0, 0]), 0, 1))
        logger.log_image(step, "gt_idepth", colorize_idepth(first["disparity"][0]))
        logger.log_image(step, "gt_normal", normal_to_color(first["normals"][0]))
        logger.log_image(step, "pred_idepth_01", colorize_idepth(host["pred_idepth_01"][0, ..., 0]))
        if "pred_idepth_refined" in host:
            logger.log_image(step, "pred_idepth_refined",
                             colorize_idepth(host["pred_idepth_refined"][0, ..., 0]))
            logger.log_image(step, "prob_map", colorize_prob(host["prob_map"][0, ..., 0]))
            logger.log_histogram(step, "prob_map", host["prob_map"])
        logger.log_histogram(step, "pred_idepth_01", host["pred_idepth_01"])
    except Exception as e:  # logging must never end a run
        print(f"image logging failed: {e!r}")


class _PrimaryWrites:
    """The checkpointer of a mesh of several ranks: the mesh's first rank
    writes each save, and every rank waits at a barrier after it, so no
    rank goes on before the step is whole on the shared directory."""

    def __init__(self, checkpointer, mesh: Mesh):
        self.checkpointer, self.mesh = checkpointer, mesh

    def save(self, state, step=None):
        if self.mesh.rank == 0:
            self.checkpointer.save(state, step=step)
            self.checkpointer.wait()
        dist.barrier(group=self.mesh.group)

    def wait(self):
        self.checkpointer.wait()


def train_loop(
    cfg: Config,
    data_iter_fn: Callable[[], Iterator[Dict]],
    logger=None,
    checkpointer=None,
    max_steps: Optional[int] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """Epoch driver: initialise (or resume), iterate, log, checkpoint; see
    the module docstring. ``logger`` is a ``MetricLogger`` (or anything with
    ``log_scalars``, ``log_image`` and ``log_histogram``); ``checkpointer`` a ``CheckpointManager`` (or
    anything with ``save``, ``wait`` and ``restore``). ``mesh``: the data
    mesh of a multi-process run; ``data_iter_fn`` then yields this rank's
    samples."""
    state = create_train_state(cfg, cfg.train.seed, device)
    start_epoch = 0
    if checkpointer is not None and cfg.train.resume_dir:
        restored = checkpointer.restore(cfg.train.resume_dir, state)
        if restored is not None:
            state = restored
            start_epoch = state.epoch

    step_fn = make_train_step(cfg, mesh)
    if checkpointer is not None and mesh is not None and mesh.size > 1:
        checkpointer = _PrimaryWrites(checkpointer, mesh)
    global_step = state.step
    nan_streak = 0
    prev_loss = None

    # SIGTERM (the usual preemption signal) and ^C end the run through the
    # KeyboardInterrupt path. The step updates the state in place, so the
    # signal only sets a flag and the interrupt is raised at the end of the
    # step: the checkpoint never holds a half-applied update. Registration
    # fails off the main thread; then only divergence and max_steps save.
    stop = []
    prev_handlers = {}

    def _on_signal(signum, frame):
        stop.append(signal.Signals(signum).name)

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:
            pass

    try:
        for epoch in range(start_epoch, cfg.train.num_epochs):
            state.epoch = epoch
            tic = time.monotonic()
            for it, batch in enumerate(data_iter_fn()):
                if cfg.train.steps_per_epoch and it >= cfg.train.steps_per_epoch:
                    break
                state, metrics = step_fn(state, batch)
                global_step += 1
                viz = metrics.pop("viz", None)
                if prev_loss is not None:
                    nan_streak = nan_streak + 1 if not np.isfinite(float(prev_loss)) else 0
                    if nan_streak >= 3:
                        raise FloatingPointError(
                            f"loss non-finite for {nan_streak} consecutive steps at step "
                            f"{global_step}")
                prev_loss = metrics["loss"]
                if max_steps and global_step >= max_steps:
                    if checkpointer is not None:  # idempotent after an interval save
                        checkpointer.save(state, step=global_step)
                        checkpointer.wait()
                    return state
                if (checkpointer is not None and cfg.train.ckpt_interval
                        and global_step % cfg.train.ckpt_interval == 0):
                    checkpointer.save(state, step=global_step)
                if logger is not None and it % cfg.train.print_interval == 0:
                    scalars = {k: float(v) for k, v in metrics.items()}
                    scalars["step_time"] = (time.monotonic() - tic) / (it + 1)
                    logger.log_scalars(global_step, scalars, prefix=f"epoch {epoch}")
                    if viz is not None and it % (cfg.train.print_interval * 10) == 0:
                        _log_images(logger, global_step, batch, viz)
                if stop:
                    raise KeyboardInterrupt(stop[0])
            if checkpointer is not None:
                checkpointer.save(state, step=global_step)
    except (KeyboardInterrupt, FloatingPointError):
        if checkpointer is not None:
            checkpointer.save(state, step=global_step)
            checkpointer.wait()
        raise
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
    return state
