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
ranks is the distributed step: each rank passes the samples of its data
index (the ranks of one data index, the tile axis, pass the same ones),
and the step computes what the one-process step computes on the global
batch (the JAX step is one program over it):

* under a tile axis above 1 each rank takes its rows of the image fields
  (``parallel/sharding.shard_rows``, by the ``RowPlan`` of the batch's
  height) and the model and the loss run on them
  (``sharding.spatial_parallel``): every windowed layer fetches the rows it
  reads, the cost volume reads the whole source, depth->normal its halo;
* the BatchNorm layers take their statistics over the whole mesh
  (``parallel/sharding.data_parallel``) and move their running statistics
  by them;
* every loss term is the global batch's (``train/losses.py``), so each
  rank holds the same loss and metrics;
* the gradients are averaged over the whole mesh by one all-reduce before
  the optimizer, so ``grad_clip_norm`` and ``grad_norm`` see the global
  gradient. Each rank's gradient is the mesh's size times its share
  (``parallel/collectives.py``: the backward of every sum over a group
  sums the gradients over it), so the mean is the whole gradient: the tile
  ranks' partial gradients of the same samples add up, and the data
  ranks' samples average. Under ``grad_accum`` that is one all-reduce per
  update, after the microbatches. Microbatch ``i`` is then every data
  rank's ``i``-th local microbatch: the one-process step on the global
  batch ordered so that its microbatches are those unions;
* the parameters and statistics are broadcast from the mesh's first rank
  at the first step, as ``DistributedDataParallel`` does;
* remat recomputes a block's forward, collectives included, in the same
  order on every rank, and still throws away its BatchNorm statistics.

A tile axis at a height that the JAX package's ``tile_partition_safe``
refuses warns, as the JAX step does; the port's exchange is exact at any
height its ``RowPlan`` accepts, and the plan raises for the rest.

``train_loop`` is the JAX epoch loop: checkpoints every
``train.ckpt_interval`` steps, at every epoch end and at ``max_steps``; a
watchdog that halts after three consecutive non-finite losses (it reads the
previous step's loss, which is ready by then); SIGTERM and ^C raised as
``KeyboardInterrupt`` once the running step has finished; a checkpoint
saved on every way out; ``train.steps_per_epoch``; resume from
``train.resume_dir``; scalars every ``train.print_interval`` steps and the
image summaries (``_log_images``, whose first sample's rows are gathered
over the tile axis: every rank takes a logger, or none does) every ten of
those. The trainer sets no
global precision flag (TF32 stays as the caller left it). Under a mesh of
several ranks every rank resumes from the same step of the one shared
checkpoint directory, and the first rank alone writes each checkpoint
while the others wait at a barrier.
"""

from __future__ import annotations

import signal
import time
import warnings
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from cnmnet_tpu_torch.config import Config
from cnmnet_tpu_torch.ops.images import prepare_images
from cnmnet_tpu_torch.parallel import collectives
from cnmnet_tpu_torch.parallel.mesh import Mesh
from cnmnet_tpu_torch.parallel.sharding import (
    Spatial,
    data_parallel,
    shard_rows,
    spatial_parallel,
    tile_partition_safe,
)
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
                   group=None, spatial: Optional[Spatial] = None):
    """One forward of ``model`` (in the mode it is in) on a batch of tensors:
    the gradient of the loss for every parameter, in ``model.parameters()``
    order (zeros where a parameter took no part), the loss terms, and the
    detached maps of the image summaries. ``group``: a mesh's group, whose
    ranks run the same call on their own samples or rows (BatchNorm
    statistics and loss terms over all of them; see the module docstring);
    ``spatial``: this rank's rows under a tile axis (``batch`` holds them)."""
    params = list(model.parameters())
    with data_parallel(model, group), spatial_parallel(model, spatial):
        out = model(prepare_images(batch["images"]), batch["cams"])
        loss, metrics = compute_losses(out, batch, epoch, w, group, spatial)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    viz = {"pred_idepth_01": out.disps[0][:, 0].detach()}
    if out.idepth_refined is not None:
        viz["pred_idepth_refined"] = out.idepth_refined.detach()
        viz["prob_map"] = out.prob_map.detach()
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    return grads, metrics, viz


def _all_reduce_mean(grads, group):
    """Average the gradients over ``group`` with one all-reduce of their
    concatenation."""
    flat = collectives.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    flat /= dist.get_world_size(group)
    return [x.view_as(g) for x, g in zip(flat.split([g.numel() for g in grads]), grads)]


@torch.no_grad()
def _broadcast_state(model, group):
    """Every parameter and buffer from the group's first rank."""
    src = dist.get_global_rank(group, 0)
    for t in list(model.parameters()) + list(model.buffers()):
        collectives.broadcast_(t, src, group)


def make_train_step(cfg: Config, mesh: Optional[Mesh] = None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``; see the module
    docstring. ``batch`` is a dict of numpy arrays or tensors, moved to the
    model's device; under a mesh, this rank's samples."""
    w = loss_weights_from_config(cfg)
    accum = max(1, int(cfg.train.grad_accum))
    opt = make_optimizer(cfg)
    group = None if mesh is None else mesh.mesh_group
    if mesh is not None and mesh.tile > 1:
        safe, reason = tile_partition_safe(cfg.dataset.image_height, mesh.tile)
        if not safe:
            warnings.warn("the JAX package's partitioner miscompiles this tile axis at this "
                          f"height ({reason}); the port's row exchange is exact at every height "
                          "its RowPlan accepts", stacklevel=2)
    synced = False

    def step(state: TrainState, batch: Dict):
        nonlocal synced
        params = state.params()
        device = next(iter(params.values())).device
        batch = batch_to_device(batch, device)
        spatial = Spatial.for_mesh(mesh, *batch["images"].shape[2:4])
        batch = shard_rows(spatial, batch)
        state.model.train()
        if group is not None and not synced:
            _broadcast_state(state.model, group)
            synced = True
        if accum == 1:
            grads, metrics, viz = loss_and_grads(state.model, batch, state.epoch, w, group,
                                                 spatial)
        else:
            for k, v in batch.items():
                if v.shape[0] % accum:
                    raise ValueError(f"train.grad_accum={accum} requires the batch divisible "
                                     f"by it; {k!r} has leading dim {v.shape[0]}")
            m = next(iter(batch.values())).shape[0] // accum
            grads = metrics = viz = None
            for i in range(accum):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                g, mm, vz = loss_and_grads(state.model, mb, state.epoch, w, group, spatial)
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


def _log_images(logger, step: int, batch, viz, spatial: Optional[Spatial] = None):
    """The periodic image and histogram summaries of the first sample
    (``cnmnet_tpu/train/loop.py:_log_images``). Only that sample's maps
    cross to the host, so the histograms summarise it, where the JAX
    package's summarise the batch; under a tile axis its rows are gathered
    first (every rank calls this). The copy runs outside the ``try``: a
    device failure raises; a failure of the logging itself is printed and
    training goes on."""
    from cnmnet_tpu_torch.data.pipeline import denormalize_images
    from cnmnet_tpu_torch.obs.colorize import colorize_idepth, colorize_prob, normal_to_color

    if spatial is not None:
        viz = {k: spatial.gather(v[:1].contiguous(), 0, dim=1) for k, v in viz.items()}
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
    anything with ``save``, ``wait`` and ``restore``). ``mesh``: the mesh
    of a multi-process run; ``data_iter_fn`` then yields the samples of this
    rank's data index, all their rows."""
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
                        spatial = Spatial.for_mesh(mesh, *batch["images"].shape[2:4])
                        _log_images(logger, global_step, batch, viz, spatial)
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
