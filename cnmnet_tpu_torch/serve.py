"""Batched inference serving (``cnmnet_tpu/serve.py``): checkpoint-backed
sessions and request micro-batching.

``InferenceSession.predict(images [B, V, H, W, 3] (uint8 or f32), cams
[B, V, 2, 4, 4])`` runs the refined forward on the session's device and
returns float32 numpy arrays: idepth ``[B, H, W]``, depth ``[B, H, W]``,
prob ``[B, H, W]`` (3+ views with the refiner only) and normal ``[B, H, W,
3]``, restricted to the session's ``outputs``:

* batches are padded up to the next bucket by repeating the last frame and
  cropped back; batches above the top bucket run in top-bucket chunks,
  every chunk dispatched under the session's lock and all of them fetched
  after it is released (inference is per sample: BatchNorm uses its running
  statistics);
* the selected outputs are packed into ONE ``[B, H, W, C]`` device tensor,
  cast with saturation to ``wire_dtype`` (raw depth can exceed float16's
  range), and cross to the host in one copy;
* on CUDA the model computes in bf16 unless ``compute_dtype`` says
  otherwise, with its norm layers' parameters and statistics kept in f32
  (``models/cnm.py:cast_for_compute``); the cost volume and depth->normal
  run as CUDA kernels.

Only a session on one CUDA device with no mesh (``one_card``, decided once
at build into ``InferenceSession.one_card``) takes the steps below: CUDA
graphs, the channels-last layout, pinned staging and the asynchronous wire.

On one card each bucket batch's nets (DepthNet, the group averages, the
RefineNet and the depth ``1 / (idepth + 1e-8)`` after them:
``models/cnm.py:CNMModel.nets``) run as a CUDA graph, captured on the
first dispatch of its key (``graph_key``: bucket, views, size, image
dtype, layout and cuDNN's TF32 flag; ``warmup`` captures its signature's
buckets) and replayed on every dispatch after: one call starts the few
hundred launches of the nets. The front (``CNMModel.front``: the folded
sources, the cameras and the cost volume kernel, written straight into
the graph's static volume), depth->normal and the wire stay eager, so
those two hand kernels launch and count (``launches``) on every dispatch.
The graphs share one memory pool: replays run one at a time on one stream. The CPU
and a mesh run the same nets eagerly. ``graph_captures`` and
``graph_replays`` count them. The nets' bilinear upsamplings launch the
hand kernel of ``kernels/upsample.py``, inside the graph; its host counter
moves at the capture only, so each graph keeps the launches its capture
recorded and ``upsample_replayed`` adds them at every replay
(``upsample_replayed / graph_replays`` is 11 at three or more views with
the refiner: five in DepthNet, three in each RefineNet branch).

On one card the nets run channels-last, eagerly and in their graphs
alike: the conv weights are converted once at build
(``model.to(memory_format=torch.channels_last)``; the ``state_dict``'s
keys and values are unchanged) and the front's reference and volume at the
head of every pass, so cuDNN's convolutions and the upsamplings run their
NHWC kernels with nothing transposed. Every other session (the CPU, a mesh)
runs NCHW, as the trainer and the eval driver do. ``graph_replays`` over
dispatches is the engaged share of both the graph and the layout.

``predict_async(images, cams) -> handle`` dispatches one batch no larger
than the top bucket and returns without waiting: on one card the inputs go
up from pinned host memory (``non_blocking``), the packed wire is copied into a
pinned host tensor that the handle owns, and a CUDA event is recorded after
the copy; ``fetch(handle)`` waits on that event and unpacks. On the CPU both
run synchronously.

Weights come from a port checkpoint (``checkpoint=``: a step, ``"latest"``,
a manager root or a step directory, restored through
``train/checkpoint.CheckpointManager(cfg.train.checkpoint_dir or ".")``,
weights only; nothing restored raises ``FileNotFoundError``), a torch
``state_dict`` of the port's ``CNMModel``, a flax variables tree of the JAX
package (``models/transplant.py``), or the seeded He-normal initialisation
of ``models/layers.init_weights``.

``MicroBatcher(session, max_batch, max_wait_ms)`` coalesces concurrent
single-frame ``submit``s into batches on one thread, double-buffered: it
dispatches batch N+1 before it fetches batch N.

With the span recorder on (``obs/spans``) the serving path records, by
layer boundary: ``serve.batcher.queue`` (each request, submit -> the batch
that takes it; the request's id), ``serve.batcher.collect``,
``serve.batcher.dispatch`` (the batch's request ids) holding one
``serve.session.dispatch`` a chunk (bucket, real frames) tiled by
``serve.session.stage`` (pad, pin, the uploads' enqueue),
``serve.session.forward`` (the forward's launches; ``graph``: whether the
nets were a graph's replay; ``layout``: ``"channels_last"`` or ``"nchw"``)
and
``serve.session.wire`` (the wire's copy and event), then
``serve.session.fetch`` (``serve.session.device_wait``,
``serve.session.unpack``) and ``serve.batcher.deliver``. Whether it is on
or off, a session counts ``frames_real`` (the requests' frames) and
``frames_run`` (the buckets' frames, padding included).

``InferenceSession(mesh=)`` serves on a ``parallel/mesh.Mesh`` of ranks,
one process a card, every rank building the session with the same
arguments: buckets round up to a multiple of the data axis, as in JAX.
The mesh's rank 0 answers ``predict``, ``predict_async`` and a
``MicroBatcher`` as a one-process session does; every other rank runs
``follow()``. For each bucket batch rank 0 broadcasts the frames, each rank
runs its frames (over "data") and its rows of them (over "tile",
``parallel/sharding.shard_frames``: its rows of every layer and the tiled
kernels), and the outputs are gathered to every rank (``gather_frames``);
``close()`` on rank 0 ends the followers' loops. A mesh batch is answered
whole before ``predict_async`` returns: its handle holds the host copy.
The JAX session's refusal of a tile axis at an unsafe height
(``sharding.tile_partition_safe``) is kept; the port's ``RowPlan`` refuses
what it cannot split.

Deliberate differences from the JAX package:

* empty ``outputs`` raises in ``__init__`` (the JAX session fails later,
  inside the compiled forward);
* an ``outputs`` selection that a request's signature filters to nothing
  (``("prob",)`` against two views) raises ``ValueError``;
* ``predict`` fetches its chunks after releasing the lock (the JAX session
  holds it across the chunked fetch, stalling the batcher's dispatches);
* ``MicroBatcher`` serves a coalesced batch larger than the top bucket in
  top-bucket chunks (the JAX batcher hands it to ``predict_async``, which
  refuses it, failing every waiter);
* ``MicroBatcher`` coalesces per ``(V, H, W, dtype)`` signature and
  dispatches each signature on its own (the JAX batcher stacks a mixed
  batch, which raises and fails every waiter);
* a future cancelled before its batch is collected is dropped, and one
  collected can no longer be cancelled, so delivering a result never raises
  (the JAX batcher's unguarded ``set_result`` on a cancelled future fails
  the batch's other waiters);
* a malformed request (rank, shape, dtype, fewer than two views) fails its
  own future at ``submit``; a failed dispatch or fetch fails only the
  futures of that chunk;
* checkpoints are the port's ``torch.save`` format, not orbax's.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from cnmnet_tpu_torch.config import Config
from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.kernels import upsample as upsample_kernel
from cnmnet_tpu_torch.models.cnm import CNMModel, cast_for_compute
from cnmnet_tpu_torch.models.layers import init_weights
from cnmnet_tpu_torch.models.transplant import load_flax_variables
from cnmnet_tpu_torch.obs import spans
from cnmnet_tpu_torch.ops.images import prepare_images
from cnmnet_tpu_torch.parallel import collectives
from cnmnet_tpu_torch.parallel.mesh import Mesh
from cnmnet_tpu_torch.parallel.sharding import (
    Spatial,
    gather_frames,
    shard_frames,
    spatial_parallel,
    tile_partition_safe,
)
from cnmnet_tpu_torch.parallel.tiled_ops import depth_to_normal_tiled

WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}
# What rank 0 of a mesh session broadcasts before each bucket batch: the
# operation, the images' shape [B, V, H, W, 3] and their dtype.
_RUN, _CLOSE = 1, 0
_IMAGE_DTYPES = (torch.uint8, torch.float32)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def restore_weights(model: CNMModel, checkpoint, directory: str) -> None:
    """Load the weights of a port checkpoint into ``model``: ``checkpoint``
    is a step of the ``train/checkpoint.CheckpointManager`` at
    ``directory``, ``"latest"``, another manager's root or a step
    directory. Nothing to restore raises ``FileNotFoundError``."""
    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.state import TrainState

    mgr = CheckpointManager(directory or ".", device="cpu")
    if mgr.restore(checkpoint, TrainState(model=model), with_optimizer=False) is None:
        raise FileNotFoundError(f"no checkpoint {checkpoint!r} under {mgr.directory}")


def _check_batch(images, cams):
    images = np.asarray(images)
    cams = np.asarray(cams, np.float32)
    if images.ndim != 5 or cams.ndim != 5 or not len(images):
        raise ValueError(f"want images [B, V, H, W, 3] and cams [B, V, 2, 4, 4] with B >= 1, "
                         f"got {images.shape} and {cams.shape}")
    return images, cams


def one_card(device: torch.device, mesh: Optional[Mesh]) -> bool:
    """Whether a session on ``device`` (over ``mesh``, None for one process)
    is on one CUDA device with no mesh: the session whose nets run as CUDA
    graphs and channels-last, from pinned staging to an asynchronous
    wire."""
    return mesh is None and device.type == "cuda"


def graph_key(images: torch.Tensor, layout, tf32: bool) -> tuple:
    """Which captured graph a bucket batch ``images`` ``[bucket, V, H, W, 3]``
    replays: its bucket, views, size and dtype, the wire's ``layout`` and
    cuDNN's TF32 flag (the math the capture chose its kernels under)."""
    B, V, H, W = images.shape[:4]
    return (B, V, H, W, str(images.dtype), tuple(layout), bool(tf32))


class _Graph(NamedTuple):
    """A captured ``_nets``: its static inputs and outputs, and the
    upsampling kernel's launches the capture recorded."""

    graph: "torch.cuda.CUDAGraph"
    ref: torch.Tensor
    volume: torch.Tensor
    outputs: tuple
    upsample_launches: int


class Handle(NamedTuple):
    """A dispatched batch: the packed wire (a pinned host tensor on CUDA),
    the event recorded after its copy (None on the CPU), the layout and the
    number of real frames."""

    wire: torch.Tensor
    done: Optional["torch.cuda.Event"]
    layout: list
    frames: int


class InferenceSession:
    OUTPUT_CHANNELS = {"idepth": 1, "depth": 1, "prob": 1, "normal": 3}

    def __init__(
        self,
        cfg: Optional[Config] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        flax_variables: Optional[Mapping] = None,
        checkpoint: Union[int, str, None] = None,
        seed: int = 0,
        batch_buckets: Sequence[int] = (1, 4, 8),
        k_size: Optional[int] = None,
        outputs: Sequence[str] = ("idepth", "depth", "prob", "normal"),
        wire_dtype: str = "float32",
        compute_dtype: Optional[str] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        if not outputs:
            raise ValueError("outputs must name at least one of "
                             f"{sorted(self.OUTPUT_CHANNELS)}")
        bad = set(outputs) - set(self.OUTPUT_CHANNELS)
        if bad:
            raise ValueError(f"unknown outputs {sorted(bad)}; "
                             f"choose from {sorted(self.OUTPUT_CHANNELS)}")
        if wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unsupported wire_dtype {wire_dtype!r}")
        if sum(w is not None for w in (state_dict, flax_variables, checkpoint)) > 1:
            raise ValueError("pass only one of checkpoint, state_dict and flax_variables "
                             "(not both)")
        self.device = resolve_device(device)
        self.outputs = tuple(outputs)
        self.wire_dtype = WIRE_DTYPES[wire_dtype]
        self.cfg = copy.deepcopy(cfg) if cfg is not None else Config()
        if compute_dtype is None:
            compute_dtype = self.cfg.model.compute_dtype
            if self.device.type == "cuda" and compute_dtype == "float32":
                compute_dtype = "bfloat16"  # serving default on the card
        self.compute_dtype = getattr(torch, compute_dtype)
        self.buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            d = self.mesh.data
            self.buckets = tuple(sorted({-(-b // d) * d for b in self.buckets}))
        self.k_size = k_size or self.cfg.model.k_size

        self._lock = threading.Lock()
        # frames of the requests dispatched, and of the buckets they ran in
        # (padding included); rank 0 counts on a mesh
        self.frames_real = 0
        self.frames_run = 0
        self.one_card = one_card(self.device, self.mesh)
        # the nets as CUDA graphs (one card), by graph_key
        self.graph_captures = 0
        self.graph_replays = 0
        self.upsample_replayed = 0
        self._graphs: Optional[Dict[tuple, _Graph]] = None
        if self.one_card:
            self._graphs, self._pool = {}, torch.cuda.graph_pool_handle()

        from cnmnet_tpu_torch.train.state import build_model

        model = build_model(self.cfg)
        if checkpoint is not None:
            restore_weights(model, checkpoint, self.cfg.train.checkpoint_dir)
        elif state_dict is not None:
            model.load_state_dict(state_dict)
        elif flax_variables is not None:
            load_flax_variables(model, flax_variables)
        else:
            init_weights(model, torch.Generator().manual_seed(seed))
        self.model = cast_for_compute(model, self.compute_dtype, self.device).eval()
        if self.one_card:
            self.model.to(memory_format=torch.channels_last)  # the 4-D tensors: conv weights

    def _layout(self, views: int):
        """``(name, channels)`` slices packed into the wire's last axis."""
        has_prob = views >= 3 and self.model.refine_net is not None
        layout = [(name, self.OUTPUT_CHANNELS[name]) for name in self.outputs
                  if name != "prob" or has_prob]
        if not layout:
            raise ValueError(f"outputs {self.outputs} select nothing for {views} views "
                             "(prob needs 3+ views and the refiner)")
        return layout

    def _nets(self, ref: torch.Tensor, volume: torch.Tensor, views: int):
        """``CNMModel.nets`` -> (idepth ``[B, H, W, 1]``, prob or None, depth
        ``[B, H, W]``); on one card the nets take their inputs channels-last
        (the reference is already: a view of the images)."""
        if self.one_card:
            ref, volume = (t.contiguous(memory_format=torch.channels_last) for t in (ref, volume))
        out = self.model.nets(ref, volume, views)
        if out.idepth_refined is not None:
            idepth, prob = out.idepth_refined, out.prob_map
        else:  # 2-view path: single-pair disp1, no occlusion head
            idepth, prob = out.disps[0][:, 0], None
        return idepth, prob, 1.0 / (idepth[..., 0] + 1e-8)

    def _capture(self, ref: torch.Tensor, volume: torch.Tensor, views: int) -> _Graph:
        """``_nets`` on static copies of its inputs, as a CUDA graph in the
        session's pool, after one eager pass on a side stream (cuDNN's
        choices settle before the capture)."""
        ref, volume = ref.clone(), volume.clone()
        side, main = torch.cuda.Stream(self.device), torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._nets(ref, volume, views)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        launched = upsample_kernel.upsample2x_bilinear_kernel.launches
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            outputs = self._nets(ref, volume, views)
        self.graph_captures += 1
        return _Graph(graph, ref, volume, outputs,
                      upsample_kernel.upsample2x_bilinear_kernel.launches - launched)

    def _replay(self, images: torch.Tensor, x: torch.Tensor, cams: torch.Tensor, layout):
        """The front eagerly, the volume written into the key's graph, whose
        replay runs the nets; the key's first batch captures it."""
        key = graph_key(images, layout, torch.backends.cudnn.allow_tf32)
        g = self._graphs.get(key)
        with torch.cuda.device(self.device):
            if g is None:
                g = self._graphs[key] = self._capture(*self.model.front(x, cams), images.shape[1])
            else:
                ref, _ = self.model.front(x, cams, volume_out=g.volume)
                g.ref.copy_(ref)
            g.graph.replay()
        self.graph_replays += 1
        self.upsample_replayed += g.upsample_launches
        return g.outputs

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor, cams: torch.Tensor, layout,
                 spatial: Optional[Spatial] = None) -> torch.Tensor:
        """One bucket batch on the device -> the packed ``[B, H, W, C]`` wire
        (of this rank's rows with ``spatial``)."""
        x = prepare_images(images)
        if self._graphs is not None:
            idepth, prob, depth = self._replay(images, x, cams, layout)
        else:
            with spatial_parallel(self.model, spatial):
                idepth, prob, depth = self._nets(*self.model.front(x, cams), images.shape[1])
        parts = {"idepth": idepth, "depth": depth[..., None], "prob": prob}
        if any(name == "normal" for name, _ in layout):
            K_inv = invert_intrinsics(cams[:, 0, 1, :3, :3])
            backend = self.cfg.model.cv_backend
            if spatial is not None:
                parts["normal"] = depth_to_normal_tiled(depth, K_inv, spatial, self.k_size, backend)
            else:
                parts["normal"], _ = dispatch.depth_to_normal(depth, K_inv, self.k_size,
                                                              backend=backend)
        packed = torch.cat([parts[name].float() for name, _ in layout], -1)
        if self.wire_dtype != packed.dtype:
            fin = torch.finfo(self.wire_dtype)
            packed = packed.clamp(fin.min, fin.max)
        return packed.to(self.wire_dtype)

    def _dispatch(self, images: np.ndarray, cams: np.ndarray) -> Handle:
        """One chunk no larger than the top bucket, under the lock: pad,
        upload, forward, and the wire's copy to the host, without waiting."""
        B, V = images.shape[:2]
        bucket = _next_bucket(B, self.buckets)
        with spans.span("serve.session.dispatch", bucket=bucket, frames=B):
            with spans.span("serve.session.stage"):
                if B < bucket:
                    images = np.concatenate([images] + [images[-1:]] * (bucket - B), 0)
                    cams = np.concatenate([cams] + [cams[-1:]] * (bucket - B), 0)
                layout = self._layout(V)
                img = torch.from_numpy(np.ascontiguousarray(images))
                cam = torch.from_numpy(np.ascontiguousarray(cams))
                if self.one_card:
                    img = img.pin_memory().to(self.device, non_blocking=True)
                    cam = cam.pin_memory().to(self.device, non_blocking=True)
            with spans.span("serve.session.forward", graph=self._graphs is not None,
                            layout="channels_last" if self.one_card else "nchw"):
                if self.mesh is not None:
                    packed = self._lead(img, cam).cpu()
                else:
                    packed = self._forward(img, cam, layout)
            if self.one_card:
                with spans.span("serve.session.wire"):
                    wire = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
                    wire.copy_(packed, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
            else:
                wire, done = packed, None
        self.frames_real += B
        self.frames_run += bucket
        return Handle(wire, done, layout, B)

    # -- serving on a mesh -------------------------------------------------

    def _mesh_step(self, img: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        """Every rank: its frames and rows of a bucket batch on the device,
        and the whole batch's wire gathered back."""
        spatial, img, cam = shard_frames(self.mesh, img, cam)
        packed = self._forward(img.contiguous(), cam, self._layout(img.shape[1]), spatial)
        return gather_frames(self.mesh, spatial, packed)

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        return collectives.broadcast_(t, self.mesh.ranks[0], self.mesh.mesh_group)

    def _header(self, op: int, img: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = list(img.shape) if img is not None else [0] * 5
        dtype = _IMAGE_DTYPES.index(img.dtype) if img is not None else 0
        return torch.tensor([op] + shape + [dtype], dtype=torch.int64, device=self.device)

    def _lead(self, img: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
        """Rank 0: check the batch, send it to the followers, run it."""
        if img.dtype not in _IMAGE_DTYPES:
            raise ValueError(f"images must be uint8 or float32, got {img.dtype}")
        H, W = img.shape[2], img.shape[3]
        if self.mesh.tile > 1:
            safe, reason = tile_partition_safe(H, self.mesh.tile)
            if not safe:
                raise ValueError(f"unsafe tile axis for serving: {reason}")
            Spatial(self.mesh, H, W)  # a height the row plan refuses raises here
        img, cam = img.to(self.device), cam.to(self.device)
        self._broadcast(self._header(_RUN, img))
        self._broadcast(img)
        self._broadcast(cam)
        return self._mesh_step(img, cam)

    def follow(self) -> int:
        """A follower rank's loop: run each bucket batch rank 0 sends until
        it closes; returns the number of batches served."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() is for the ranks of a mesh session other than rank 0")
        served = 0
        while True:
            header = self._broadcast(self._header(_CLOSE)).tolist()
            if header[0] == _CLOSE:
                return served
            shape = header[1:6]
            img = self._broadcast(torch.empty(shape, dtype=_IMAGE_DTYPES[header[6]],
                                              device=self.device))
            cam = self._broadcast(torch.empty(shape[:2] + [2, 4, 4], dtype=torch.float32,
                                              device=self.device))
            self._mesh_step(img, cam)
            served += 1

    def close(self) -> None:
        """Rank 0 of a mesh session: end the followers' loops (nothing to do
        without a mesh)."""
        if self.mesh is not None and self.mesh.rank == 0:
            with self._lock:
                self._broadcast(self._header(_CLOSE))

    def fetch(self, handle: Handle) -> Dict[str, np.ndarray]:
        """Wait for a dispatched batch and unpack its wire."""
        with spans.span("serve.session.fetch"):
            with spans.span("serve.session.device_wait"):
                if handle.done is not None:
                    handle.done.synchronize()
            with spans.span("serve.session.unpack"):
                arr = handle.wire
                arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
                out, c = {}, 0
                for name, nc in handle.layout:
                    a = arr[: handle.frames, ..., c : c + nc]
                    c += nc
                    out[name] = (a[..., 0] if nc == 1 else a).astype(np.float32)
        return out

    def _check_leader(self):
        if self.mesh is not None and self.mesh.rank != 0:
            raise RuntimeError(f"rank {self.mesh.rank} of a mesh session follows (follow()); "
                               "rank 0 answers requests")

    def predict_async(self, images: np.ndarray, cams: np.ndarray) -> Handle:
        """Dispatch one batch of at most the top bucket and return its
        handle at once; ``fetch(handle)`` gives ``predict``'s result."""
        self._check_leader()
        images, cams = _check_batch(images, cams)
        if images.shape[0] > self.buckets[-1]:
            raise ValueError(f"predict_async batch {images.shape[0]} exceeds the top bucket "
                             f"{self.buckets[-1]}; chunk via predict()")
        with self._lock:
            return self._dispatch(images, cams)

    def predict(self, images: np.ndarray, cams: np.ndarray) -> Dict[str, np.ndarray]:
        self._check_leader()
        images, cams = _check_batch(images, cams)
        top = self.buckets[-1]
        with self._lock:
            handles = [self._dispatch(images[i : i + top], cams[i : i + top])
                       for i in range(0, images.shape[0], top)]
        outs = [self.fetch(h) for h in handles]
        if len(outs) == 1:
            return outs[0]
        return {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}

    def warmup(self, views: int, height: int, width: int):
        """Run every bucket once for one signature (loads the kernels and, on
        one card, captures the buckets' graphs)."""
        for b in self.buckets:
            images = np.zeros((b, views, height, width, 3), np.uint8)
            cams = np.broadcast_to(np.eye(4, dtype=np.float32), (b, views, 2, 4, 4)).copy()
            cams[:, :, 1, :3, :3] = np.asarray(
                [[100.0, 0, width / 2], [0, 100.0, height / 2], [0, 0, 1]], np.float32
            )
            self.predict(images, cams)


class _Request(NamedTuple):
    images: np.ndarray  # [V, H, W, 3]
    cams: np.ndarray  # [V, 2, 4, 4] f32
    future: Future
    rid: int = 0  # with the span recorder on: the request's span id and
    submitted: int = 0  # its submit stamp (perf_counter_ns)

    @property
    def signature(self):
        return self.images.shape[:3] + (self.images.dtype.str,)


def _check_request(images, cams):
    images = np.asarray(images)
    cams = np.asarray(cams, np.float32)
    if (images.ndim != 4 or images.shape[0] < 2 or images.shape[-1] != 3
            or images.dtype not in (np.uint8, np.float32)
            or cams.shape != (images.shape[0], 2, 4, 4)):
        raise ValueError(f"want images [V >= 2, H, W, 3] uint8 or float32 and cams "
                         f"[V, 2, 4, 4], got {images.dtype} {images.shape} and {cams.shape}")
    return images, cams


class MicroBatcher:
    """Coalesce concurrent single-frame requests into batched forwards.

    ``submit(images [V, H, W, 3], cams [V, 2, 4, 4]) -> Future`` resolving
    to that request's slice of ``InferenceSession.predict``'s dict.

    One thread drains the queue. With no batch in flight it waits for a
    request, then up to ``max_wait_ms`` for the batch to fill to
    ``max_batch``; with one in flight it takes only what is queued. It
    splits the batch by signature and each signature into top-bucket
    chunks, dispatches each chunk (``predict_async``), and only then fetches
    the batch before it: the next batch's upload and forward overlap the
    previous one's copy to the host. ``dispatched`` counts the chunks handed
    to the session (one forward each) and ``served`` the requests they
    carried. See the module docstring for what differs from the JAX
    batcher.
    """

    def __init__(self, session: InferenceSession, max_batch: int = 8, max_wait_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be at least 1, got {max_batch}")
        self.session = session
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.dispatched = 0
        self.served = 0
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="MicroBatcher", daemon=True)
        self._thread.start()

    def submit(self, images: np.ndarray, cams: np.ndarray) -> Future:
        if self._closed:
            raise RuntimeError("submit on a closed MicroBatcher")
        fut: Future = Future()
        try:
            images, cams = _check_request(images, cams)
        except (ValueError, TypeError) as e:
            fut.set_exception(e)
            return fut
        if spans.enabled():
            self._q.put(_Request(images, cams, fut, spans.new_id(), time.perf_counter_ns()))
        else:
            self._q.put(_Request(images, cams, fut))
        return fut

    def close(self, timeout: float = 60.0) -> None:
        """Serve what was submitted, then stop the thread."""
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"MicroBatcher did not stop within {timeout} s")

    # -- internals --------------------------------------------------------

    def _collect(self, block: bool) -> List[_Request]:
        """One coalesced batch of live requests; [] when none is queued or
        the stop sentinel arrives. A request whose future was cancelled is
        dropped; the others are marked running, so they can no longer be."""
        batch: List[_Request] = []
        deadline = None
        with spans.span("serve.batcher.collect"):
            while len(batch) < self.max_batch:
                left = 0.0 if deadline is None else deadline - time.monotonic()
                try:
                    if not batch and block:
                        item = self._q.get()
                        deadline = time.monotonic() + self.max_wait
                    elif left > 0:
                        item = self._q.get(timeout=left)
                    else:
                        item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    self._stop.set()
                    break
                if item.future.set_running_or_notify_cancel():
                    batch.append(item)
        now = time.perf_counter_ns()
        for r in batch:
            if r.rid:
                spans.record("serve.batcher.queue", r.submitted, now, span_id=r.rid)
        return batch

    def _dispatch(self, batch: List[_Request]):
        """``predict_async`` per signature and top-bucket chunk -> ``[(chunk,
        handle)]``; a chunk whose dispatch raises fails its own futures."""
        if not batch:
            return []
        groups: Dict[tuple, List[_Request]] = {}
        for r in batch:
            groups.setdefault(r.signature, []).append(r)
        top = self.session.buckets[-1]
        out = []
        with spans.span("serve.batcher.dispatch", requests=[r.rid for r in batch]):
            for reqs in groups.values():
                for i in range(0, len(reqs), top):
                    chunk = reqs[i : i + top]
                    try:
                        handle = self.session.predict_async(
                            np.stack([r.images for r in chunk]), np.stack([r.cams for r in chunk]))
                    except Exception as e:  # this chunk's waiters get it; serving goes on
                        for r in chunk:
                            r.future.set_exception(e)
                        continue
                    self.dispatched += 1
                    self.served += len(chunk)
                    out.append((chunk, handle))
        return out

    def _resolve(self, chunk: List[_Request], handle: Handle) -> None:
        try:
            out = self.session.fetch(handle)
        except Exception as e:  # this chunk's waiters get it; serving goes on
            for r in chunk:
                r.future.set_exception(e)
            return
        with spans.span("serve.batcher.deliver", requests=[r.rid for r in chunk]):
            for i, r in enumerate(chunk):
                r.future.set_result({k: v[i] for k, v in out.items()})

    def _loop(self):
        pending = []
        while pending or not self._stop.is_set():
            dispatched = self._dispatch(self._collect(block=not pending))
            for chunk, handle in pending:
                self._resolve(chunk, handle)
            pending = dispatched
        while True:  # requests that raced close()
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and item.future.set_running_or_notify_cancel():
                item.future.set_exception(RuntimeError("the MicroBatcher was closed"))
