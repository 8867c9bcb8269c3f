"""Batched inference serving (``cnmnet_tpu/serve.py:InferenceSession``).

``InferenceSession.predict(images [B, V, H, W, 3] (uint8 or f32), cams
[B, V, 2, 4, 4])`` runs the refined forward on the session's device and
returns float32 numpy arrays: idepth ``[B, H, W]``, depth ``[B, H, W]``,
prob ``[B, H, W]`` (3+ views with the refiner only) and normal ``[B, H, W,
3]``, restricted to the session's ``outputs``:

* batches are padded up to the next bucket by repeating the last frame and
  cropped back; batches above the top bucket run in top-bucket chunks
  (inference is per sample: BatchNorm uses its running statistics);
* the selected outputs are packed into ONE ``[B, H, W, C]`` device tensor,
  cast with saturation to ``wire_dtype`` (raw depth can exceed float16's
  range), and cross to the host in one ``.cpu()`` transfer;
* on CUDA the model computes in bf16 unless ``compute_dtype`` says
  otherwise; the cost volume and depth->normal run as CUDA kernels.

Weights come from a torch ``state_dict`` of the port's ``CNMModel``, from a
flax variables tree of the JAX package (``models/transplant.py``), or from
the seeded He-normal initialisation of ``models/layers.init_weights``.

Deliberate differences from the JAX session:

* empty ``outputs`` raises in ``__init__`` (the JAX session fails later,
  inside the compiled forward);
* an ``outputs`` selection that a request's signature filters to nothing
  (``("prob",)`` against two views) raises ``ValueError``;
* ``MicroBatcher``, ``predict_async``, mesh serving and orbax restore are
  not ported yet.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from cnmnet_tpu_torch.config import Config
from cnmnet_tpu_torch.geometry.camera import invert_intrinsics
from cnmnet_tpu_torch.kernels import dispatch
from cnmnet_tpu_torch.models.cnm import CNMModel
from cnmnet_tpu_torch.models.layers import init_weights
from cnmnet_tpu_torch.models.transplant import load_flax_variables
from cnmnet_tpu_torch.ops.images import prepare_images

WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


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


def build_model(cfg: Config) -> CNMModel:
    m = cfg.model
    return CNMModel(
        idepth_scale=m.idepth_scale, num_planes=m.num_planes, norm=m.norm,
        cv_backend=m.cv_backend, sampling=m.sampling, use_refiner=m.use_refiner,
    )


class InferenceSession:
    OUTPUT_CHANNELS = {"idepth": 1, "depth": 1, "prob": 1, "normal": 3}

    def __init__(
        self,
        cfg: Optional[Config] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        flax_variables: Optional[Mapping] = None,
        seed: int = 0,
        batch_buckets: Sequence[int] = (1, 4, 8),
        k_size: Optional[int] = None,
        outputs: Sequence[str] = ("idepth", "depth", "prob", "normal"),
        wire_dtype: str = "float32",
        compute_dtype: Optional[str] = None,
        device="cuda",
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
        if state_dict is not None and flax_variables is not None:
            raise ValueError("pass state_dict or flax_variables, not both")
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
        self.k_size = k_size or self.cfg.model.k_size

        model = build_model(self.cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        elif flax_variables is not None:
            load_flax_variables(model, flax_variables)
        else:
            init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(device=self.device, dtype=self.compute_dtype).eval()

    def _layout(self, views: int):
        """``(name, channels)`` slices packed into the wire's last axis."""
        has_prob = views >= 3 and self.model.refine_net is not None
        layout = [(name, self.OUTPUT_CHANNELS[name]) for name in self.outputs
                  if name != "prob" or has_prob]
        if not layout:
            raise ValueError(f"outputs {self.outputs} select nothing for {views} views "
                             "(prob needs 3+ views and the refiner)")
        return layout

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor, cams: torch.Tensor, layout) -> torch.Tensor:
        """One bucket batch on the device -> the packed ``[B, H, W, C]`` wire."""
        out = self.model(prepare_images(images), cams)
        if out.idepth_refined is not None:
            idepth, prob = out.idepth_refined, out.prob_map
        else:  # 2-view path: single-pair disp1, no occlusion head
            idepth, prob = out.disps[0][:, 0], None
        depth = 1.0 / (idepth[..., 0] + 1e-8)
        parts = {"idepth": idepth, "depth": depth[..., None], "prob": prob}
        if any(name == "normal" for name, _ in layout):
            K_inv = invert_intrinsics(cams[:, 0, 1, :3, :3])
            parts["normal"], _ = dispatch.depth_to_normal(
                depth, K_inv, self.k_size, backend=self.cfg.model.cv_backend
            )
        packed = torch.cat([parts[name].float() for name, _ in layout], -1)
        if self.wire_dtype != packed.dtype:
            fin = torch.finfo(self.wire_dtype)
            packed = packed.clamp(fin.min, fin.max)
        return packed.to(self.wire_dtype)

    def _run(self, images: np.ndarray, cams: np.ndarray) -> Dict[str, np.ndarray]:
        """One chunk no larger than the top bucket: pad, forward, one transfer, crop."""
        B, V = images.shape[:2]
        bucket = _next_bucket(B, self.buckets)
        if B < bucket:
            images = np.concatenate([images] + [images[-1:]] * (bucket - B), 0)
            cams = np.concatenate([cams] + [cams[-1:]] * (bucket - B), 0)
        layout = self._layout(V)
        packed = self._forward(
            torch.from_numpy(np.ascontiguousarray(images)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(cams)).to(self.device),
            layout,
        )
        arr = packed.cpu()  # the single device->host transfer
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
        out, c = {}, 0
        for name, nc in layout:
            a = arr[:B, ..., c : c + nc]
            c += nc
            out[name] = (a[..., 0] if nc == 1 else a).astype(np.float32)
        return out

    def predict(self, images: np.ndarray, cams: np.ndarray) -> Dict[str, np.ndarray]:
        images = np.asarray(images)
        cams = np.asarray(cams, np.float32)
        if images.ndim != 5 or cams.ndim != 5:
            raise ValueError(f"want images [B, V, H, W, 3] and cams [B, V, 2, 4, 4], "
                             f"got {images.shape} and {cams.shape}")
        top = self.buckets[-1]
        if images.shape[0] <= top:
            return self._run(images, cams)
        outs = [self._run(images[i : i + top], cams[i : i + top])
                for i in range(0, images.shape[0], top)]
        return {k: np.concatenate([o[k] for o in outs], 0) for k in outs[0]}

    def warmup(self, views: int, height: int, width: int):
        """Run every bucket once for one signature (loads the kernels)."""
        for b in self.buckets:
            images = np.zeros((b, views, height, width, 3), np.uint8)
            cams = np.broadcast_to(np.eye(4, dtype=np.float32), (b, views, 2, 4, 4)).copy()
            cams[:, :, 1, :3, :3] = np.asarray(
                [[100.0, 0, width / 2], [0, 100.0, height / 2], [0, 0, 1]], np.float32
            )
            self.predict(images, cams)
