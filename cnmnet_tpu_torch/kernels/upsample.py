"""Bilinear x2 upsampling of channels-last maps: the CUDA kernel's wrapper.

Replaces no TPU kernel (the JAX package left its upsamplings to XLA). The
hand-written kernel in ``csrc/upsample.cu`` (its header states the bound
on an H100 and the design) takes the place of PyTorch's NHWC kernel in the
nets a one-card serving session runs. Its plain version is
``upsample2x_bilinear_plain``, ``F.interpolate`` with half-pixel centres,
which it equals on the card bit for bit.

``kernels/dispatch.upsample2x_bilinear`` selects one, as it selects the
other kernels: on ``backend=None`` (the nets' default) from the input, a
channels-last CUDA map of a type the kernel takes, where no gradient is
needed, going to ``upsample2x_bilinear_kernel`` and everything else (CPU
tensors, NCHW maps, autograd) to the plain version; ``"torch"`` (a model's
``cv_backend``, the row shards of a tile axis) always to the plain version.

``upsample2x_bilinear_kernel.launches`` counts the kernel's launches. A
CUDA graph's replay launches nothing from the host, so inside a graph it
counts at the capture only; the serving session counts the replays
(``serve.InferenceSession.upsample_replayed``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cnmnet_tpu_torch.kernels import build

DTYPES = (torch.bfloat16, torch.float32)
CHANNEL_MULTIPLE = 8  # csrc/upsample.cu: 16-byte vectors of bf16
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def upsample2x_bilinear_plain(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 with half-pixel centres (edge-clamped weights 1/4, 3/4)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def upsample2x_bilinear_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: a channels-last ``[N, C, H, W]`` bf16 or f32 map on
    one CUDA device, ``C`` a multiple of 8 -> ``[N, C, 2H, 2W]`` of its type,
    channels-last, in one launch on the current stream. Does not
    synchronise; the output comes from PyTorch's allocator (a graph's pool
    under capture)."""
    if not x.is_cuda:
        raise ValueError("upsample2x_bilinear_kernel takes CUDA tensors")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"want a channels-last [N, C, H, W] map, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if x.dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {x.dtype}; the kernel takes {DTYPES}")
    N, C, H, W = x.shape
    if C % CHANNEL_MULTIPLE:
        raise ValueError(f"{C} channels: the kernel takes a multiple of {CHANNEL_MULTIPLE}")
    if x.data_ptr() % 16:
        raise ValueError("the map must start on a 16-byte boundary")
    lib = build.load("upsample")
    fn = lib.cnm_upsample2x_bilinear
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((N, C, 2 * H, 2 * W), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        status = fn(x.data_ptr(), out.data_ptr(), N, H, W, C, int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream().cuda_stream)
    build.check(status, "cnm_upsample2x_bilinear")
    upsample2x_bilinear_kernel.launches += 1
    return out


upsample2x_bilinear_kernel.launches = 0
