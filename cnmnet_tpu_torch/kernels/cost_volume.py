"""Plane-sweep cost volume: the CUDA kernel's wrapper.

Replaces ``cnmnet_tpu/kernels/cost_volume_pallas.py:cost_volume_pallas``
with the hand-written kernel in ``csrc/cost_volume.cu`` (its header states
the bound on an H100 and the design). The plain version is
``ops/cost_volume.py``; ``cost_volume`` below takes it for CPU tensors only
and launches the kernel or raises for CUDA tensors.

The kernel reads the source images from a bordered four-channel copy that
its own pack launch writes into a scratch buffer: ``bordered_source`` is
that copy in plain PyTorch, and ``bordered_shape`` its shape.

A row shard of the tiled op (``parallel/tiled_ops.py``) passes its ``H``
reference rows with ``row_offset``, the global row of the first, against
the whole source of ``Hs`` rows; the untiled call is ``row_offset=0`` and
``Hs = H``.

The kernel indexes in 32 bits, so one launch takes fewer than 2^31
(``INDEX_LIMIT``) costs, reference elements and packed-source elements
(``check_sizes``). ``cost_volume_kernel`` covers a larger volume in several
launches (``launch_chunks``): chunks of whole pairs, or, where one pair's
volume alone reaches the limit, chunks of that pair's planes. Pairs and
planes are independent, so the result is the one launch's bit for bit.

``cost_volume_kernel.launches`` counts the kernel's launches: one per
chunk.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from cnmnet_tpu_torch.geometry.camera import Camera, plane_sweep_homography
from cnmnet_tpu_torch.kernels import build
from cnmnet_tpu_torch.ops import cost_volume as plain

BORDER = 2  # zero pixels around the packed source
INDEX_LIMIT = 2**31  # the kernel indexes in 32 bits
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def pack_coefs(ref_cam: Camera, src_cam: Camera) -> torch.Tensor:
    """Per-pair homography coefficients ``[B, 12]`` f32: ``K_s R K_r^-1``
    row-major, then ``K_s t`` (the ``_pack_coefs`` of the TPU kernel, minus
    its idepth ramp: the kernel reads the plane table itself)."""
    KRKi, KT = plane_sweep_homography(ref_cam, src_cam)
    B = KRKi.shape[0]
    return torch.cat([KRKi.reshape(B, 9), KT.reshape(B, 3)], 1).float().contiguous()


def bordered_shape(B: int, H: int, W: int) -> tuple:
    """Shape of the kernel's packed source: ``[B, H + 4, W + 4, 4]`` f32."""
    return (B, H + 2 * BORDER, W + 2 * BORDER, 4)


def bordered_source(src_images: torch.Tensor) -> torch.Tensor:
    """What the kernel's pack launch writes, in plain PyTorch: ``[B, H, W,
    3]`` -> ``[B, H + 4, W + 4, 4]``, the colour and a zero fourth channel
    inside a 2-pixel border of zeros."""
    b = BORDER
    return F.pad(src_images.float(), (0, 1, b, b, b, b))


def check_sizes(B: int, H: int, W: int, P: int, Hs: int = None) -> None:
    """Refuse a launch whose volume, reference rows or packed source (``Hs``
    rows, ``H`` by default; larger than the source) reach 2^31 elements:
    the kernel's index arithmetic is 32-bit."""
    Hs = H if Hs is None else Hs
    for name, n in (("volume", B * P * H * W), ("reference", B * H * W * 3),
                    ("packed source", math.prod(bordered_shape(B, Hs, W)))):
        if n >= INDEX_LIMIT:
            raise ValueError(f"cost volume {B}x{P}x{H}x{W}: its {name} has {n} elements, "
                             f"at or above the kernel's 32-bit limit of {INDEX_LIMIT}")


def _even_split(n: int, most: int) -> list:
    """``[(a, b), ...]`` covering ``[0, n)`` in as few pieces of at most
    ``most`` as there can be, their sizes within one of each other."""
    if n <= 0:
        return []
    count = -(-n // most)
    size = -(-n // count)
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def launch_chunks(B: int, H: int, W: int, P: int, Hs: int = None) -> list:
    """``[(b0, b1, p0, p1), ...]``: the launches that cover a ``[B, P, H,
    W]`` volume (reference rows against a source of ``Hs`` rows), each of
    pairs ``b0:b1`` and planes ``p0:p1`` and each below ``INDEX_LIMIT`` on
    all three counts of ``check_sizes``. Whole pairs where one pair fits;
    else each pair in chunks of its planes. Raises where one pair's
    reference or packed source alone reaches the limit."""
    Hs = H if Hs is None else Hs
    pair = max(P * H * W, H * W * 3, math.prod(bordered_shape(1, Hs, W)))
    if pair < INDEX_LIMIT:
        return [(b0, b1, 0, P) for b0, b1 in _even_split(B, (INDEX_LIMIT - 1) // pair)]
    check_sizes(1, H, W, 1, Hs)
    planes = _even_split(P, (INDEX_LIMIT - 1) // (H * W))
    return [(b, b + 1, p0, p1) for b in range(B) for p0, p1 in planes]


def cost_volume_kernel(
    ref_images: torch.Tensor,
    src_images: torch.Tensor,
    coefs: torch.Tensor,
    idepths: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    row_offset: int = 0,
) -> torch.Tensor:
    """Launch the kernel: ``[B, H, W, 3]`` f32 reference rows from global
    row ``row_offset`` on, the ``[B, Hs, W, 3]`` f32 source, ``[B, 12]``
    coefficients and the ``[P]`` plane table, all contiguous on one CUDA
    device -> ``[B, P, H, W]`` in ``out_dtype`` (f32 or bf16; the cost
    accumulates in f32 either way), in one launch for each chunk of
    ``launch_chunks``: one for every volume below 2^31 costs. Does not
    synchronise."""
    if not ref_images.is_cuda:
        raise ValueError("cost_volume_kernel takes CUDA tensors")
    B, H, W, C = ref_images.shape
    Hs = src_images.shape[1] if src_images.dim() == 4 else H
    P = idepths.shape[0]
    if row_offset < 0 or row_offset + H > Hs:
        raise ValueError(f"rows {row_offset}..{row_offset + H - 1} lie outside the source's "
                         f"{Hs} rows")
    for name, t, shape in (
        ("ref_images", ref_images, (B, H, W, 3)),
        ("src_images", src_images, (B, Hs, W, 3)),
        ("coefs", coefs, (B, 12)),
        ("idepths", idepths, (P,)),
    ):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: want f32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != ref_images.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {ref_images.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    chunks = launch_chunks(B, H, W, P, Hs)
    lib = build.load("cost_volume")
    fn = lib.cnm_cost_volume
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    most = max((b1 - b0 for b0, b1, _, _ in chunks), default=0)
    scratch = torch.empty(bordered_shape(most, Hs, W), dtype=torch.float32, device=ref_images.device)
    out = torch.empty((B, P, H, W), dtype=out_dtype, device=ref_images.device)
    with torch.cuda.device(ref_images.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0, b1, p0, p1 in chunks:
            check_sizes(b1 - b0, H, W, p1 - p0, Hs)
            status = fn(
                ref_images[b0:b1].data_ptr(), src_images[b0:b1].data_ptr(), scratch.data_ptr(),
                coefs[b0:b1].data_ptr(), idepths[p0:p1].data_ptr(),
                out[b0:b1, p0:p1].data_ptr(), b1 - b0, H, W, p1 - p0, Hs, row_offset,
                int(out_dtype == torch.bfloat16), stream,
            )
            build.check(status, "cnm_cost_volume")
            cost_volume_kernel.launches += 1
    return out


cost_volume_kernel.launches = 0


def cost_volume(
    ref_images: torch.Tensor,
    src_images: torch.Tensor,
    ref_cam: Camera,
    src_cam: Camera,
    idepth_scale: float = 3.0,
    num_planes: int = 64,
    out_dtype: torch.dtype = torch.float32,
    row_offset: int = 0,
) -> torch.Tensor:
    """Batched cost volume ``[B, H, W, P]`` of the ``H`` reference rows from
    global row ``row_offset`` on: a view of the plane-major ``[B, P, H, W]``
    result. CPU tensors take the plain version, CUDA tensors the kernel."""
    if not ref_images.is_cuda:
        vol = plain.cost_volume_from_cameras(
            ref_images, src_images, ref_cam, src_cam, idepth_scale, num_planes, row_offset
        )
        return vol.to(out_dtype)
    with torch.no_grad():
        idepths = plain.idepth_hypotheses(idepth_scale, num_planes, ref_images.device)
        vol = cost_volume_kernel(
            ref_images.float().contiguous(), src_images.float().contiguous(),
            pack_coefs(ref_cam, src_cam), idepths, out_dtype, row_offset,
        )
    return vol.permute(0, 2, 3, 1)
