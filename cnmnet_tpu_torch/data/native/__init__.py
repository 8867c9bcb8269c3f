"""ctypes bindings for the native (C++) data loader
(``cnmnet_tpu/data/native/__init__.py``).

``loader.cc`` (a copy of the JAX package's) is built with ``g++`` at first
use into ``build/cnmnet_tpu_torch/cnmloader-<hash>.so`` under the
repository root, beside the CUDA kernels, where ``<hash>``
(``kernels/build.digest``) covers the source and the compiler flags: an
edited source builds anew, an unchanged one is loaded as it is, and nothing
is written beside the source. Decode, resize and normalisation run in
native threads with the GIL released; Python only orchestrates.

``available()`` is False when the compiler or the image libraries are
missing (``build_error()`` says why, and the build is not tried again in
this process); ``data/scannet.py`` then keeps its cv2 path.

One entry is the port's own: ``jpeg_size(path)``, the JPEG header's
``(height, width)`` through the loader's ``decode_jpeg_rgb`` probe, so that
a dataset on the native path needs no other JPEG decoder.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from cnmnet_tpu_torch.kernels import build

SRC = Path(__file__).resolve().parent / "loader.cc"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_lib = None
_lock = threading.Lock()
_build_error: str | None = None


def library_path() -> Path:
    return build.BUILD_DIR / f"cnmloader-{build.digest([SRC], CXX_FLAGS + LIBS)}.so"


def _build(out: Path) -> bool:
    global _build_error
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_error = str(e)
        return False
    if proc.returncode != 0:
        _build_error = proc.stderr[-2000:]
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return True


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            _build_error = str(e)
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.decode_jpeg_rgb.argtypes = [u8p, ctypes.c_long, u8p, intp, intp]
        lib.decode_jpeg_rgb.restype = ctypes.c_int
        lib.load_rgb_normalized.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int, ctypes.c_int, f32p, f32p,
        ]
        lib.load_rgb_normalized.restype = ctypes.c_int
        lib.load_rgb_u8.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
        lib.load_rgb_u8.restype = ctypes.c_int
        lib.load_depth_meters.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ]
        lib.load_depth_meters.restype = ctypes.c_int
        lib.load_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), intp, ctypes.c_int, f32p, f32p,
            ctypes.c_int, ctypes.c_int, f32p, f32p, ctypes.c_float, ctypes.c_float,
            ctypes.c_int,
        ]
        lib.load_frames.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def jpeg_size(path: str) -> tuple[int, int]:
    """The ``(height, width)`` of a JPEG file, read from its header."""
    lib = _require()
    data = np.fromfile(path, np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.decode_jpeg_rgb(_u8ptr(data), data.size, None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"native jpeg header read failed ({rc}): {path}")
    return h.value, w.value


def load_rgb_normalized(path: str, width: int, height: int) -> np.ndarray:
    """JPEG -> resized [h, w, 3] float32, ImageNet-normalized."""
    lib = _require()
    out = np.empty((height, width, 3), np.float32)
    rc = lib.load_rgb_normalized(
        path.encode(), _fptr(out), width, height, _fptr(IMAGENET_MEAN), _fptr(IMAGENET_STD),
    )
    if rc != 0:
        raise IOError(f"native rgb load failed ({rc}): {path}")
    return out


def load_rgb_u8(path: str, width: int, height: int) -> np.ndarray:
    """JPEG -> resized [h, w, 3] uint8 (the uint8 wire format; the ImageNet
    affine runs on the device, ``ops/images.prepare_images``)."""
    lib = _require()
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.load_rgb_u8(path.encode(), _u8ptr(out), width, height)
    if rc != 0:
        raise IOError(f"native rgb load failed ({rc}): {path}")
    return out


def load_depth_meters(
    path: str, width: int, height: int, dmin: float = 0.1, dmax: float = 5.0
) -> np.ndarray:
    """16-bit depth PNG (mm) -> resized [h, w] float32 meters, clamp-to-0."""
    lib = _require()
    out = np.empty((height, width), np.float32)
    rc = lib.load_depth_meters(path.encode(), _fptr(out), width, height, dmin, dmax)
    if rc != 0:
        raise IOError(f"native depth load failed ({rc}): {path}")
    return out


def load_frames(
    rgb_paths: list[str],
    depth_paths: list[str],
    width: int,
    height: int,
    dmin: float = 0.1,
    dmax: float = 5.0,
    num_threads: int = 4,
):
    """Batched native load: returns (rgb [N, h, w, 3], depth [M, h, w])."""
    lib = _require()
    paths = list(rgb_paths) + list(depth_paths)
    kinds = [0] * len(rgb_paths) + [1] * len(depth_paths)
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_kinds = (ctypes.c_int * n)(*kinds)
    rgb = np.empty((len(rgb_paths), height, width, 3), np.float32)
    depth = np.empty((len(depth_paths), height, width), np.float32)
    bad = lib.load_frames(
        c_paths, c_kinds, n, _fptr(rgb), _fptr(depth), width, height,
        _fptr(IMAGENET_MEAN), _fptr(IMAGENET_STD), dmin, dmax, num_threads,
    )
    if bad:
        raise IOError(f"native batch load: {bad}/{n} frames failed")
    return rgb, depth
