"""Image IO without cv2 or PIL: a PNG codec and cv2's resizes, in numpy.

The JAX package decodes and resizes with cv2 (``data/seven_scenes.py``,
``data/scannet.py``, ``evals/cal_metrics.py``). The port runs where neither
cv2 nor PIL is installed, so it keeps its own:

* ``read_png(path)``: non-interlaced PNG of 8-bit gray, gray + alpha, RGB
  or RGBA, or 16-bit gray, gray + alpha, RGB or RGBA, through ``zlib``;
  all five row filters. Sub and Up rows are vectorised; Average and Paeth
  rows depend on the pixel to their left and loop over it in Python, so a
  PNG whose writer chose them (cv2's libpng does, row by row) decodes at
  Python speed, some milliseconds a row. ``write_png`` writes filter 0
  only, which decodes at numpy speed. Channels come back in file order,
  RGB (``cv2.imread`` returns BGR);
* ``write_png(path, array)``: filter 0, ``zlib`` level 1;
* ``resize_linear_u8``: cv2's ``INTER_LINEAR`` on uint8, its fixed-point
  scheme step for step (11-bit coefficients, a horizontal pass in int, the
  vertical pass as its SIMD code rounds it), equal to ``cv2.resize`` at the
  downscales the loaders use;
* ``resize_linear_f32``: cv2's ``INTER_LINEAR`` on float images, each
  pass a fused ``a + (b - a) * f`` with the fraction taken in double and
  cv2's edge clamps, equal to ``cv2.resize`` (OpenCV 5) on float32;
* ``resize_nearest``: cv2's ``INTER_NEAREST``, exact for every dtype.

Every resize takes ``[H, W]`` or ``[H, W, C]`` and the output's ``(height,
width)``, where cv2 takes ``(width, height)``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}
_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE (11 bits)


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        yield kind, data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def _unfilter_average(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        left = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((left + prior[i]) >> 1)) & 255


def _unfilter_paeth(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        if i >= bpp:
            a, c = line[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 255


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: ``[H, W]`` for gray, ``[H, W, C]`` otherwise (RGB
    order), uint8 or uint16. Raises ``FileNotFoundError`` for a missing
    file and ``ValueError`` for a PNG outside the supported kinds."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type {color}, bit depth "
                         f"{depth}, interlace {interlace})")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:
            row = np.cumsum(line.reshape(width, bpp), 0, dtype=np.uint8).reshape(stride)
        elif kind == 2:
            row = line + prior
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            unfilter = _unfilter_average if kind == 3 else _unfilter_paeth
            unfilter(buf, prior.tobytes(), bpp)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has unknown filter type {kind}")
        out[y] = row
        prior = out[y]
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    out = out.reshape(height, width, channels)
    return out[..., 0] if channels == 1 else out


def write_png(path: str, array: np.ndarray) -> None:
    """Encode ``[H, W]`` or ``[H, W, C]`` (C in 1-4, RGB order) uint8 or
    uint16 as a PNG with filter 0 and ``zlib`` level 1."""
    array = np.asarray(array)
    if array.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {array.dtype}")
    if array.ndim == 2:
        array = array[..., None]
    height, width, channels = array.shape
    if channels not in _COLOR_TYPE:
        raise ValueError(f"write_png takes 1 to 4 channels, got {channels}")
    depth = 8 * array.dtype.itemsize
    rows = np.ascontiguousarray(array.astype(array.dtype.newbyteorder(">")))
    rows = rows.view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", width, height, depth, _COLOR_TYPE[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def _linear_taps(src: int, dst: int, double_fraction: bool):
    """cv2's source index and fraction per output index. The position is
    ``(d + 0.5) * scale - 0.5`` with ``scale = 1 / (dst / src)`` in double;
    cv2's fixed-point (uint8) path rounds it to float before taking its
    floor, its float path takes the fraction in double."""
    scale = 1.0 / (dst / src)
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if not double_fraction:
        pos = pos.astype(np.float32)
    i = np.floor(pos)
    return i.astype(np.int64), (pos - i).astype(np.float32)


def _horizontal_taps(src: int, dst: int, double_fraction: bool):
    """Horizontal taps with cv2's edge rules: a tap left of 0 becomes (0,
    fraction 0); from the first output whose right tap falls outside, the
    output copies the last column (``copy`` marks those)."""
    i, f = _linear_taps(src, dst, double_fraction)
    f[i < 0] = 0
    i[i < 0] = 0
    copy = i + 1 >= src
    i[copy] = src - 1
    f[copy] = 0
    return i, np.minimum(i + 1, src - 1), f, copy


def _vertical_taps(src: int, dst: int, double_fraction: bool):
    """Vertical taps: cv2 clamps the rows and keeps the fraction."""
    i, f = _linear_taps(src, dst, double_fraction)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), f


def _check_image(img: np.ndarray, dtypes) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim not in (2, 3) or img.dtype not in dtypes:
        raise ValueError(f"want an [H, W] or [H, W, C] image of {dtypes}, got "
                         f"{img.dtype} {img.shape}")
    return img


def resize_linear_u8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    for uint8, bit for bit at the loaders' downscales."""
    img = _check_image(img, (np.uint8,))
    x0, x1, fx, _ = _horizontal_taps(img.shape[1], width, False)
    y0, y1, fy = _vertical_taps(img.shape[0], height, False)
    one = np.float32(1)
    ax0 = np.rint((one - fx) * _COEF_SCALE).astype(np.int32)
    ax1 = np.rint(fx * _COEF_SCALE).astype(np.int32)
    by0 = np.rint((one - fy) * _COEF_SCALE).astype(np.int32)
    by1 = np.rint(fy * _COEF_SCALE).astype(np.int32)
    cols = (-1,) + (1,) * (img.ndim - 2)  # per column, broadcast over channels
    rows = np.unique(np.concatenate([y0, y1]))
    src = img[rows].astype(np.int32)
    h = src[:, x0] * ax0.reshape(cols) + src[:, x1] * ax1.reshape(cols)
    # the rows ``h`` holds, by source row index
    at = np.zeros(img.shape[0], np.int64)
    at[rows] = np.arange(len(rows))
    shape = (-1,) + (1,) * (img.ndim - 1)
    top = ((h[at[y0]] >> 4) * by0.reshape(shape)) >> 16
    bottom = ((h[at[y1]] >> 4) * by1.reshape(shape)) >> 16
    return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)


def _lerp(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """``a + (b - a) * f`` with one rounding after the multiply-add, as
    cv2's fused float path computes it (f32 through f64; a tie of the two
    roundings can differ, which no test has met)."""
    if a.dtype == np.float32:
        return ((b - a).astype(np.float64) * f + a).astype(np.float32)
    return (b - a) * f + a


def resize_linear_f32(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    for float32, bit for bit; float64 takes the same steps in double (within
    some 1e-8 of cv2's double path)."""
    img = _check_image(img, (np.float32, np.float64))
    if img.shape[:2] == (height, width):
        return img.copy()
    x0, x1, fx, copy = _horizontal_taps(img.shape[1], width, True)
    y0, y1, fy = _vertical_taps(img.shape[0], height, True)
    cols = (-1,) + (1,) * (img.ndim - 2)  # per column, broadcast over channels
    rows = np.unique(np.concatenate([y0, y1]))
    src = img[rows]
    h = _lerp(src[:, x0], src[:, x1], fx.reshape(cols))
    h[:, copy] = src[:, x0[copy]]
    at = np.zeros(img.shape[0], np.int64)
    at[rows] = np.arange(len(rows))
    return _lerp(h[at[y0]], h[at[y1]], fy.reshape((-1,) + (1,) * (img.ndim - 1)))


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)``:
    source index ``min(floor(d / (dst / src)), src - 1)``, any dtype."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / H))).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / W))).astype(np.int64), W - 1)
    return img[ys[:, None], xs[None, :]]
