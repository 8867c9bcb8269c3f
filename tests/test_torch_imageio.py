"""The port's numpy PNG codec and resizes against cv2.

``read_png`` must equal ``cv2.imread(path, -1)`` (channels flipped to RGB)
on cv2-written PNGs, and on PNGs whose rows use each of the five filter
types (cv2 writes every row with the Sub filter, so the other four are
encoded here by a plain reference encoder). ``write_png`` round-trips
through ``cv2.imread``. ``resize_linear_u8`` and ``resize_nearest`` equal
``cv2.resize`` exactly; ``resize_linear_f32`` is held to 1e-6 relative
(with OpenCV 5 it is exact: each pass is cv2's fused lerp).
"""

import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from cnmnet_tpu_torch.data import imageio  # noqa: E402


def _texture(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 17.0 + y / 23.0), 128 + 100 * np.cos(x / 29.0),
                    128 + 90 * np.sin(y / 11.0)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)


def _images():
    rng = np.random.default_rng(0)
    depth = np.full((480, 640), 2500, np.uint16)
    depth[:10, :10] = 65535
    depth[200:300, 100:400] = rng.integers(0, 65536, (100, 300))
    label = np.full((96, 128), 7, np.uint8)
    label[:48] = 0
    label[48:, :64] = 1
    return {
        "rgb_texture": _texture(480, 640, 1),
        "rgb_noise": rng.integers(0, 256, (480, 640, 3)).astype(np.uint8),
        "depth16": depth,
        "label": label,
        "rgba": rng.integers(0, 256, (50, 70, 4)).astype(np.uint8),
        "rgb16": rng.integers(0, 65536, (50, 70, 3)).astype(np.uint16),
    }


IMAGES = _images()


def _cv2_order(img):
    """RGB(A) <-> BGR(A), the channel order cv2 uses in memory."""
    if img.ndim == 2:
        return img
    return img[..., [2, 1, 0, 3]] if img.shape[2] == 4 else img[..., ::-1]


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_read_png_equals_cv2(tmp_path, name):
    img = IMAGES[name]
    path = str(tmp_path / f"{name}.png")
    assert cv2.imwrite(path, _cv2_order(img))
    got = imageio.read_png(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, _cv2_order(cv2.imread(path, -1)))
    np.testing.assert_array_equal(got, img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode_filtered(img, bit_depth):
    """A reference PNG encoder whose row y uses filter type y % 5."""
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">")))
    rows = rows.view(np.uint8).reshape(img.shape[0], -1).astype(np.int64)
    channels = 1 if img.ndim == 2 else img.shape[2]
    bpp = channels * bit_depth // 8
    out = []
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows):
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        pred = [0, left, prior, (left + prior) // 2, _paeth(left, prior, up_left)][kind]
        out.append(bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prior = row

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    header = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], bit_depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["rgb_texture", "depth16", "rgba", "rgb16"])
def test_read_png_every_filter_type(tmp_path, name):
    img = IMAGES[name][:40, :60]
    path = str(tmp_path / "filtered.png")
    with open(path, "wb") as f:
        f.write(_encode_filtered(img, 8 * img.dtype.itemsize))
    np.testing.assert_array_equal(imageio.read_png(path), img)
    np.testing.assert_array_equal(_cv2_order(cv2.imread(path, -1)), img)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_write_png_round_trips_through_cv2(tmp_path, name):
    img = IMAGES[name]
    path = str(tmp_path / f"{name}.png")
    imageio.write_png(path, img)
    np.testing.assert_array_equal(_cv2_order(cv2.imread(path, -1)), img)
    np.testing.assert_array_equal(imageio.read_png(path), img)


def test_read_png_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        imageio.read_png(str(tmp_path / "missing.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        imageio.read_png(str(tmp_path / "not.png"))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        imageio.write_png(str(tmp_path / "f.png"), np.zeros((2, 2), np.float32))


U8_CASES = [
    ("rgb_texture", (192, 256)),
    ("rgb_texture", (48, 64)),
    ("rgb_noise", (192, 256)),
    ("rgb_noise", (48, 64)),
    ("odd", (40, 50)),
    ("gray", (192, 256)),
]


def _u8_source(name):
    if name == "odd":
        return IMAGES["rgb_noise"][:97, :131]
    if name == "gray":
        return IMAGES["rgb_texture"][..., 1]
    return IMAGES[name]


@pytest.mark.parametrize("name,size", U8_CASES)
def test_resize_linear_u8_equals_cv2(name, size):
    src = _u8_source(name)
    h, w = size
    got = imageio.resize_linear_u8(src, h, w)
    want = cv2.resize(src, (w, h), interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


F32_CASES = [((192, 256), (480, 640)), ((480, 640), (192, 256)), ((968, 1296), (192, 256)),
             ((96, 128), (48, 64)), ((48, 64), (480, 640))]


@pytest.mark.parametrize("src_size,size", F32_CASES)
def test_resize_linear_f32_matches_cv2(src_size, size):
    rng = np.random.default_rng(3)
    src = rng.random(src_size + (3,), dtype=np.float32) * 5 + 0.1
    if src_size == (48, 64):  # a depth map: one channel
        src = src[..., 0]
    h, w = size
    got = imageio.resize_linear_f32(src, h, w)
    want = cv2.resize(src, (w, h), interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_resize_linear_f32_keeps_constants():
    """A constant map stays exactly constant (each pass is a + (b - a) f)."""
    src = np.full((48, 64), np.float32(1 / (1 / 3.0 + 1e-8)), np.float32)
    got = imageio.resize_linear_f32(src, 480, 640)
    assert (got == src[0, 0]).all()
    assert (cv2.resize(src, (640, 480), interpolation=cv2.INTER_LINEAR) == src[0, 0]).all()


@pytest.mark.parametrize("name,size", [("rgb_texture", (192, 256)), ("depth16", (192, 256)),
                                       ("depth16", (48, 64)), ("odd", (40, 50)),
                                       ("label", (48, 64)), ("label", (192, 256))])
def test_resize_nearest_equals_cv2(name, size):
    src = _u8_source(name) if name == "odd" else IMAGES[name]
    h, w = size
    for img in (src, src.astype(np.float32)):
        got = imageio.resize_nearest(img, h, w)
        np.testing.assert_array_equal(got, cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))
