"""The port's native loader (``cnmnet_tpu_torch/data/native``) against the
JAX package's, and ``ScanNetDataset(use_native=True)`` against the JAX one.

Both loaders build the same ``loader.cc`` with the same flags against the
same system libjpeg and libpng, so every decode is held exactly. The native
path against the port's cv2 path takes the JAX tests' bounds
(``tests/test_scannet_loader.py``): depth within 1e-6, RGB within a mean
absolute difference of 0.05 (another IDCT and another resize rounding).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from cnmnet_tpu.data import native as jnative  # noqa: E402
from cnmnet_tpu.data.scannet import ScanNetDataset as JScanNet  # noqa: E402
from cnmnet_tpu_torch.data import native  # noqa: E402
from cnmnet_tpu_torch.data.scannet import ScanNetDataset  # noqa: E402
from cnmnet_tpu_torch.kernels import build  # noqa: E402
from tests.test_torch_scannet import H, H0, W, W0, mock_scannet  # noqa: E402,F401

SCENE = "scene0000_00"


@pytest.fixture(scope="module")
def loaders():
    if not native.available():
        pytest.fail(f"the port's native loader did not build: {native.build_error()}")
    if not jnative.available():
        pytest.fail(f"the JAX native loader did not build: {jnative.build_error()}")
    return native, jnative


def _files(root, kind, ext):
    d = os.path.join(root, SCENE, kind)
    return [os.path.join(d, f"{fid}.{ext}") for fid in (0, 10, 20, 30)]


def test_builds_into_the_build_directory():
    path = native.library_path()
    assert path.parent == build.BUILD_DIR and path.name.startswith("cnmloader-")
    assert native.available() and path.is_file()
    assert not [f for f in os.listdir(native.SRC.parent) if f.endswith(".so")]


@pytest.mark.parametrize("size", [(H, W), (37, 53), (H0, W0)])
def test_decodes_equal_jax(loaders, mock_scannet, size):
    ours, theirs = loaders
    h, w = size
    for path in _files(mock_scannet, "rgb", "jpg"):
        np.testing.assert_array_equal(ours.load_rgb_normalized(path, w, h),
                                      theirs.load_rgb_normalized(path, w, h))
        np.testing.assert_array_equal(ours.load_rgb_u8(path, w, h), theirs.load_rgb_u8(path, w, h))
    for path in _files(mock_scannet, "depth", "png"):
        np.testing.assert_array_equal(ours.load_depth_meters(path, w, h, 0.1, 5.0),
                                      theirs.load_depth_meters(path, w, h, 0.1, 5.0))


@pytest.mark.parametrize("threads", [1, 4])
def test_load_frames_equals_jax(loaders, mock_scannet, threads):
    ours, theirs = loaders
    rgb, depth = _files(mock_scannet, "rgb", "jpg"), _files(mock_scannet, "depth", "png")
    got = ours.load_frames(rgb, depth, W, H, num_threads=threads)
    want = theirs.load_frames(rgb, depth, W, H, num_threads=threads)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    one = [ours.load_rgb_normalized(p, W, H) for p in rgb]
    np.testing.assert_array_equal(got[0], np.stack(one))


def test_jpeg_size_and_errors(loaders, mock_scannet, tmp_path):
    path = _files(mock_scannet, "rgb", "jpg")[0]
    assert native.jpeg_size(path) == cv2.imread(path).shape[:2] == (H0, W0)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(IOError, match="jpeg header"):
        native.jpeg_size(str(bad))
    with pytest.raises(IOError, match="rgb load failed"):
        native.load_rgb_u8(str(bad), W, H)
    with pytest.raises(FileNotFoundError):
        native.jpeg_size(str(tmp_path / "absent.jpg"))


def _pair(root, **kw):
    args = dict(list_filepath=os.path.join(root, "list.txt"), root_dir=root, image_height=H,
                image_width=W)
    return ScanNetDataset(**args, **kw), JScanNet(**args, **kw)


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("index", [0, 1])
def test_native_sample_equals_jax(loaders, mock_scannet, wire, index):
    ours, theirs = _pair(mock_scannet, use_native=True, wire_dtype=wire)
    assert ours.path == "native" and theirs._native is not None
    _equal(ours[index], theirs[index])


def test_native_is_the_default(loaders, mock_scannet):
    kw = dict(list_filepath=os.path.join(mock_scannet, "list.txt"), root_dir=mock_scannet,
              image_height=H, image_width=W)
    assert ScanNetDataset(**kw).path == "native"
    assert ScanNetDataset(**kw, use_native=False).path == "cv2"


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_native_against_cv2_path(loaders, mock_scannet, wire):
    """The JAX tests' bounds between the two paths, on the port's loader."""
    for index in (0, 1):
        a = ScanNetDataset(os.path.join(mock_scannet, "list.txt"), mock_scannet, image_height=H,
                           image_width=W, use_native=False, wire_dtype=wire)[index]
        b = ScanNetDataset(os.path.join(mock_scannet, "list.txt"), mock_scannet, image_height=H,
                           image_width=W, use_native=True, wire_dtype=wire)[index]
        np.testing.assert_allclose(b["depths"], a["depths"], atol=1e-6)
        diff = np.abs(b["images"].astype(np.float64) - a["images"].astype(np.float64))
        assert diff.mean() < (0.05 * 255 if wire == "uint8" else 0.05)
        for k in a:
            if k not in ("images", "depths", "disparity"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_native_path_needs_no_cv2(loaders, mock_scannet, monkeypatch):
    """On a machine without cv2 the native path decodes all the same, and
    equals the sample decoded with cv2 importable."""
    want = ScanNetDataset(os.path.join(mock_scannet, "list.txt"), mock_scannet, image_height=H,
                          image_width=W)[1]
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    ds = ScanNetDataset(os.path.join(mock_scannet, "list.txt"), mock_scannet, image_height=H,
                        image_width=W)
    _equal(ds[1], want)
    with pytest.raises(RuntimeError, match="ScanNetDataset requires cv2"):
        ScanNetDataset(os.path.join(mock_scannet, "list.txt"), mock_scannet, image_height=H,
                       image_width=W, use_native=False)[1]


def test_missing_compiler_leaves_the_cv2_path(monkeypatch, tmp_path, mock_scannet):
    """Without g++ the loader reports why, writes nothing, and the dataset
    takes the cv2 path, as the JAX dataset does."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    assert native.build_error()
    assert not (tmp_path / "build").exists() or not list((tmp_path / "build").iterdir())
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        native.load_rgb_u8("x.jpg", W, H)
    ds = ScanNetDataset(os.path.join(mock_scannet, "list.txt"), mock_scannet, image_height=H,
                        image_width=W)
    assert ds.path == "cv2" and ds[1]["images"].shape == (3, H, W, 3)
