"""The port's ScanNetDataset on its cv2 path (``use_native=False``) against
the JAX package's cv2 path (``tests/test_torch_native.py`` holds the native
paths against each other).

The mock scene tree of ``test_scannet_loader.py`` (96x128 on disk, 48x64
out), rewritten here, read by both loaders on both wires and with both
``normal_source``s: every field equal exactly except the images. The JAX
loader resizes the RGB as float32 with cv2; the port with
``imageio.resize_linear_f32``, so the f32 wire is held to 1e-6 (relative
to the image's range, as normalised values cross 0) and the uint8 wire,
which rounds the resized float, to 1 level, with the count of differing
values stated (0 with OpenCV 5, whose resizes ``imageio`` matches bit for bit).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from cnmnet_tpu.data.cameras import write_cam_text  # noqa: E402
from cnmnet_tpu.data.scannet import ScanNetDataset as JScanNet  # noqa: E402
from cnmnet_tpu_torch.data.scannet import ScanNetDataset  # noqa: E402

H0, W0 = 96, 128  # on-disk resolution
H, W = 48, 64  # loader output


@pytest.fixture(scope="module")
def mock_scannet(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet")
    scene = root / "scene0000_00"
    for sub in ("rgb", "depth", "lg_normal", "cameras", "planercnn_seg_003",
                "planercnn_para_003", "normal_color"):
        (scene / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    K = np.asarray([[100.0, 0, W0 / 2], [0, 100.0, H0 / 2], [0, 0, 1]])
    for fid in (0, 10, 20, 30):
        rgb = (rng.random((H0, W0, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(scene / "rgb" / f"{fid}.jpg"), rgb[..., ::-1])
        depth_mm = np.full((H0, W0), 2500, np.uint16)
        depth_mm[:8] = 50  # < 0.1 m -> clamped to 0
        depth_mm[-8:] = 7000  # > depth_scale -> clamped to 0
        depth_mm[30:40, 50:90] = rng.integers(500, 4000, (10, 40))
        cv2.imwrite(str(scene / "depth" / f"{fid}.png"), depth_mm)
        normal = np.zeros((H0, W0, 3), np.float32)
        normal[..., 2] = 1.0
        normal[10:20, 10:20] = rng.uniform(-1, 1, (10, 10, 3))
        if fid == 20:  # the 16-bit png fallback of lg_normal
            png = np.clip((normal / 2 + 0.5) * 65535, 0, 65535).astype(np.uint16)
            cv2.imwrite(str(scene / "lg_normal" / f"{fid}.png"), png[..., ::-1])
        else:
            np.save(str(scene / "lg_normal" / f"{fid}.npy"), normal)
        color = ((normal / 2 + 0.5) * 255).astype(np.uint8)
        cv2.imwrite(str(scene / "normal_color" / f"{fid}.png"), color[..., ::-1])
        E = np.eye(4)
        E[0, 3] = 0.01 * fid
        (scene / "cameras" / f"{fid}_cam.txt").write_text(write_cam_text(E, K))
        seg = np.full((H0, W0), 7, np.uint8)  # max label -> non-planar (20)
        seg[: H0 // 2] = 0
        seg[H0 // 2:, : W0 // 2] = 1
        seg[H0 // 2:H0 // 2 + 5, W0 // 2:W0 // 2 + 5] = 3  # 25 px: dropped
        cv2.imwrite(str(scene / "planercnn_seg_003" / f"{fid}.png"), seg)
        para = np.zeros((8, 3), np.float32)
        para[0] = [0, 0, 2.5]
        para[1] = [0, 2.0, 0.5]
        if fid != 10:  # one sample without plane annotations
            np.save(str(scene / "planercnn_para_003" / f"{fid}.npy"), para)
    (root / "list.txt").write_text("scene0000_00 10\nscene0000_00 20\n")
    return str(root)


def _pair(root, **kw):
    args = dict(list_filepath=os.path.join(root, "list.txt"), root_dir=root, image_height=H,
                image_width=W)
    return (ScanNetDataset(**args, use_native=False, **kw),
            JScanNet(**args, use_native=False, **kw))


@pytest.mark.parametrize("normal_source", ["lg_normal", "normal_color"])
@pytest.mark.parametrize("wire", ["float32", "uint8"])
@pytest.mark.parametrize("index", [0, 1])
def test_sample_matches_jax(mock_scannet, wire, normal_source, index):
    ours, theirs = _pair(mock_scannet, wire_dtype=wire, normal_source=normal_source)
    assert len(ours) == len(theirs) == 2
    got, want = ours[index], theirs[index]
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k != "images":
            np.testing.assert_array_equal(a, b, err_msg=k)
    a, b = got["images"], want["images"]
    if wire == "float32":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    else:
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert diff.max() <= 1, f"{int((diff > 0).sum())} of {diff.size} values differ"
    assert int(got["planes_num"]) == (0 if index == 0 else 2)


def test_without_planes(mock_scannet):
    ours, theirs = _pair(mock_scannet, load_planes=False)
    got, want = ours[1], theirs[1]
    assert got.keys() == want.keys() and "plane_segs" not in got
    np.testing.assert_array_equal(got["instance_segs"], want["instance_segs"])


def test_missing_rgb_raises(mock_scannet, tmp_path):
    (tmp_path / "list.txt").write_text("scene0000_00 40\n")
    ds = ScanNetDataset(str(tmp_path / "list.txt"), mock_scannet, image_height=H, image_width=W)
    with pytest.raises(FileNotFoundError):
        ds[0]


def test_without_cv2_the_jpeg_decode_raises(mock_scannet, monkeypatch):
    """The card's machine has no cv2: the PNG fields still load, the JPEG
    frames raise the JAX loader's error."""
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    ds = ScanNetDataset(os.path.join(mock_scannet, "list.txt"), mock_scannet,
                        image_height=H, image_width=W, use_native=False)
    assert ds._load_depth("scene0000_00", "10").shape == (H0, W0)
    with pytest.raises(RuntimeError, match="ScanNetDataset requires cv2"):
        ds[0]
