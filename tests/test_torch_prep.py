"""The port's offline preparation (``data/prep.py``, ``data/prep_planes.py``)
against the JAX package's, on a ``tests/test_prep_planes.py``-style scene:
camera text, list lines, plane ``.npy`` and the label PNGs (decoded: the
port writes them with ``imageio.write_png``, JAX with cv2) all equal."""

import os
import shutil
import sys

import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from cnmnet_tpu.data import prep as jprep  # noqa: E402
from cnmnet_tpu.data import prep_planes as jprep_planes  # noqa: E402
from cnmnet_tpu_torch.data import prep, prep_planes  # noqa: E402
from cnmnet_tpu_torch.data.imageio import read_png, write_png  # noqa: E402

H, W = 96, 128
FRAMES = tuple(range(0, 80, 10))


def _pack(gid):
    packed = (gid + 1).astype(np.int64)
    return np.stack([packed // 65536, (packed // 256) % 256, packed % 256], -1).astype(np.uint8)


@pytest.fixture(scope="module")
def raw_scene(tmp_path_factory):
    """A ScanNet-layout scene with PlaneRCNN-style global annotations: two
    fronto-parallel planes (z = 3 left, z = 2 right) seen by cameras that
    translate along x; frame 30's depth is 9 m everywhere (rejected), frame
    50's pose is not finite, frame 60's depth is half size."""
    scene = tmp_path_factory.mktemp("raw") / "scene0000_00"
    for sub in ("intrinsic", "annotation/segmentation", "depth", "pose", "rgb"):
        (scene / sub).mkdir(parents=True)
    K4 = np.eye(4)
    K4[0, 0] = K4[1, 1] = 100.0
    K4[0, 2], K4[1, 2] = W / 2, H / 2
    np.savetxt(scene / "intrinsic" / "intrinsic_depth.txt", K4)
    np.savetxt(scene / "intrinsic" / "intrinsic_color.txt", K4)
    np.save(scene / "annotation" / "planes.npy",
            np.asarray([[0.0, 0.0, 3.0], [0.0, 0.0, 2.0], [1.0, 0.0, 0.0]], np.float32))
    rng = np.random.default_rng(0)
    for fid in FRAMES:
        pose = np.eye(4)
        pose[0, 3] = 0.01 * fid
        if fid == 50:
            pose[1, 1] = np.nan
        np.savetxt(scene / "pose" / f"{fid}.txt", pose)
        gid = np.full((H, W), -1, np.int64)
        gid[10:, : W // 2] = 0
        gid[10:, W // 2:] = 1
        gid[40:44, 60:64] = 2  # 16 px: cleaned away
        write_png(str(scene / "annotation" / "segmentation" / f"{fid}.png"), _pack(gid))
        depth = np.zeros((H, W))
        depth[:, : W // 2] = 3.0
        depth[:, W // 2:] = 2.0
        depth[20:30, 20:30] = 0.0  # no measurement: keeps its label
        depth[50:60, 10:20] = 3.5  # 0.5 m off the plane: cleaned away
        if fid == 30:
            depth[:] = 9.0
        if fid == 60:
            depth = depth[::2, ::2]
        write_png(str(scene / "depth" / f"{fid}.png"), (depth * 1000).astype(np.uint16))
        cv2.imwrite(str(scene / "rgb" / f"{fid}.jpg"), (rng.random((H, W, 3)) * 255).astype(np.uint8))
    return scene


def _copy(scene, tmp_path, name):
    dst = tmp_path / name / scene.name
    shutil.copytree(scene, dst)
    return dst


def test_decode_packed_segmentation_equals_jax():
    gid = np.random.default_rng(1).integers(-1, 70000, (9, 11))
    rgb = _pack(gid)
    got = prep_planes.decode_packed_segmentation(rgb)
    np.testing.assert_array_equal(got, jprep_planes.decode_packed_segmentation(rgb))
    np.testing.assert_array_equal(got, gid)
    assert prep_planes.NON_PLANAR == jprep_planes.NON_PLANAR


@pytest.mark.parametrize("source", [None, (W, H)])
def test_make_camera_files_equals_jax(raw_scene, tmp_path, source):
    ours, theirs = _copy(raw_scene, tmp_path, "ours"), _copy(raw_scene, tmp_path, "theirs")
    kw = {} if source is None else {"source_width": source[0], "source_height": source[1]}
    n = prep.make_camera_files(str(ours), 64, 48, **kw)
    assert n == jprep.make_camera_files(str(theirs), 64, 48, **kw) == len(FRAMES) - 1
    names = sorted(os.listdir(theirs / "cameras"))
    assert sorted(os.listdir(ours / "cameras")) == names and "50_cam.txt" not in names
    for name in names:
        assert (ours / "cameras" / name).read_text() == (theirs / "cameras" / name).read_text()


def test_plane_depth_map_and_cleaning_equal_jax():
    rng = np.random.default_rng(2)
    K_inv = np.linalg.inv(np.asarray([[90.0, 0, 33], [0, 95.0, 21], [0, 0, 1]]))
    planes = rng.uniform(-3, 3, (5, 3))
    planes[0] = [0.0, 0.0, 0.0]  # degenerate: zero depth everywhere
    got = prep.plane_depth_map(planes, K_inv, 40, 64)
    np.testing.assert_array_equal(got, jprep.plane_depth_map(planes, K_inv, 40, 64))
    seg = rng.integers(0, 5, (40, 64)).astype(np.int32)
    seg[:5] = 20
    depth = np.abs(got[2]) * (1 + rng.normal(0, 0.05, got[2].shape))
    depth[::7] = 0.0
    for tol, area in ((0.1, 100), (0.3, 10)):
        np.testing.assert_array_equal(
            prep.clean_plane_segmentation(seg, planes, depth, K_inv, tol, area),
            jprep.clean_plane_segmentation(seg, planes, depth, K_inv, tol, area))
    none = np.full((4, 4), 20, np.int32)
    np.testing.assert_array_equal(prep.clean_plane_segmentation(none, planes, none * 1.0, K_inv),
                                  none)


def _labels(path, reader):
    return {f: reader(os.path.join(path, f)) for f in sorted(os.listdir(path))}


@pytest.mark.parametrize("limit", [None, 4])
def test_prepare_scene_equals_jax(raw_scene, tmp_path, limit):
    ours, theirs = _copy(raw_scene, tmp_path, "ours"), _copy(raw_scene, tmp_path, "theirs")
    n = prep_planes.prepare_scene(str(ours), num_workers=2, limit=limit)
    assert n == jprep_planes.prepare_scene(str(theirs), num_workers=2, limit=limit)
    assert n == (3 if limit else len(FRAMES) - 2)  # frame 30 rejected, 50 without a pose
    seg_o = _labels(ours / "planercnn_seg_003", read_png)
    seg_t = _labels(theirs / "planercnn_seg_003", lambda p: cv2.imread(p, -1))
    assert seg_o.keys() == seg_t.keys() and "30.png" not in seg_o
    for f in seg_t:
        np.testing.assert_array_equal(seg_o[f], seg_t[f], err_msg=f)
    para_o = _labels(ours / "planercnn_para_003", np.load)
    para_t = _labels(theirs / "planercnn_para_003", np.load)
    assert para_o.keys() == para_t.keys()
    for f in para_t:
        np.testing.assert_array_equal(para_o[f], para_t[f], err_msg=f)
    labels = set(np.unique(seg_o["0.png"]))
    assert labels == {0, 1, prep_planes.NON_PLANAR}


def test_prepare_scene_needs_no_cv2(raw_scene, tmp_path, monkeypatch):
    want = _copy(raw_scene, tmp_path, "with")
    prep_planes.prepare_scene(str(want), num_workers=1, limit=2)
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    got = _copy(raw_scene, tmp_path, "without")
    assert prep_planes.prepare_scene(str(got), num_workers=1, limit=2) == 2
    for f in ("0.png", "10.png"):
        a = (got / "planercnn_seg_003" / f).read_bytes()
        assert a == (want / "planercnn_seg_003" / f).read_bytes()


@pytest.fixture(scope="module")
def prepared(raw_scene, tmp_path_factory):
    """The raw scene with cameras and plane annotations, and the cases that
    the list's validity gates reject: frame 70 without its camera, frame 40
    with an all-zero depth, frame 20 with one plane label, frame 10 with
    empty params; plane-fit errors and normal .mat files for the gated
    variants."""
    import scipy.io

    root = tmp_path_factory.mktemp("prepared")
    scene = root / raw_scene.name
    shutil.copytree(raw_scene, scene)
    prep.make_camera_files(str(scene), W, H)
    prep_planes.prepare_scene(str(scene), num_workers=2)
    os.remove(scene / "cameras" / "70_cam.txt")
    write_png(str(scene / "depth" / "40.png"), np.zeros((H, W), np.uint16))
    write_png(str(scene / "planercnn_seg_003" / "20.png"), np.full((H, W), 20, np.uint8))
    np.save(scene / "planercnn_para_003" / "10.npy", np.zeros((0, 3), np.float32))
    (scene / "planercnn_error_003").mkdir()
    (scene / "normal").mkdir()
    for fid in FRAMES:
        np.save(scene / "planercnn_error_003" / f"{fid}.npy",
                {"error": 0.9 if fid == 60 else 0.1}, allow_pickle=True)
        n = np.zeros((4, 4))
        if fid == 0:
            n[1, 1] = np.nan
        scipy.io.savemat(scene / "normal" / f"{fid}.mat", {"nx": n, "ny": n, "nz": n + 1})
    (root / "notes").mkdir()  # a scene without rgb/
    return root


LIST_CASES = {"default": {}, "no_planes": {"require_planes": False},
              "stride_10": {"frame_stride": 10, "interval": 20},
              "error_threshold": {"error_threshold": 0.7, "require_planes": False},
              "check_normals": {"check_normals": True, "require_planes": False},
              "two_views": {"view_num": 2, "require_planes": False}}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_make_train_list_equals_jax(prepared, tmp_path, case):
    kw = LIST_CASES[case]
    n = prep.make_train_list(str(prepared), str(tmp_path / "ours.txt"), num_workers=2, **kw)
    m = jprep.make_train_list(str(prepared), str(tmp_path / "theirs.txt"), num_workers=2, **kw)
    ours = (tmp_path / "ours.txt").read_text()
    assert n == m and ours == (tmp_path / "theirs.txt").read_text()
    if case == "no_planes":
        assert ours == "scene0000_00 10\nscene0000_00 20\nscene0000_00 30\n"


@pytest.mark.parametrize("command", ["prep-cameras", "prep-planes", "prep-list"])
def test_cli_command_equals_jax(raw_scene, tmp_path, capsys, command):
    """``cnmnet_tpu_torch.cli`` against ``cnmnet_tpu.cli`` on copies of one
    scene: the same printed line and the same files."""
    from cnmnet_tpu import cli as jcli
    from cnmnet_tpu_torch import cli

    out = {}
    for name, main in (("ours", cli.main), ("theirs", jcli.main)):
        scene = _copy(raw_scene, tmp_path, name)
        prep.make_camera_files(str(scene), W, H)
        prep_planes.prepare_scene(str(scene), num_workers=1)
        argv = {"prep-cameras": ["--scene-dir", str(scene), "--out-width", "64",
                                 "--out-height", "48"],
                "prep-planes": ["--scene-dir", str(scene), "--num-workers", "2", "--limit", "5"],
                "prep-list": ["--root-dir", str(scene.parent), "--out",
                              str(scene.parent / "list.txt"), "--frame-stride", "10"]}[command]
        capsys.readouterr()
        assert main([command] + argv) == 0
        printed = capsys.readouterr().out.replace(str(tmp_path / name), "ROOT")
        files = {}
        for sub in ("cameras", "planercnn_para_003"):
            for f in sorted(os.listdir(scene / sub)):
                files[f"{sub}/{f}"] = (scene / sub / f).read_bytes()
        for f in sorted(os.listdir(scene / "planercnn_seg_003")):
            files[f"seg/{f}"] = read_png(str(scene / "planercnn_seg_003" / f)).tobytes()
        if command == "prep-list":
            files["list.txt"] = (scene.parent / "list.txt").read_bytes()
        out[name] = (printed, files)
    assert out["ours"][0] == out["theirs"][0] and out["ours"][0].startswith("wrote ")
    assert out["ours"][1] == out["theirs"][1]
