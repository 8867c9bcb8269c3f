"""The port's ``data/plane_tools.py`` against the JAX package's, on the
cases of ``tests/test_plane_tools.py``: every output equal, RANSAC at a
fixed seed and with a ``np.random.Generator``, the PLY files byte for byte."""

import numpy as np
import pytest

pytest.importorskip("torch")

from cnmnet_tpu.data import plane_tools as jpt  # noqa: E402
from cnmnet_tpu_torch.data import plane_tools as pt  # noqa: E402
from tests.test_torch_detect_layout import assert_same  # noqa: E402


def _rot_z(th):
    return np.asarray([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])


def _fit(m):
    pts = np.random.default_rng(0).uniform(-1, 1, (50, 3))
    pts[:, 2] = 2.0
    return m.fit_plane(pts), m.plane_params_to_normal_offset(np.asarray([0.3, -0.2, 1.4]))


def _transform(m):
    E = np.eye(4)
    E[:3, :3] = _rot_z(0.4)
    E[:3, 3] = [0.2, -0.1, 0.3]
    planes = np.random.default_rng(1).uniform(-2, 2, (6, 3))
    return m.transform_planes(E, planes)


def _merge(m):
    planes = np.asarray([[0, 0, 2.0], [0, 0.001, 2.0], [1.0, 0, 0], [0, 0, 3.0]])
    seg = np.full((8, 8), 20, np.int32)
    seg[:2], seg[2:4], seg[4:6], seg[6:7] = 0, 1, 2, 3
    return m.merge_coplanar_planes(planes, seg)


def _merge_empty(m):
    return m.merge_coplanar_planes(np.zeros((2, 3)), np.full((4, 4), 20, np.int32))


def _ransac_data():
    rng = np.random.default_rng(2)
    src = rng.uniform(-1, 1, (40, 3))
    dst = src @ _rot_z(0.3).T + np.asarray([0.5, -0.2, 1.0])
    dst[::10] += 5.0  # 10% outliers
    return src, dst


def _ransac(m):
    src, dst = _ransac_data()
    return m.fit_transformation_ransac(src, dst, seed=3)


def _ransac_generator(m):
    src, dst = _ransac_data()
    return m.fit_transformation_ransac(src, dst, num_iterations=20,
                                       seed=np.random.default_rng(11))


def _kabsch(m):
    src, dst = _ransac_data()
    return m._kabsch(src[1:9], dst[1:9])


CASES = {"fit": _fit, "transform": _transform, "merge": _merge, "merge_empty": _merge_empty,
         "ransac": _ransac, "ransac_generator": _ransac_generator, "kabsch": _kabsch}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plane_tools_equal_jax(case):
    assert_same(CASES[case](pt), CASES[case](jpt))


def test_ransac_recovers_the_transform():
    T, inliers = _ransac(pt)
    np.testing.assert_allclose(T[:3, :3], _rot_z(0.3), atol=1e-4)
    assert inliers.sum() == 36


@pytest.mark.parametrize("colors", [False, True])
def test_write_ply_bytes_equal_jax(tmp_path, colors):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (5, 3))
    rgb = (rng.random((5, 3)) * 255).astype(np.uint8) if colors else None
    pt.write_ply(str(tmp_path / "ours.ply"), pts, rgb)
    jpt.write_ply(str(tmp_path / "theirs.ply"), pts, rgb)
    assert (tmp_path / "ours.ply").read_bytes() == (tmp_path / "theirs.ply").read_bytes()
