"""The port's metrics against the JAX package's, on the same seeded inputs.

The numpy metrics (``ops/metrics.py``), the plane metrics
(``ops/plane_metrics.py``), ``fit_plane``, the colorizers and the camera
files are copies: they must give the JAX package's values bit for bit,
empty masks included (NaN where JAX gives NaN). ``compute_all`` on tensors
is held to ``compute_all_jnp`` within 1e-6 (f32 sums in another order).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.data import cameras as jcameras  # noqa: E402
from cnmnet_tpu.data.plane_tools import fit_plane as jfit_plane  # noqa: E402
from cnmnet_tpu.obs import colorize as jcolorize  # noqa: E402
from cnmnet_tpu.ops import metrics as jmetrics  # noqa: E402
from cnmnet_tpu.ops import plane_metrics as jplane  # noqa: E402
from cnmnet_tpu_torch.data import cameras  # noqa: E402
from cnmnet_tpu_torch.data.plane_tools import fit_plane  # noqa: E402
from cnmnet_tpu_torch.obs import colorize  # noqa: E402
from cnmnet_tpu_torch.ops import metrics  # noqa: E402
from cnmnet_tpu_torch.ops import plane_metrics as plane  # noqa: E402


def _same(a, b):
    """Equal bit for bit, NaN equal to NaN, through nested tuples/lists/dicts."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b), (type(a), type(b))
        assert a == b or (math.isnan(a) and math.isnan(b)), (a, b)


def _depths(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.2, 9.0, n).astype(dtype)
    pred = (gt * rng.uniform(0.7, 1.4, n)).astype(dtype)
    return pred, gt


PAIRS = ["l1", "l1_inverse", "rmse", "rmse_log", "scale_invariant", "abs_relative",
         "sq_relative", "avg_log10"]


@pytest.mark.parametrize("n", [1000, 0])
@pytest.mark.parametrize("name", PAIRS + ["ratio_threshold"])
def test_depth_metric_bit_equal(name, n):
    pred, gt = _depths(n, 1)
    args = (pred, gt, 1.25 ** 2) if name == "ratio_threshold" else (pred, gt)
    _same(getattr(metrics, name)(*args), getattr(jmetrics, name)(*args))


@pytest.mark.parametrize("n", [4096, 0])
def test_compute_errors_and_mask_bit_equal(n):
    pred, gt = _depths(n, 2)
    gt[::7] = np.inf
    gt[::11] = np.nan
    for args in ((gt,), (pred, gt)):
        _same(metrics.compute_valid_depth_mask(*args), jmetrics.compute_valid_depth_mask(*args))
    m = metrics.compute_valid_depth_mask(pred, gt)
    _same(metrics.compute_errors(pred[m], gt[m]), jmetrics.compute_errors(pred[m], gt[m]))
    assert metrics.METRIC_NAMES == jmetrics.METRIC_NAMES


@pytest.mark.parametrize("scaling", ["abs", "log", "inv"])
def test_depth_scale_factor_bit_equal(scaling):
    pred, gt = _depths(2000, 3)
    _same(metrics.compute_depth_scale_factor(pred, gt, scaling),
          jmetrics.compute_depth_scale_factor(pred, gt, scaling))
    with pytest.raises(ValueError):
        metrics.compute_depth_scale_factor(pred, gt, "median")


@pytest.mark.parametrize("scaling", ["abs", "log", "inv"])
@pytest.mark.parametrize("inverse", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("translation", [(0.0, 0.0, 1.0), (0.3, -0.2, 0.5)])
def test_evaluate_depth_bit_equal(scaling, inverse, translation):
    rng = np.random.default_rng(4)
    gt = rng.uniform(0.1, 3.0, (48, 64)).astype(np.float32)
    pred = (gt * rng.uniform(0.8, 1.3, gt.shape)).astype(np.float32)
    pred[:4] = 0.0  # invalid rows
    t = np.asarray(translation)
    kw = dict(inverse_gt=inverse[0], inverse_pred=inverse[1], depth_scaling=scaling)
    _same(metrics.evaluate_depth(t, gt, pred, **kw), jmetrics.evaluate_depth(t, gt, pred, **kw))


@pytest.mark.parametrize("empty", [False, True])
def test_compute_all_matches_jnp(empty):
    pred, gt = _depths(192 * 256, 5)
    pred, gt = pred.reshape(192, 256), gt.reshape(192, 256)
    gt[:10] = np.nan
    if empty:
        gt[:] = 50.0
    got = metrics.compute_all(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jmetrics.compute_all_jnp(jnp.asarray(pred), jnp.asarray(gt))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def _planes(seed, n_gt=4, n_pred=5, h=48, w=64):
    rng = np.random.default_rng(seed)
    gt_seg = np.full((h, w), 20, np.int32)
    pred_seg = np.full((h, w), 20, np.int32)
    for i in range(n_gt):
        gt_seg[:, i * w // n_gt:(i + 1) * w // n_gt] = i
    gt_seg[: h // 6] = 20
    for j in range(n_pred):
        pred_seg[:, max(j * w // n_pred - 2, 0):(j + 1) * w // n_pred] = j
    gt_depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    pred_depth = (gt_depth + rng.normal(0, 0.1, (h, w))).astype(np.float32)
    gt_depth[-3:] = 0.0
    params = rng.normal(size=(n_pred, 3))
    gt_params = params[: n_gt] + rng.normal(0, 0.05, (n_gt, 3))
    return gt_seg, pred_seg, gt_depth, pred_depth, params, gt_params


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_metrics_bit_equal(seed):
    gt_seg, pred_seg, gt_depth, pred_depth, params, gt_params = _planes(seed)
    _same(plane.eval_iou(gt_seg == 0, pred_seg == 0), jplane.eval_iou(gt_seg == 0, pred_seg == 0))
    empty = np.zeros((4, 4), bool)
    _same(plane.eval_iou(empty, empty), jplane.eval_iou(empty, empty))
    # label maps hold 0..n-1 and the non-planar label 20 as the one extra value
    args = (pred_seg, gt_seg, pred_depth, gt_depth)
    _same(plane.eval_plane_prediction(*args), jplane.eval_plane_prediction(*args))
    onehot = ((pred_seg[..., None] == np.arange(5)).astype(np.float32),
              (gt_seg[..., None] == np.arange(4)).astype(np.float32), pred_depth, gt_depth)
    _same(plane.eval_plane_prediction(*onehot), jplane.eval_plane_prediction(*onehot))
    for masks in (True, gt_seg != 20):
        args = (pred_depth, gt_depth, gt_depth > 1e-4, masks)
        _same(plane.evaluate_depths(*args), jplane.evaluate_depths(*args))
    args = (pred_seg, gt_seg, params, gt_params)
    _same(plane.eval_plane_and_pixel_recall_normal(*args),
          jplane.eval_plane_and_pixel_recall_normal(*args))


def test_fit_plane_colorize_and_cameras_bit_equal():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(500, 3)) + np.asarray([0.0, 0.0, 3.0])
    _same(fit_plane(pts), jfit_plane(pts))
    depth = rng.uniform(0.0, 10.0, (48, 64)).astype(np.float32)
    normal = rng.uniform(-1, 1, (48, 64, 3)).astype(np.float32)
    _same(colorize.colorize_depth(depth), jcolorize.colorize_depth(depth))
    _same(colorize.colorize_idepth(1 / depth), jcolorize.colorize_idepth(1 / depth))
    _same(colorize.colorize_prob(depth / 10), jcolorize.colorize_prob(depth / 10))
    _same(colorize.normal_to_color(normal), jcolorize.normal_to_color(normal))
    E = np.eye(4)
    E[:3, 3] = [0.1, -0.2, 0.3]
    K = np.asarray([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    for extra in ((), (0.5, 0.01)):
        text = cameras.write_cam_text(E, K, *extra)
        assert text == jcameras.write_cam_text(E, K, *extra)
        _same(cameras.load_cam_text(text), jcameras.load_cam_text(text))
    cam = cameras.make_cam_array(E, K)
    _same(cam, jcameras.make_cam_array(E, K))
    _same(cameras.scale_cam_array(cam, 0.5, 0.25), jcameras.scale_cam_array(cam, 0.5, 0.25))
