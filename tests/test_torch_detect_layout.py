"""The port's ``data/detect.py`` and ``data/layout.py`` against the JAX
package's, on the cases of ``tests/test_detect_layout.py``: every output
equal (both are numpy; the port's are copies)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from cnmnet_tpu.data import detect as jdetect  # noqa: E402
from cnmnet_tpu.data import layout as jlayout  # noqa: E402
from cnmnet_tpu.data.prep import plane_depth_map as jplane_depth_map  # noqa: E402
from cnmnet_tpu_torch.data import detect, layout  # noqa: E402

H, W = 96, 128
K = np.array([[100.0, 0.0, 64.0], [0.0, 100.0, 48.0], [0.0, 0.0, 1.0]])
K_INV = np.linalg.inv(K)


def assert_same(a, b, where="out"):
    """Equal values of equal types, through tuples, lists and dicts."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), where
        for k in b:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (where, a, b)


def _masks(d):
    rng = np.random.default_rng(0)
    masks = np.zeros((17, 23, 5), dtype=np.uint8)
    for i in range(4):
        y1, x1 = rng.integers(0, 10, 2)
        h, w = rng.integers(2, 7, 2)
        masks[y1:y1 + h, x1:x1 + w, i] = 1
    return d.masks_to_boxes(masks)


def _iou(d):
    a = np.array([[0, 0, 10, 10], [0, 0, 4, 4]], dtype=np.float64)
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 22, 22]], np.float64)
    return d.pairwise_iou(a, b), d.box_area(b)


def _refine(d):
    rng = np.random.default_rng(1)
    y1x1 = rng.uniform(0, 50, (8, 2))
    hw = rng.uniform(5, 40, (8, 2))
    boxes = np.concatenate([y1x1, y1x1 + hw], axis=-1)
    gt = boxes + rng.uniform(-3, 3, boxes.shape)
    gt[:, 2:] = np.maximum(gt[:, 2:], gt[:, :2] + 1.0)
    deltas = d.box_refinement(boxes, gt)
    return deltas, d.apply_box_deltas(boxes, deltas)


def _nms(d):
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]], dtype=np.float64)
    return d.non_max_suppression(boxes, np.array([0.9, 0.8, 0.7]), 0.3)


def _anchors(d):
    return (d.generate_anchors(scales=8.0, ratios=[0.5, 1.0, 2.0], feature_shape=(4, 5),
                               feature_stride=16),
            d.generate_pyramid_anchors([8, 16], [1.0], [(4, 4), (2, 2)], [16, 32]))


def _resize(d):
    img = np.arange(20 * 30 * 3, dtype=np.float64).reshape(20, 30, 3)
    out, window, scale, pad = d.resize_image(img, min_dim=40, max_dim=64, padding=True)
    mask = np.zeros((20, 30, 1), dtype=np.uint8)
    mask[5:10, 5:15, 0] = 1
    return out, window, scale, pad, d.resize_mask(mask, scale, pad)


def _mini(d):
    mask = np.zeros((48, 64, 1), dtype=np.uint8)
    mask[10:30, 20:52, 0] = 1
    boxes = d.masks_to_boxes(mask)
    mini = d.minimize_mask(boxes, mask, (16, 16))
    back = d.expand_mask(boxes[0], mini[:, :, 0], (48, 64))
    depth = np.linspace(1.0, 4.0, 48 * 64).reshape(48, 64)
    return mini, back, d.minimize_depth(boxes, depth, (8, 8))


def _meta(d):
    meta = d.compose_image_meta(7, (48, 64, 3), (0, 0, 48, 64), [1, 0, 1])
    img = np.random.default_rng(2).integers(0, 255, (8, 8, 3)).astype(np.float32)
    mean = [123.7, 116.8, 103.9]
    molded = d.mold_image(img, mean)
    return meta, d.parse_image_meta(meta), molded, d.unmold_image(molded, mean)


DETECT_CASES = {"masks_to_boxes": _masks, "iou": _iou, "refinement": _refine, "nms": _nms,
                "anchors": _anchors, "resize": _resize, "minimize": _mini, "meta": _meta}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detect_equals_jax(case):
    assert_same(DETECT_CASES[case](detect), DETECT_CASES[case](jdetect))


def _room(with_object=False):
    """``tests/test_detect_layout.py``'s room corner: floor, back wall, left
    wall, optionally a small occluder."""
    planes = np.array([[0.0, 1.5, 0.0], [0.0, 0.0, 4.0], [-2.0, 0.0, 0.0]])
    labels = [1, 2, 2]
    pd = jplane_depth_map(planes, K_INV, H, W)
    pd_pos = np.where(pd > 1e-4, pd, np.inf)
    seg = pd_pos.argmin(axis=0).astype(np.int64)
    depth = pd_pos.min(axis=0)
    if with_object:
        planes = np.concatenate([planes, [[0.0, 0.0, 1.0]]])
        labels = labels + [0]
        obj_mask = np.zeros((H, W), dtype=bool)
        obj_mask[40:50, 60:72] = True
        closer = obj_mask & (1.0 < depth)
        depth = np.where(closer, 1.0, depth)
        seg = np.where(closer, 3, seg)
    return planes, labels, depth, seg


def _hull(m):
    planes, labels, depth, seg = _room()
    return m.extract_layout(planes, depth, seg, K_INV, labels, layout_labels={1, 2})


def _occluder(m):
    planes, labels, depth, seg = _room(with_object=True)
    return m.extract_layout(planes, depth, seg, K_INV, labels, layout_labels={1, 2})


def _single(m):
    planes, labels, depth, seg = _room()
    return m.extract_layout(planes, depth, seg, K_INV, labels, layout_labels={1})


def _none(m):
    planes, labels, depth, seg = _room()
    return m.extract_layout(planes, depth, seg, K_INV, labels, layout_labels={9})


def _relations(m):
    pairs = (([[0.0, 0.0, 4.0], [-2.0, 0.0, 0.0]], [[0.0, 0.0, 4.0], [-2.0, 0.0, 2.0]]),
             ([[0.0, 0.0, 4.0], [0.0, 0.1, 5.0]], [[0.0, 0.0, 4.0], [0.0, 0.0, 5.0]]),
             ([[0.0, 0.0, 2.0], [1.0, 0.0, 0.0]], [[2.0, 0.0, 2.0], [1.0, 0.0, 3.0]]))
    return [m.pairwise_plane_relations(np.array(p), np.array(a)) for p, a in pairs]


PLANE_INFO = [[(0, 1)], [(1, 2), (5,)], [(2, 2), (5,)]]


def _structures(m):
    planes, _, depth, seg = _room()
    return m.group_structures(planes, PLANE_INFO, seg, depth, K_INV)


def _structures_bad_depth(m):
    planes, _, depth, seg = _room()
    bad = depth + np.where((seg == 1) | (seg == 2), 1.0, 0.0)
    return m.group_structures(planes, PLANE_INFO, seg, bad, K_INV)


LAYOUT_CASES = {"hull": _hull, "occluder": _occluder, "single_plane": _single,
                "no_candidates": _none, "relations": _relations, "structures": _structures,
                "structures_bad_depth": _structures_bad_depth}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_equals_jax(case):
    got, want = LAYOUT_CASES[case](layout), LAYOUT_CASES[case](jlayout)
    assert_same(got, want)


def test_layout_cases_are_not_empty():
    """The room cases reach the code they are meant to: a three-band hull,
    a two-plane structure, and its demotion under corrupted depth."""
    _, boundaries = _hull(layout)
    assert set(boundaries) == {(0, 1), (0, 2), (1, 2)}
    assert set(_structures(layout)) == {0, 1}
    assert set(_structures_bad_depth(layout)) == {0}
    assert layout.REL_CONVEX == jlayout.REL_CONVEX and layout.REL_CONCAVE == jlayout.REL_CONCAVE
