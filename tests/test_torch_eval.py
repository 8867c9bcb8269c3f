"""The port's eval loops against the JAX package's, on the CPU.

* A mock 7-Scenes tree written with cv2 (the fixture of ``test_eval.py``:
  40 frames of a textured image at 480x640, 16-bit depth of 2.5 m with a
  65535 patch, a translating camera; here two sequences). The loader must
  give the JAX loader's frames on both wires, equal.
* The same oracle forward values (constant per frame, so both bilinear
  resizes keep them exactly) go through both packages'
  ``evaluate_seven_scenes`` for all four protocols: equal metrics (``==``),
  equal frame census and equal ``.npy`` artifacts.
* The port's ``cal_metrics`` re-scores a JAX artifact tree within 1e-6
  relative, from the saved GT and from the dataset's PNGs.
* The real forward: JAX ``make_eval_forward`` with flax variables against
  the port's with the same weights (``load_flax_variables``) at 32x64, 8
  planes, k = 5, three 3-view frames (at 48x64 the JAX DepthNet's skip
  concatenation fails: 48 does not halve five times). idepth agrees within the 3-view
  pipeline's 7.2e-4 (ROADMAP tolerances), the nine metrics within 1e-3
  relative, or 1e-4 absolute for the ratio metrics a1-a3.
* The ScanNet depth and plane evals take the same oracle on
  ``SyntheticScenes`` in both packages: equal metrics.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.config import Config as JConfig  # noqa: E402
from cnmnet_tpu.data.seven_scenes import SevenScenes as JSevenScenes  # noqa: E402
from cnmnet_tpu.data.synthetic import SyntheticScenes as JScenes  # noqa: E402
from cnmnet_tpu.evals import cal_metrics as jcal  # noqa: E402
from cnmnet_tpu.evals import scannet_eval as jscannet  # noqa: E402
from cnmnet_tpu.evals import seven_scenes_eval as jeval  # noqa: E402
from cnmnet_tpu.ops.images import prepare_images as jprepare  # noqa: E402
from cnmnet_tpu.train import state as jstate  # noqa: E402
from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.data.seven_scenes import SevenScenes  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu_torch.evals import cal_metrics as tcal  # noqa: E402
from cnmnet_tpu_torch.evals import scannet_eval as tscannet  # noqa: E402
from cnmnet_tpu_torch.evals import seven_scenes_eval as teval  # noqa: E402
from cnmnet_tpu_torch.models.transplant import flatten, load_flax_variables  # noqa: E402
from cnmnet_tpu_torch.train.state import build_model  # noqa: E402

SEQS = [("chess", "seq-03"), ("fire", "seq-04")]
H, W = 48, 64
RH, RW = 32, 64  # the real forward's size
METRICS = ("l1", "abs_rel", "sq_rel", "rmse", "rmse_log", "scale_inv", "a1", "a2", "a3")


@pytest.fixture(scope="module")
def seven_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("seven")
    rng = np.random.default_rng(0)
    img = (rng.random((480, 640, 3)) * 255).astype(np.uint8)
    for s, (scene, seq) in enumerate(SEQS):
        seq_dir = root / scene / seq
        seq_dir.mkdir(parents=True)
        for i in range(40):
            name = f"frame-{i:06d}"
            cv2.imwrite(str(seq_dir / f"{name}.color.png"), np.roll(img, 3 * s, 1))
            d = np.full((480, 640), 2500 + 100 * s, np.uint16)
            d[:10, :10] = 65535  # invalid marker region
            cv2.imwrite(str(seq_dir / f"{name}.depth.png"), d)
            pose = np.eye(4)
            pose[0, 3] = 0.01 * i  # slowly translating camera
            np.savetxt(str(seq_dir / f"{name}.pose.txt"), pose, delimiter="\t ")
    return str(root)


def _oracle_value(cams):
    """Per-frame constant inverse depth, varying with the ref camera's x
    translation so that a batching or ordering fault changes the metrics."""
    tx = np.asarray(cams)[:, 0, 0, 0, 3]
    return (np.float32(1 / 2.5) + np.float32(0.001) * tx).astype(np.float32)


def _oracle(kind):
    def fn(images, cams):
        B, _, h, w, _ = images.shape
        idepth = np.broadcast_to(_oracle_value(cams)[:, None, None, None], (B, h, w, 1))
        prob = np.full((B, h, w, 1), 0.5, np.float32)
        normal = np.zeros((B, h, w, 3), np.float32)
        normal[..., 2] = 1.0
        if kind == "jax":
            return jnp.asarray(idepth), jnp.asarray(prob), jnp.asarray(normal)
        return torch.from_numpy(np.ascontiguousarray(idepth)), torch.from_numpy(prob), \
            torch.from_numpy(normal)

    return fn


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_seven_scenes_loader_matches_jax(seven_root, wire):
    ours, theirs = SevenScenes(seven_root, H, W, wire), JSevenScenes(seven_root, H, W, wire)
    assert ours.test_seqs_list == theirs.test_seqs_list
    paths = ours.frame_paths(*SEQS[1])
    assert paths == theirs.frame_paths(*SEQS[1]) and len(paths) == 40
    assert ours.frame_paths("heads", "seq-01") == []
    for p in (paths[0], paths[17]):
        got, want = ours.load_frame(p), theirs.load_frame(p)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert ours.load_frame(paths[3], with_depth=False)[1] is None


def _npy_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            out[rel] = np.load(os.path.join(dirpath, f)) if f.endswith(".npy") else None
    return out


@pytest.mark.parametrize("frame_batch", [1, 4])
@pytest.mark.parametrize("num_sources", [1, 2, 4, 6])
def test_oracle_protocols_match_jax(seven_root, tmp_path, num_sources, frame_batch):
    kw = dict(num_sources=num_sources, image_height=H, image_width=W, seqs=SEQS,
              frame_batch=frame_batch)
    got = teval.evaluate_seven_scenes(_oracle("torch"), seven_root,
                                      save_dir=str(tmp_path / "torch"), **kw)
    want = jeval.evaluate_seven_scenes(_oracle("jax"), seven_root,
                                       save_dir=str(tmp_path / "jax"), **kw)
    assert got["frames"] == want["frames"] == 2 * len(teval.protocol_frame_indices(num_sources, 40))
    got.pop("seconds_per_frame")
    want.pop("seconds_per_frame")
    assert got == want
    assert got["abs_rel"] < 0.05 and np.isfinite(list(got.values())).all()
    ours, theirs = _npy_tree(tmp_path / "torch"), _npy_tree(tmp_path / "jax")
    assert ours.keys() == theirs.keys()
    assert sum(v is not None for v in ours.values()) == 4 * got["frames"]
    for name, arr in ours.items():
        if arr is None:  # a png: same pixels, another encoder
            a = cv2.imread(str(tmp_path / "torch" / name), -1)
            np.testing.assert_array_equal(a, cv2.imread(str(tmp_path / "jax" / name), -1))
        else:
            assert arr.dtype == theirs[name].dtype
            np.testing.assert_array_equal(arr, theirs[name])


def test_protocol_tables_and_aggregate_match_jax():
    assert teval.EVAL_PROTOCOLS == jeval.EVAL_PROTOCOLS
    for s in (1, 2, 4, 6):
        for n in (40, 100, 1000):
            assert teval.protocol_frame_indices(s, n) == jeval.protocol_frame_indices(s, n)
    frames = [{"l1": 1.0, "rmse": 2.0}, {"l1": 3.0, "rmse": 4.5}]
    assert teval.aggregate_metrics(frames) == jeval.aggregate_metrics(frames)
    assert teval.aggregate_metrics([]) == {}


def test_logger_and_skipped_frames(seven_root, tmp_path):
    """A missing GT depth and an invalid pose skip their reference frames in
    both packages, and the logger gets the running aggregate after each
    sequence."""
    import shutil

    root = tmp_path / "partial"
    shutil.copytree(seven_root, root)
    os.remove(root / "chess" / "seq-03" / "frame-000015.depth.png")
    np.savetxt(str(root / "chess" / "seq-03" / "frame-000031.pose.txt"), np.full((4, 4), np.nan))
    logged = {"torch": [], "jax": []}

    class Logger:
        def __init__(self, kind):
            self.kind = kind

        def log_scalars(self, step, scalars, prefix=""):
            logged[self.kind].append((step, prefix, scalars))

    kw = dict(num_sources=2, image_height=H, image_width=W, seqs=SEQS)
    got = teval.evaluate_seven_scenes(_oracle("torch"), str(root), logger=Logger("torch"), **kw)
    want = jeval.evaluate_seven_scenes(_oracle("jax"), str(root), logger=Logger("jax"), **kw)
    assert got["frames"] == want["frames"] == 2 * 6 - 2  # 15, and 21 (source 31)
    assert [x[:2] for x in logged["torch"]] == [x[:2] for x in logged["jax"]]
    assert [x[2] for x in logged["torch"]] == [x[2] for x in logged["jax"]]


@pytest.fixture(scope="module")
def jax_artifacts(seven_root, tmp_path_factory):
    save = tmp_path_factory.mktemp("artifacts")

    def biased(images, cams):
        B, _, h, w, _ = images.shape
        idepth = jnp.full((B, h, w, 1), 1.0 / 3.0) + 0.01 * jnp.asarray(_oracle_value(cams))[
            :, None, None, None]
        return idepth, None, None

    inline = jeval.evaluate_seven_scenes(biased, seven_root, num_sources=2, image_height=H,
                                         image_width=W, max_frames_per_seq=3, seqs=SEQS,
                                         save_dir=str(save))
    return str(save), inline


@pytest.mark.parametrize("gt_source", ["npy", "png"])
def test_cal_metrics_rescores_jax_artifacts(jax_artifacts, seven_root, gt_source):
    save, inline = jax_artifacts
    gt_root = seven_root if gt_source == "png" else None
    got = tcal.cal_metrics(save, gt_root=gt_root, write_txt=False)
    want = jcal.cal_metrics(save, gt_root=gt_root, write_txt=False)
    assert got["frames"] == want["frames"] == inline["frames"] == 6
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k
        assert got[k] == pytest.approx(inline[k], rel=5e-3, abs=1e-3), k
    assert tcal._REFERENCE_LABELS == jcal._REFERENCE_LABELS


def test_cal_metrics_writes_the_reference_file(jax_artifacts, tmp_path):
    import shutil

    save, _ = jax_artifacts
    mine, theirs = tmp_path / "torch", tmp_path / "jax"
    shutil.copytree(save, mine)
    shutil.copytree(save, theirs)
    tcal.cal_metrics(str(mine))
    jcal.cal_metrics(str(theirs))
    text = (mine / "evaluation_errors.txt").read_text()
    assert [line.split(":")[0] for line in text.strip().split("\n")] == [
        "mean_l1_error", "a<1.25", "a<1.25^2", "a<1.25^3",
        "abs.rel", "sq.rel", "rmse", "rmse log", "scale.inv",
    ]
    assert text == (theirs / "evaluation_errors.txt").read_text()


def _cfg(cls):
    cfg = cls()
    cfg.model.num_planes = 8
    cfg.model.k_size = 5
    cfg.dataset.image_height, cfg.dataset.image_width = RH, RW
    return cfg


@pytest.fixture(scope="module")
def forwards():
    """(JAX eval forward, port eval forward) with the same weights; the
    disparity heads' kernels are scaled by 0.05 so that their sigmoids are
    not saturated at He-normal scale (``test_torch_train.py``)."""
    jcfg = _cfg(JConfig)
    model = jstate.build_model(jcfg)
    ds = JScenes(num_samples=1, height=RH, width=RW, view_num=3)
    images = jnp.asarray(ds[0]["images"])[None]
    cams = jnp.asarray(ds[0]["cams"])[None]
    variables = model.init(jax.random.PRNGKey(0), jprepare(images), cams, train=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    params = variables["params"]
    for path, leaf in flatten({"params": params}).items():
        if "DispHead" in path and path.endswith("kernel"):
            node = params
            for part in path.split("/")[1:-1]:
                node = node[part]
            node["kernel"] = (leaf * np.float32(0.05)).astype(np.float32)
    jfwd = jeval.make_eval_forward(model, jax.tree_util.tree_map(jnp.asarray, variables), k_size=5)
    port = build_model(_cfg(Config))
    load_flax_variables(port, variables)
    return jfwd, teval.make_eval_forward(port, k_size=5, device="cpu")


def test_real_forward_matches_jax(seven_root, forwards):
    jfwd, tfwd = forwards
    ds = SevenScenes(seven_root, RH, RW)
    paths = ds.frame_paths(*SEQS[0])
    frames = [[ds.load_frame(paths[i + o]) for o in (0, 10, -10)] for i in (12, 15, 18)]
    images = np.stack([[v[0] for v in f] for f in frames])
    cams = np.stack([[v[2] for v in f] for f in frames])
    want = [np.asarray(o) for o in jfwd(images, cams)]
    got = tfwd(images, cams)
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu" for o in got)
    assert got[0].shape == (3, RH, RW, 1) and got[1].shape == (3, RH, RW, 1)
    assert got[2].shape == (3, RH, RW, 3)
    assert np.abs(got[0].numpy() - want[0]).max() <= 7.2e-4
    assert np.abs(got[1].numpy() - want[1]).max() <= 7.2e-4
    two = tfwd(images[:, :2], cams[:, :2])  # 2 views: disp1, no prob
    assert two[1] is None and two[0].shape == (3, RH, RW, 1)
    np.testing.assert_allclose(two[0].numpy(), np.asarray(jfwd(images[:, :2], cams[:, :2])[0]),
                               atol=7.2e-4, rtol=0)

    kw = dict(num_sources=2, image_height=RH, image_width=RW, max_frames_per_seq=3,
              seqs=SEQS[:1])
    got_m = teval.evaluate_seven_scenes(tfwd, seven_root, **kw)
    want_m = jeval.evaluate_seven_scenes(jfwd, seven_root, **kw)
    assert got_m["frames"] == want_m["frames"] == 3
    for k in METRICS:
        tol = dict(abs=1e-4) if k in ("a1", "a2", "a3") else dict(rel=1e-3)
        assert got_m[k] == pytest.approx(want_m[k], **tol), k


def test_eval_forward_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        teval.make_eval_forward(build_model(_cfg(Config)))  # the default device is cuda


def _scannet_oracle(samples, kind, scale):
    queue = list(samples)

    def fn(images, cams):
        d = np.maximum(np.asarray(queue.pop(0)["depths"][0]), 1e-3) * scale
        idepth = (1.0 / d)[None, ..., None]
        return jnp.asarray(idepth) if kind == "jax" else (torch.from_numpy(idepth), None, None)

    return fn


class _WithNonPlanar:
    """Scenes whose top rows have no GT depth, so that every plane label
    map holds the non-planar label (a synthetic room is planar everywhere)."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        s = dict(self.scenes[i])
        s["depths"] = s["depths"].copy()
        s["depths"][:, :6] = 0.0
        return s


@pytest.mark.parametrize("scale", [1.0, 1.3])
def test_scannet_evals_match_jax(scale):
    ours = _WithNonPlanar(SyntheticScenes(num_samples=3, height=H, width=W, view_num=3))
    theirs = _WithNonPlanar(JScenes(num_samples=3, height=H, width=W, view_num=3))
    samples = [ours[i] for i in range(3)]
    got = tscannet.evaluate_scannet(_scannet_oracle(samples, "torch", scale), ours)
    want = jscannet.evaluate_scannet(_scannet_oracle(samples, "jax", scale), theirs)
    assert got == want and got["frames"] == 3
    got = tscannet.evaluate_scannet_planes(_scannet_oracle(samples, "torch", scale), ours)
    want = jscannet.evaluate_scannet_planes(_scannet_oracle(samples, "jax", scale), theirs)
    assert got == want and got["frames"] == 3
    if scale == 1.0:
        assert got["plane_recall_normal_10deg"] > 0.9 and got["plane_rel"] < 0.02
        assert got["pixel_recall_depth_10cm"] == 1.0
    else:
        assert got["pixel_recall_depth_10cm"] < 0.5 and got["plane_rel"] > 0.2
    np.testing.assert_array_equal(
        tscannet._backproject(samples[0]["depths"][0], samples[0]["cams"][0, 1, :3, :3]),
        jscannet._backproject(samples[0]["depths"][0], samples[0]["cams"][0, 1, :3, :3]))


def test_scannet_plane_eval_on_all_planar_samples():
    """Sample 2 of these scenes lies on one plane everywhere: the JAX
    function's label-map call finds no plane there and raises; the port's
    scores it (an oracle: every plane pixel within 10 cm)."""
    scenes = SyntheticScenes(num_samples=4, height=H, width=W, view_num=3, seed=17)
    jscenes = JScenes(num_samples=4, height=H, width=W, view_num=3, seed=17)
    samples = [scenes[i] for i in range(4)]
    with pytest.raises(ValueError, match="zero-size"):
        jscannet.evaluate_scannet_planes(_scannet_oracle(samples, "jax", 1.0), jscenes)
    got = tscannet.evaluate_scannet_planes(_scannet_oracle(samples, "torch", 1.0), scenes)
    assert got["frames"] == 4 and got["pixel_recall_depth_10cm"] == 1.0
    assert got["plane_rel"] < 0.02
