"""Serving, evaluation and the command line on a mesh of processes (gloo).

``tests/_torch_tiled_worker.py`` processes join one gloo process group:

* ``InferenceSession(mesh=)`` at 2 x 1 (32x64) and 1 x 2 (128x32), rank 0
  answering ``predict`` and a ``MicroBatcher``, rank 1 in ``follow()``,
  against the one-process session (f64 compute, f32 wire: within 1e-6
  relative, measured 0 to 1.5e-8). Buckets round up to the data axis:
  ``(1, 4)`` becomes ``(2, 4)`` at 2 data ranks, as it becomes ``(4,)`` at
  JAX's ``data=4`` (``tests/test_multichip.py``). A tile axis at a height
  that JAX's ``tile_partition_safe`` refuses is refused, as in JAX.
* ``cli eval --eval-tile 2`` over the two processes on a mock 7-Scenes tree
  (128x64) against the one-process eval: the same frames and metrics
  within 1e-6 relative (measured 0); ``cli train parallel.tile_axis=2`` for
  one step.
* The tiled 7-Scenes eval over a 2 x 2 mesh (four processes) at 128x128
  against JAX's ``evaluate_seven_scenes(mesh=make_mesh(data=2, tile=2))``
  on the virtual CPU mesh with the same weights, at
  ``tests/test_multichip.py``'s tolerance (1e-4 relative, 1e-6 absolute).

Each group of workers runs once for the module under a 300 s timeout.
"""

import pickle

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.config import Config as JConfig  # noqa: E402
from cnmnet_tpu.data.synthetic import SyntheticScenes as JScenes  # noqa: E402
from cnmnet_tpu.evals import seven_scenes_eval as jeval  # noqa: E402
from cnmnet_tpu.ops.images import prepare_images as jprepare  # noqa: E402
from cnmnet_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from cnmnet_tpu.train import state as jstate  # noqa: E402
from cnmnet_tpu_torch.data.imageio import write_png  # noqa: E402
from cnmnet_tpu_torch.models.transplant import flatten  # noqa: E402
from test_torch_tiled_mesh import collect, launch  # noqa: E402

METRICS = ("l1", "abs_rel", "sq_rel", "rmse", "rmse_log", "scale_inv", "a1", "a2", "a3")


def write_seven(root):
    """A mock 7-Scenes sequence, chess/seq-03: 40 frames of 96x128, a
    textured image, 2.5 m depth, a camera moving 1 cm a frame (the tree of
    ``tests/test_multichip.py``)."""
    seq = root / "chess" / "seq-03"
    seq.mkdir(parents=True)
    rng = np.random.default_rng(0)
    img = (rng.random((96, 128, 3)) * 255).astype(np.uint8)
    for i in range(40):
        name = seq / f"frame-{i:06d}"
        write_png(f"{name}.color.png", img)
        write_png(f"{name}.depth.png", np.full((96, 128), 2500, np.uint16))
        pose = np.eye(4)
        pose[0, 3] = 0.01 * i
        np.savetxt(f"{name}.pose.txt", pose, delimiter="\t ")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve2")
    write_seven(out / "seven")
    return collect(launch(2, out, ["serve", "cli"]), out)


def _jax_model():
    """The JAX model at 128x128 (8 planes, k = 5) and its variables, the
    disparity heads' kernels scaled by 0.05 (``tests/test_torch_eval.py``)."""
    cfg = JConfig()
    cfg.model.num_planes, cfg.model.k_size = 8, 5
    cfg.dataset.image_height = cfg.dataset.image_width = 128
    model = jstate.build_model(cfg)
    ds = JScenes(num_samples=1, height=128, width=128, view_num=3)
    variables = model.init(jax.random.PRNGKey(0), jprepare(jnp.asarray(ds[0]["images"])[None]),
                           jnp.asarray(ds[0]["cams"])[None], train=False)
    variables = jax.tree_util.tree_map(np.array, dict(variables))
    params = variables["params"]
    for path, leaf in flatten({"params": params}).items():
        if "DispHead" in path and path.endswith("kernel"):
            node = params
            for part in path.split("/")[1:-1]:
                node = node[part]
            node["kernel"] = (leaf * np.float32(0.05)).astype(np.float32)
    return model, variables


@pytest.fixture(scope="module")
def eval22(tmp_path_factory):
    """(the port's metrics from each of four ranks, JAX's metrics)."""
    out = tmp_path_factory.mktemp("eval4")
    write_seven(out / "seven")
    model, variables = _jax_model()
    with open(out / "variables.pkl", "wb") as f:
        pickle.dump(variables, f)
    procs = launch(4, out, ["eval22"])
    fwd = jeval.make_eval_forward(model, jax.tree_util.tree_map(jnp.asarray, variables),
                                  k_size=5)
    want = jeval.evaluate_seven_scenes(
        fwd, str(out / "seven"), num_sources=2, image_height=128, image_width=128,
        max_frames_per_seq=6, seqs=[("chess", "seq-03")], frame_batch=2,
        mesh=j_make_mesh(data=2, tile=2, devices=jax.devices()[:4]))
    return [r["eval22"] for r in collect(procs, out)], want


@pytest.mark.parametrize("shape,buckets", [("2x1", [2, 4]), ("1x2", [1, 4])])
def test_mesh_session_matches_the_one_process_session(two, shape, buckets):
    lead, follower = two[0]["serve"][shape], two[1]["serve"][shape]
    assert lead["buckets"] == buckets
    assert follower["served"] >= 2  # predict's batch and the batcher's
    for k, v in lead["diff"].items():
        assert v <= 1e-6, (k, v)
    assert lead["batcher"] <= 1e-6


def test_mesh_session_refuses_an_unsafe_tile_height(two):
    assert two[0]["serve"]["1x2"]["refused"].startswith("unsafe tile axis for serving")
    assert two[0]["serve"]["2x1"]["refused"] == ""


def test_cli_eval_with_eval_tile_over_two_processes(two):
    for r in two:
        assert r["cli"]["lines"] == ["eval mesh: data=1 tile=2"]
    got = two[0]["cli"]
    assert got["frames"][0] == got["frames"][1] == 3
    for k, v in got["metrics"].items():
        assert v <= 1e-6, (k, v)


def test_cli_train_with_a_tile_axis_over_two_processes(two):
    assert [r["cli"]["train"] for r in two] == [["1"], ["1"]]


def test_tiled_eval_over_data_and_tile_matches_jax(eval22):
    ranks, want = eval22
    assert all(r == ranks[0] for r in ranks)  # every rank returns the whole run's metrics
    assert ranks[0]["frames"] == want["frames"] == 6
    for k in METRICS:
        assert ranks[0][k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
