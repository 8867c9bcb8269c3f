"""The port over real processes: the tile and data axes through the ops,
the train step, serving, evaluation and the command line (gloo on the CPU).

Two groups of ranks, one of two processes and one of four, each started
once for the module by ``cnmnet_tpu_torch/tools/_ranks.run_calls``, run
the phases of ``tests/_torch_rank_phases.py`` (8 planes, k = 5) and hold
the collective paths to the one-process computation on the global data:

* over a 1 x 2 mesh: the row fetch of a halo and both tiled ops at 64x64,
  bit-equal to the untiled port ops' rows; the row fetch, forward and
  backward, at an uneven split (exact, on integer values);
  ``depth_to_normal_tiled`` bit-equal and its gradient across the halo
  within 1e-12 (f64); the tiled cost volume bit-equal; a stride-2 block
  and an upsampling block under ``spatial_parallel``, BatchNorm summed
  over the ranks, within 1e-12 forward and gradient;
* one f64 train step at 64x32 over a 2 x 1 mesh, with ``grad_accum=2``
  too; over a 1 x 2 mesh, also at 96x32 (3 rows at 1/32, split 1/2), with
  ``remat_stages=2`` and with ``grad_accum=2``; and over a 2 x 2 mesh, whose
  ranks hold different numbers of valid ground-truth pixels (the hazard of
  averaging per-rank masked means), against the one-process step on the
  global batch, computed once for each shape and config (the remat step
  against the plain one): the loss terms and ``grad_norm`` within 1e-10
  relative, the gradients within 1e-9 in relative L2, every BatchNorm
  running statistic within 1e-12 (variance relative, mean relative to the
  running standard deviation), ``num_batches_tracked`` equal, the updated
  parameters within 1e-8. The steps run in f64 (``one_step`` says why);
* ``InferenceSession(mesh=)`` at 2 x 1 (32x64) and 1 x 2 (128x32), rank 0
  answering ``predict`` and a ``MicroBatcher``, rank 1 in ``follow()``,
  against the one-process session (f64 compute, f32 wire: within 1e-6
  relative). Buckets round up to the data axis: ``(1, 4)`` becomes
  ``(2, 4)`` at 2 data ranks, as it becomes ``(4,)`` at JAX's ``data=4``
  (``tests/test_multichip.py``). A tile axis at a height that JAX's
  ``tile_partition_safe`` refuses is refused, as in JAX;
* ``cli train`` with ``parallel.coordinator_address``: two steps into one
  shared checkpoint directory, then a resume to step 3 on both ranks;
  ``cli eval --eval-tile 2`` on a mock 7-Scenes tree (128x64) against the
  one-process eval, the same frames and metrics within 1e-6 relative;
  ``cli train parallel.tile_axis=2`` for one step;
* the tiled 7-Scenes eval over a 2 x 2 mesh (four processes) at 128x128
  against JAX's ``evaluate_seven_scenes(mesh=make_mesh(data=2, tile=2))``
  on the virtual CPU mesh with the same weights, at
  ``tests/test_multichip.py``'s tolerance (1e-4 relative, 1e-6 absolute).

The groups run one after the other while this process computes the JAX
side; each is lent ``THREADS`` threads, shared among its ranks, and fails
these tests instead of stalling the suite if it runs past ``TIMEOUT``. One
phase runs alone, with ``tests`` on ``PYTHONPATH``, as
``_ranks.run_calls(2, [(_torch_rank_phases.tiled_ops, ())], device="cpu")``.
The JAX package's own two-process test is ``tests/test_distributed.py``.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_rank_phases as phases  # noqa: E402
from cnmnet_tpu.config import Config as JConfig  # noqa: E402
from cnmnet_tpu.data.synthetic import SyntheticScenes as JScenes  # noqa: E402
from cnmnet_tpu.evals import seven_scenes_eval as jeval  # noqa: E402
from cnmnet_tpu.ops.images import prepare_images as jprepare  # noqa: E402
from cnmnet_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from cnmnet_tpu.train import state as jstate  # noqa: E402
from cnmnet_tpu_torch.data.imageio import write_png  # noqa: E402
from cnmnet_tpu_torch.models.transplant import flatten  # noqa: E402
from cnmnet_tpu_torch.tools import _ranks  # noqa: E402

TIMEOUT = 600
THREADS = 4  # lent to each group: two a rank of two, one a rank of four
METRICS = ("l1", "abs_rel", "sq_rel", "rmse", "rmse_log", "scale_inv", "a1", "a2", "a3")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, THREADS))
    yield
    torch.set_num_threads(saved)


def run_group(world, calls):
    """``calls`` (name -> (fn, args)) over one group of ``world`` gloo
    ranks: each rank's results, by name."""
    out = _ranks.run_calls(world, list(calls.values()), device="cpu", timeout=TIMEOUT)
    return [{name: out[i][r] for i, name in enumerate(calls)} for r in range(world)]


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
def groups(tmp_path_factory):
    """The two groups, one after the other on a second thread, as futures of
    each rank's results by phase, and JAX's 7-Scenes metrics, computed on
    this thread while the ranks run."""
    out = tmp_path_factory.mktemp("ranks")
    write_seven(out / "seven")
    with ThreadPoolExecutor(1) as pool:
        two = pool.submit(run_group, 2, {
            "halo_ops": (phases.halo_ops, ()),
            "tiled_ops": (phases.tiled_ops, ()),
            "references": (phases.references, ({"even": 0, "uneven": 0, "even_accum": 1},)),
            "data_step": (phases.step, ("even", 2, 1)),
            "data_accum": (phases.step, ("even_accum", 2, 1)),
            "step64": (phases.step, ("even", 1, 2)),
            "step96": (phases.step, ("uneven", 1, 2)),
            "remat": (phases.step, ("even", 1, 2, None, {"remat": True, "remat_stages": 2})),
            "accum": (phases.step, ("even_accum", 1, 2, phases.ACCUM_ORDER)),
            "serve": (phases.serve, ()),
            "cli_train": (phases.cli_train, (str(out / "train"),)),
            "cli_tile": (phases.cli_tile, (str(out),)),
        })
        model, variables = _jax_model()
        with open(out / "variables.pkl", "wb") as f:
            pickle.dump(variables, f)
        four = pool.submit(run_group, 4, {
            "references": (phases.references, ({"even": 0},)),
            "step22": (phases.step, ("even", 2, 2)),
            "eval22": (phases.eval22, (str(out),)),
        })
        fwd = jeval.make_eval_forward(model, jax.tree_util.tree_map(jnp.asarray, variables),
                                      k_size=5)
        want = jeval.evaluate_seven_scenes(
            fwd, str(out / "seven"), num_sources=2, image_height=128, image_width=128,
            max_frames_per_seq=6, seqs=[("chess", "seq-03")], frame_batch=2,
            mesh=j_make_mesh(data=2, tile=2, devices=jax.devices()[:4]))
        yield two, four, want


@pytest.fixture(scope="module")
def two(groups):
    return groups[0].result()


@pytest.fixture(scope="module")
def four(groups):
    """The four ranks' results and JAX's metrics (``want``)."""
    return {"ranks": groups[1].result(), "want": groups[2]}


def _compared(ranks, phase):
    """The differences of ``phase`` from its reference, from the rank that
    holds the reference."""
    (d,) = [r[phase] for r in ranks if "metrics" in r[phase]]
    return d


def _check_step(d):
    for k, v in d["metrics"].items():
        assert v <= 1e-10, (k, v)
    assert d["grad_norm"] <= 1e-10
    assert d["grads_rel_l2"] <= 1e-9
    assert d["running_var"] <= 1e-12 and d["running_mean"] <= 1e-12
    assert d["num_batches_tracked"]
    assert d["params"] <= 1e-8


# -- ops over two ranks ------------------------------------------------------------


def test_halo_exchange_over_two_ranks(two):
    assert [r["halo_ops"]["halo"] for r in two] == [0.0, 0.0]


@pytest.mark.parametrize("op", ["normals", "cost_volume"])
def test_tiled_ops_over_two_ranks_equal_the_untiled_op(two, op):
    assert [r["halo_ops"][op] for r in two] == [0.0, 0.0]


def test_row_fetch_over_two_ranks(two):
    assert [r["tiled_ops"]["fetch"] for r in two] == [True, True]


@pytest.mark.parametrize("op", ["normals", "cost_volume"])
def test_tiled_kernels_over_two_ranks_equal_the_untiled_op(two, op):
    assert [r["tiled_ops"][op] for r in two] == [0.0, 0.0]


@pytest.mark.parametrize("what", ["normals_grad", "block", "block_grad_x", "block_grad_params"])
def test_tiled_layers_and_their_gradients_over_two_ranks(two, what):
    for r in two:
        assert r["tiled_ops"][what] <= 1e-12, (what, r["tiled_ops"][what])


# -- train steps ---------------------------------------------------------------------


def test_ranks_hold_different_valid_counts(two):
    counts = [r["data_step"]["valid_count"] for r in two]
    assert counts[0] != counts[1], counts


def test_data_parallel_step_equals_the_one_process_step(two):
    _check_step(_compared(two, "data_step"))


def test_data_parallel_step_with_grad_accum_equals_the_one_process_step(two):
    _check_step(_compared(two, "data_accum"))


@pytest.mark.parametrize("phase", ["step64", "step96", "remat", "accum"])
def test_tiled_step_equals_the_one_process_step(two, phase):
    counts = [r[phase]["valid_count"] for r in two]
    assert counts[0] != counts[1], counts
    _check_step(_compared(two, phase))


def test_data_and_tile_step_equals_the_one_process_step(four):
    ranks = four["ranks"]
    assert len({r["step22"]["valid_count"] for r in ranks}) > 2
    _check_step(_compared(ranks, "step22"))


# -- serving, the command line and evaluation ------------------------------------------


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


def test_cli_train_over_two_processes_checkpoints_once_and_resumes(two):
    for r in two:
        assert r["cli_train"] == {"first": ["2"], "resumed": ["3"]}


def test_cli_eval_with_eval_tile_over_two_processes(two):
    for r in two:
        assert r["cli_tile"]["lines"] == ["eval mesh: data=1 tile=2"]
    got = two[0]["cli_tile"]
    assert got["frames"][0] == got["frames"][1] == 3
    for k, v in got["metrics"].items():
        assert v <= 1e-6, (k, v)


def test_cli_train_with_a_tile_axis_over_two_processes(two):
    assert [r["cli_tile"]["train"] for r in two] == [["1"], ["1"]]


def test_tiled_eval_over_data_and_tile_matches_jax(four):
    ranks, want = [r["eval22"] for r in four["ranks"]], four["want"]
    assert all(r == ranks[0] for r in ranks)  # every rank returns the whole run's metrics
    assert ranks[0]["frames"] == want["frames"] == 6
    for k in METRICS:
        assert ranks[0][k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
