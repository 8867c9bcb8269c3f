"""The port's scale-out surface on the CPU: the entry points
(``cnmnet_tpu_torch/entry.py``), ``tools/scaling_sweep``,
``tools/probe_multichip_hlo`` (the collective census), ``tools/bwd_probe``
and ``tools/verify_step_time``, with gloo ranks spawned by
``tools/_ranks.py``.

* ``dryrun_multichip(4)`` lays out a 2 x 2 mesh (JAX's rule) and its loss
  equals one process's step on the same batch and weights within 1e-4
  (f32; relative).
* The census at 4 ranks, tile 2: every rank counts the same collectives,
  the gradient all-reduce hands over 4 bytes a parameter, and row fetches
  appear only with a tile axis (none at 4 x 1). The dryrun and both
  censuses run off one spawn of four ranks (``_ranks.run_calls``); the
  command-line mains then print from those results.
* ``scaling_sweep`` at 1x1 and 2x1 prints rows with JAX's keys, and its
  efficiency is the formula over its own rows.
* ``bwd_probe``: ``s2d`` counts what ``base`` counts, ``k5`` and
  ``no_normals`` less; its ``VARIANTS`` are JAX's, read from
  ``tools/bwd_probe.py`` as text (importing it would turn on JAX's compile
  cache).
* ``verify_step_time`` prints two finite losses; ``entry``'s inputs are
  ``__graft_entry__._tiny_batch``'s bit for bit.
"""

import ast
import contextlib
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cnmnet_tpu_torch import entry  # noqa: E402
from cnmnet_tpu_torch.tools import (_ranks, bwd_probe, probe_multichip_hlo,  # noqa: E402
                                    scaling_sweep, verify_step_time)

ROOT = Path(__file__).resolve().parents[1]
SWEEP_KEYS = {"mesh", "devices", "global_batch", "step_ms", "samples_per_s",
              "scaling_efficiency"}


def run(main, argv):
    """``main(argv)`` with its standard output captured: (rc, lines, the
    JSON objects among them)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().splitlines()
    return rc, lines, [json.loads(line) for line in lines if line.startswith("{")]


@pytest.fixture(scope="module")
def four_ranks():
    """One spawn of four gloo ranks: the dryrun at 2 x 2, the census of
    ``probe_multichip_hlo 4 2``, and the census at 4 x 1."""
    dryrun, tiled, flat = _ranks.run_calls(4, [
        (entry.dryrun_rank, (4,)),
        (probe_multichip_hlo.probe_rank, (2, None, None, 64, [])),
        (probe_multichip_hlo.probe_rank, (1, None, None, 64, [])),
    ], device="cpu")
    return {"dryrun": dryrun, "tiled": tiled, "flat": flat}


@pytest.fixture
def spawned(monkeypatch, four_ranks):
    """``_ranks.run`` answering from the fixture's spawn for the calls it
    ran."""
    calls = {entry.dryrun_rank: four_ranks["dryrun"],
             probe_multichip_hlo.probe_rank: four_ranks["tiled"]}

    def run_ranks(world, fn, *args, device="cuda", timeout=900.0):
        assert world == 4 and device == "cpu", (world, device)
        return calls[fn]

    monkeypatch.setattr(_ranks, "run", run_ranks)


def test_dryrun_multichip_mesh_and_loss_equal_one_process(four_ranks, spawned):
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lead = entry.dryrun_multichip(4, device="cpu")
    lines = out.getvalue().splitlines()
    assert lead["mesh"] == {"data": 2, "tile": 2}
    assert lines[-1] == f"dryrun_multichip ok: mesh={ {'data': 2, 'tile': 2} } loss={lead['loss']:.4f}"
    assert lines[0].startswith("dryrun sharding: images dim 0 (samples) over 'data', dim 2 (rows)")
    ranks = four_ranks["dryrun"]
    assert [r["rows"] for r in ranks] == [[0, 32], [32, 64]] * 2
    assert [r["samples"] for r in ranks] == [[0, 1], [0, 1], [1, 2], [1, 2]]
    assert len({r["loss"] for r in ranks}) == 1  # every rank has the global loss

    cfg = entry.dryrun_config(2, lead["height"])
    state = create_train_state(cfg, 0, "cpu")
    _, metrics = make_train_step(cfg)(state, tiny_batch(2, lead["height"], entry.WIDTH,
                                                        device="cpu"))
    one = float(metrics["loss"])
    assert abs(lead["loss"] - one) <= 1e-4 * abs(one), (lead["loss"], one)


def test_census_is_the_same_on_every_rank(four_ranks):
    for key in ("tiled", "flat"):
        first = four_ranks[key][0]
        for r in four_ranks[key][1:]:
            for field in ("calls", "bytes", "via_host", "by_kind", "by_caller"):
                assert r[field] == first[field], (key, r["rank"], field)


def test_census_gradient_all_reduce_is_four_bytes_a_parameter(four_ranks):
    for key in ("tiled", "flat"):
        for r in four_ranks[key]:
            grads = r["by_caller"]["gradients"]
            assert grads == {"calls": 1, "bytes": 4 * r["params"],
                             "by_kind": {"all-reduce": 1}}, (key, grads)
            assert r["via_host"] == 0 and r["other_sites"] == {}
            assert r["by_caller"]["batch_norm"]["calls"] > 0
            assert r["by_caller"]["loss"]["calls"] > 0


def test_census_row_fetches_only_with_a_tile_axis(four_ranks, spawned):
    rc, lines, rows = run(probe_multichip_hlo.main, ["4", "2", "--device", "cpu"])
    assert rc == 0 and len(rows) == 4
    tiled, flat = four_ranks["tiled"][0], four_ranks["flat"][0]
    assert (tiled["mesh"], flat["mesh"]) == ({"data": 2, "tile": 2}, {"data": 4, "tile": 1})
    fetch = tiled["by_caller"]["row_fetch"]
    assert fetch["calls"] > 0 and fetch["by_kind"] == {"all-gather": fetch["calls"]}
    assert tiled["by_kind"]["all-gather"]["calls"] == fetch["calls"]
    assert "row_fetch" not in flat["by_caller"] and "all-gather" not in flat["by_kind"]
    kinds = {k: v["calls"] for k, v in tiled["by_kind"].items()}
    assert lines[0] == f"mesh={ {'data': 2, 'tile': 2} } collectives: {kinds}"


def test_census_restores_the_collectives():
    from cnmnet_tpu_torch.models import layers
    from cnmnet_tpu_torch.parallel import collectives

    before = (collectives.all_reduce_, collectives.all_gather, collectives.broadcast_,
              layers.all_reduce_)
    with probe_multichip_hlo.Census():
        assert collectives.all_reduce_ is not before[0] and layers.all_reduce_ is not before[3]
    assert (collectives.all_reduce_, collectives.all_gather, collectives.broadcast_,
            layers.all_reduce_) == before


def test_ranks_refuse_a_card_that_is_not_there():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        _ranks.check_world(1, "cuda")
    with pytest.raises(ValueError, match="world size"):
        _ranks.check_world(0, "cpu")


def _fails(device):
    raise ZeroDivisionError("rank failed on purpose")


def test_a_failing_rank_reports_its_traceback():
    """A rank's exception comes back as its traceback, with the process
    group torn down (a one-rank gloo group in this process)."""
    import queue

    import torch.distributed as dist

    results = queue.Queue()
    _ranks._rank_main(0, 1, _ranks.free_port(), "cpu", torch.get_num_threads(),
                      [(_fails, ())], results)
    rank, ok, text = results.get_nowait()
    assert (rank, ok) == (0, False) and not dist.is_initialized()
    assert "ZeroDivisionError: rank failed on purpose" in text and "_fails" in text


def test_scaling_sweep_rows_and_efficiency():
    rc, lines, rows = run(scaling_sweep.main, ["--meshes", "1x1,2x1", "--iters", "1",
                                               "--device", "cpu"])
    assert rc == 0
    *measured, closing = rows
    assert closing == {"sweep": measured}
    assert [r["mesh"] for r in measured] == ["1x1", "2x1"]
    base = measured[0]["samples_per_s"] / measured[0]["devices"]
    for r in measured:
        assert SWEEP_KEYS <= set(r)
        assert r["global_batch"] == r["devices"]  # per-device batch 1, tile 1
        assert r["samples_per_s"] == pytest.approx(r["global_batch"] / r["step_ms"] * 1e3)
        assert r["scaling_efficiency"] == pytest.approx(
            r["samples_per_s"] / (r["devices"] * base))
        assert math.isfinite(r["loss"])
    assert measured[0]["scaling_efficiency"] == 1.0


def _jax_variants():
    tree = ast.parse((ROOT / "tools" / "bwd_probe.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("tools/bwd_probe.py has no VARIANTS")


def test_bwd_probe_variants_are_jax_s():
    assert bwd_probe.VARIANTS == _jax_variants()


def test_bwd_probe_counts():
    rc, lines, rows = run(bwd_probe.main, ["--batch", "1", "--height", "32", "--width", "32",
                                           "--variants", "base,k5,no_normals,s2d",
                                           "--ks", "0,1", "--device", "cpu"])
    assert rc == 0
    got = {r["variant"]: r for r in rows}
    assert list(got) == ["base", "k5", "no_normals", "s2d"]
    assert "| variant | GFLOP | ms/step | samples/s/chip |" in lines
    assert got["s2d"]["gflop"] == got["base"]["gflop"]
    assert got["k5"]["gflop"] < got["base"]["gflop"]
    assert got["no_normals"]["gflop"] < got["base"]["gflop"]
    # k and the normal losses move only the depth->normal count, not the convs
    for name in ("k5", "no_normals", "s2d"):
        assert got[name]["gflop_model"] == got["base"]["gflop_model"]
    for r in rows:  # the chain of 0 and 1 steps: the slope is one step's time
        assert r["steps_timed"] == 2 and r["ms_per_step"] > 0 and not r["counted_with_remat_off"]


def test_verify_step_time_prints_finite_losses():
    rc, lines, (row,) = run(verify_step_time.main, ["1", "--height", "32", "--width", "64",
                                                    "--reps", "2", "--device", "cpu"])
    assert rc == 0 and len(row["losses"]) == 2
    assert all(math.isfinite(v) for v in row["losses"])
    assert lines[-2] == "losses: " + " ".join(f"{v:.4f}" for v in row["losses"])
    assert row["fwd_loss_ms"] > 0 and row["step_median_ms"] >= row["step_min_ms"] > 0


def test_entry_inputs_are_the_jax_entry_s():
    from __graft_entry__ import _tiny_batch

    fn, (images, cams) = entry.entry(device="cpu")
    want = _tiny_batch(1, height=192, width=256)
    np.testing.assert_array_equal(images.numpy(), want["images"])
    np.testing.assert_array_equal(cams.numpy(), want["cams"])
    assert images.dtype == torch.float32 and not fn.model.training
    assert fn.model.num_planes == 64
