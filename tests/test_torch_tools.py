"""The port's tools (``cnmnet_tpu_torch/tools``) and ``cli bench`` on the
CPU, at 32x64 with 8 planes and k = 5 where a tool takes a size (32x32
where nothing is compared with JAX: a forward costs half).

* ``cli bench --device cpu`` prints one JSON line with the JAX benchmark's
  keys, less ``measured_same_host_speedup``.
* ``check_gt_normal``'s mean angles equal JAX's
  ``ops/normals.normal_mean_angle_deg`` within 1e-3 degrees on the same
  synthetic scenes (see the test for what the normals are held to).
* ``bench_serving``'s batch histogram and padding overhead equal a hand
  count; an open-loop run of 30 requests at two loads answers every
  request, and its histogram accounts for each of them (2 views, 32x32:
  the batcher is under test, not the model).
* ``bench_cv`` and ``bench_normals`` print the kernel-against-plain error
  (0 here: the CPU takes the plain version) and the bound of
  ``roofline.kernel_cost``.
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.data.synthetic import SyntheticScenes as JScenes  # noqa: E402
from cnmnet_tpu.ops.normals import normal_mean_angle_deg as j_mean_angle  # noqa: E402
from cnmnet_tpu_torch import bench, cli  # noqa: E402
from cnmnet_tpu_torch.geometry.camera import invert_intrinsics as t_invert_intrinsics  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch as t_dispatch  # noqa: E402
from cnmnet_tpu_torch.tools import (bench_cv, bench_normals, bench_serving,  # noqa: E402
                                    check_gt_normal, roofline)

H, W, P, K = 32, 64, 8, 5
SMALL = [f"model.num_planes={P}", f"model.k_size={K}"]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_kind"}


def run(main, argv):
    """``main(argv)`` with its standard output captured: (rc, lines, the
    JSON objects among them)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = out.getvalue().splitlines()
    return rc, lines, [json.loads(line) for line in lines if line.startswith("{")]


def test_cli_bench_prints_the_jax_line():
    rc, lines, rows = run(cli.main, ["bench", "--device", "cpu", "--height", "32",
                                     "--width", "32"])
    assert rc == 0 and rows == [json.loads(lines[-1])]
    (line,) = rows
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "3view_refined_fps_per_chip_32x32"
    assert line["unit"] == "frames/s" and line["value"] > 0
    # both are rounded to 3 decimals from the same frames/s
    assert abs(line["vs_baseline"] - line["value"] / bench.V100_BASELINE_FPS) <= 1e-3
    assert lines[0].startswith("device: cpu")


@pytest.mark.parametrize("k_size", [5, 9])
def test_check_gt_normal_matches_jax(k_size):
    """Each sample's mean angle equals JAX's ``normal_mean_angle_deg`` of the
    port's normals within 1e-3 degrees, and the normals are the port's
    depth->normal of the ground-truth depth. The end-to-end angle with each
    package's own f32 op is not held to 1e-3: the two f32 solves round
    apart at the ill-posed pixels of these planar scenes (their means
    differ by up to 7e-3 degrees here, both 0.1-0.2 degrees from the f64
    fit's; measured), which ``tests/test_torch_normals`` judges by the f64
    oracle instead."""
    rc, _, (row,) = run(check_gt_normal.main, ["--device", "cpu", "--height", str(H),
                                                "--width", str(W), "--num-samples", "2",
                                                "--k-size", str(k_size)])
    assert rc == 0 and row["samples"] == 2
    ds = JScenes(num_samples=2, height=H, width=W)
    want = []
    for i in range(2):
        s = ds[i]
        depth = torch.from_numpy(s["depths"][0].copy())[None]
        K_inv = t_invert_intrinsics(torch.from_numpy(s["cams"][0, 1, :3, :3].copy())[None])
        n, _ = t_dispatch.depth_to_normal(depth, K_inv, k_size)
        want.append(float(j_mean_angle(jnp.asarray(n.numpy()), jnp.asarray(s["normals"])[None],
                                       jnp.asarray(depth.numpy()) > 0.1)))
    np.testing.assert_allclose(row["angles_deg"], want, rtol=0, atol=1e-3)
    assert row["mean_angle_deg"] == pytest.approx(np.mean(want), abs=1e-3)


def test_serving_histogram_and_padding_by_hand():
    sizes = [1, 3, 4, 8, 2, 5, 3]
    assert bench_serving.batch_histogram(sizes) == {1: 1, 2: 1, 3: 2, 4: 1, 5: 1, 8: 1}
    # buckets (1, 4, 8): 1->1, 3->4, 4->4, 8->8, 2->4, 5->8, 3->4
    assert bench_serving.padding(sizes, (8, 1, 4)) == (0 + 1 + 0 + 0 + 2 + 3 + 1,
                                                       1 + 4 + 4 + 8 + 4 + 8 + 4)
    assert bench_serving.padding([], (1, 4)) == (0, 0)


def test_open_loop_answers_every_request():
    rc, lines, rows = run(bench_serving.main, [
        "--device", "cpu", "--height", "32", "--width", "32", "--views", "2", "--requests", "30",
        "--loads", "40,80", "--buckets", "1,4", "--max-wait-ms", "5"] + SMALL)
    assert rc == 0 and [r["offered_rps"] for r in rows] == [40.0, 80.0]
    for r in rows:
        hist = {int(k): v for k, v in r["batch_hist"].items()}
        assert r["answered"] == r["requests"] == 30 and r["failed"] == r["unanswered"] == 0
        assert sum(n * c for n, c in hist.items()) == 30 and sum(hist.values()) == r["batches"]
        padded, computed = bench_serving.padding(
            [n for n, c in hist.items() for _ in range(c)], (1, 4))
        assert r["padding_overhead_pct"] == pytest.approx(100 * padded / computed)
        assert r["p50_ms"] <= r["p99_ms"] <= r["max_ms"] and r["achieved_rps"] > 0
        assert 0 <= r["backlog_max"] < 30
    assert any(line.startswith("| 40.00 |") for line in lines)


def test_request_pool_is_distinct():
    base = np.full((3, 4, 5, 3), 128, np.uint8)
    pool = bench_serving.request_pool(base, 8, np.random.default_rng(0))
    assert pool.shape == (8,) + base.shape and pool.dtype == np.uint8
    assert len({p.tobytes() for p in pool}) == 8
    assert np.abs(pool.astype(int) - 128).max() <= 3


def test_kernel_benches_report_the_plain_error_and_the_bound():
    rc, _, rows = run(bench_cv.main, ["--device", "cpu", "--batches", "1,2", "--height", str(H),
                                      "--width", str(W), "--planes", str(P), "--iters", "2"])
    assert rc == 0 and [r["pairs"] for r in rows] == [1, 2]
    for r in rows:
        flops, nbytes = roofline.kernel_cost("cost_volume", (r["pairs"], H, W, P), 2)
        assert r["max_abs_err"] == 0 and r["bound_ms"] == roofline.bound(nbytes, flops)[0]
        assert "ms" not in r  # no card: no device time
    rc, _, (row,) = run(bench_normals.main, ["2", str(H), str(W), str(K), "2", "--device", "cpu"])
    flops, nbytes = roofline.kernel_cost("depth_to_normal", (2, H, W, K))
    assert rc == 0 and row["max_abs_err"] == 0 and row["angle_max_deg"] <= 1e-5
    assert row["bound_ms"] == roofline.bound(nbytes, flops)[0] and "ms" not in row
