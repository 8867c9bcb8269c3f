"""The tile axis through the train step, over real processes (gloo on the CPU).

``tests/_torch_tiled_worker.py`` processes join one gloo process group and
hold the row-sharded paths to the one-process computation on the whole
image, with 8 planes and k = 5:

* ``ops``, over a 1 x 2 mesh: the row fetch, forward and backward, at an
  uneven split (exact, on integer values); ``depth_to_normal_tiled``
  bit-equal to the untiled op's rows and its gradient across the halo
  within 1e-12 (f64); the tiled cost volume bit-equal; a stride-2 block and
  an upsampling block under ``spatial_parallel``, BatchNorm summed over the
  ranks, within 1e-12 forward and gradient;
* one f64 train step over a 1 x 2 mesh at 128x32 and at 160x32 (1/32 has 5
  rows, split 2/3; both heights JAX's ``tile_partition_safe`` accepts),
  with ``remat_stages=2``, with ``grad_accum=2`` (one sample a microbatch),
  and over a 2 x 2 mesh (four processes), whose
  ranks hold different numbers of valid ground-truth pixels, against the
  one-process step on the global batch with ``tests/test_torch_distributed.py``'s
  tolerances: loss terms and ``grad_norm`` within 1e-10 relative, the
  gradients within 1e-9 in relative L2, every BatchNorm running statistic
  within 1e-12, the updated parameters within 1e-8. Measured on this host:
  2e-13, 3e-12 to 6e-12, 1e-14 and 1.4e-9.

Each group of workers runs once for the module under a 300 s timeout, so a
hang fails these tests instead of stalling the suite: the two-process
group takes about 65 s alone, the four-process one about 25 s.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_tiled_worker.py")
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world, out, phases):
    """Start ``world`` worker processes running ``phases`` into ``out``."""
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return [subprocess.Popen([sys.executable, WORKER, port, str(world), str(r), str(out)]
                             + list(phases), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, env=env, cwd=ROOT)
            for r in range(world)]


def collect(procs, out):
    """Wait for the workers (``TIMEOUT`` each) and read their results."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a gloo worker ran past {TIMEOUT} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    results = []
    for r in range(len(procs)):
        with open(out / f"rank{r}.json") as f:
            results.append(json.load(f))
    return results


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiled2")
    return collect(launch(2, out, ["ops", "step128", "step160", "remat", "accum"]), out)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    out = tmp_path_factory.mktemp("tiled4")
    return collect(launch(4, out, ["step22"]), out)


def test_row_fetch_over_two_ranks(two):
    assert [r["ops"]["fetch"] for r in two] == [True, True]


@pytest.mark.parametrize("op", ["normals", "cost_volume"])
def test_tiled_kernels_over_two_ranks_equal_the_untiled_op(two, op):
    assert [r["ops"][op] for r in two] == [0.0, 0.0]


@pytest.mark.parametrize("what", ["normals_grad", "block", "block_grad_x", "block_grad_params"])
def test_tiled_layers_and_their_gradients_over_two_ranks(two, what):
    for r in two:
        assert r["ops"][what] <= 1e-12, (what, r["ops"][what])


def _check_step(d):
    for k, v in d["metrics"].items():
        assert v <= 1e-10, (k, v)
    assert d["grad_norm"] <= 1e-10
    assert d["grads_rel_l2"] <= 1e-9
    assert d["running_var"] <= 1e-12 and d["running_mean"] <= 1e-12
    assert d["num_batches_tracked"]
    assert d["params"] <= 1e-8


@pytest.mark.parametrize("phase", ["step128", "step160", "remat", "accum"])
def test_tiled_step_equals_the_one_process_step(two, phase):
    counts = [r[phase]["valid_count"] for r in two]
    assert counts[0] != counts[1], counts
    _check_step(two[0][phase])


def test_data_and_tile_step_equals_the_one_process_step(four):
    assert len({r["step22"]["valid_count"] for r in four}) > 2
    _check_step(four[0]["step22"])
