"""The port's distribution over two real processes (gloo on the CPU).

Two ``tests/_torch_distributed_worker.py`` processes join one gloo process
group, as ``cnmnet_tpu_torch.cli train`` joins one on several cards, and
hold the collective paths to the one-process computation on the global
data, at 32x64 with 8 planes and k = 5:

* the row fetch of a halo and both tiled ops over a 1 x 2 mesh (64
  rows): bit-equal to the untiled port ops' rows;
* one data-parallel train step over a 2 x 1 mesh, and one with
  ``grad_accum=2``, whose ranks hold different numbers of valid
  ground-truth pixels (the hazard of averaging per-rank masked means):
  the loss terms and ``grad_norm`` within 1e-10 relative, the gradients
  within 1e-9 in relative L2, every BatchNorm running statistic within
  1e-12 (variance relative, mean relative to the running standard
  deviation), ``num_batches_tracked`` equal, the updated parameters within
  1e-8. The steps run in f64 (the worker says why); measured: 3e-14,
  1e-12, 1e-14 and 5e-10;
* ``cli train`` with ``parallel.coordinator_address``: two steps into one
  shared checkpoint directory, then a resume to step 3 on both ranks.

The workers run once for the module, under a 300 s timeout each, so a hang
fails these tests instead of stalling the suite (they take about 40 s alone
and 92 s inside the six-worker suite). The JAX package's own two-process
test is ``tests/test_distributed.py``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_distributed_worker.py")
WORLD = 2
TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, WORKER, port, str(WORLD), str(r), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for r in range(WORLD)]
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
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            results.append(json.load(f))
    return results


def test_halo_exchange_over_two_ranks(ranks):
    assert [r["ops"]["halo"] for r in ranks] == [0.0] * WORLD


@pytest.mark.parametrize("op", ["normals", "cost_volume"])
def test_tiled_ops_over_two_ranks_equal_the_untiled_op(ranks, op):
    assert [r["ops"][op] for r in ranks] == [0.0] * WORLD


def test_ranks_hold_different_valid_counts(ranks):
    counts = [r["step"]["valid_count"] for r in ranks]
    assert counts[0] != counts[1], counts


def _check_step(d):
    for k, v in d["metrics"].items():
        assert v <= 1e-10, (k, v)
    assert d["grad_norm"] <= 1e-10
    assert d["grads_rel_l2"] <= 1e-9
    assert d["running_var"] <= 1e-12 and d["running_mean"] <= 1e-12
    assert d["num_batches_tracked"]
    assert d["params"] <= 1e-8


def test_data_parallel_step_equals_the_one_process_step(ranks):
    _check_step(ranks[0]["step"])


def test_data_parallel_step_with_grad_accum_equals_the_one_process_step(ranks):
    _check_step(ranks[0]["accum"])


def test_cli_train_over_two_processes_checkpoints_once_and_resumes(ranks):
    for r in ranks:
        assert r["cli"] == {"first": ["2"], "resumed": ["3"]}
