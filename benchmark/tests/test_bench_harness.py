"""The harness's arithmetic on the CPU: the open loop's due-time tail, rates
over the whole window, readers that find nothing, and cells, configurations
and metrics found by name."""

import json
import shutil
import time

import numpy as np
import pytest

from benchmark import run
from benchmark.drivers import open_loop
from benchmark.tests import small


class FakeSession:
    """Answers at once, except one ``predict_async`` that stalls."""

    buckets = (1, 4, 8)

    def __init__(self, stall_at=None, stall_s=0.0, stall_after_s=None):
        self.calls, self.stall_at, self.stall_s = 0, stall_at, stall_s
        self.stall_after = None if stall_after_s is None else time.perf_counter() + stall_after_s
        self.stalled = False

    def predict_async(self, images, cams):
        self.calls += 1
        late = self.stall_after is not None and time.perf_counter() > self.stall_after
        if not self.stalled and (self.calls == self.stall_at or late):
            self.stalled = True
            time.sleep(self.stall_s)
        return images.shape[0]

    def fetch(self, n):
        z = np.zeros((n, small.HEIGHT, small.WIDTH), np.float32)
        return {"idepth": z, "depth": z, "prob": z, "normal": np.zeros(z.shape + (3,), np.float32)}


def _measure(session, rate=100.0, seconds=2.0, seed=3):
    s = small.spec("serve-3v-open", rate=rate, warmup_s=0.0)
    ctx = small.context(s, seed=seed, seconds=seconds)
    return open_loop.measure(ctx, session, state={})


def test_schedule_holds_the_same_gaps_for_every_seed():
    a, b = open_loop.schedule(100.0, 4.0, 1), open_loop.schedule(100.0, 4.0, 2**31 + 7)
    assert len(a) == len(b) == 400
    assert a[0] == b[0] == 0.0 and a[-1] < 4.0 and b[-1] < 4.0
    assert not np.allclose(a, b)
    np.testing.assert_allclose(np.sort(np.diff(np.append(a, 4.0))),
                               np.sort(np.diff(np.append(b, 4.0))), rtol=1e-9)


def test_due_time_tail_shows_a_stall_of_the_session():
    r = _measure(FakeSession(stall_at=20, stall_s=0.5))
    lat = r["due_latency_ms"]
    assert r["failed"] == 0 and len(lat) == 200
    assert (lat > 200.0).sum() >= 15  # the requests queued behind the stall
    assert run.reader("serve_p95_ms")(r) > 200.0
    quiet = _measure(FakeSession())
    assert run.reader("serve_p95_ms")(quiet) < 100.0


def test_due_time_tail_shows_a_late_generator(monkeypatch):
    """A client that stalls before submitting (a pause of its own) delays the
    requests due meanwhile: timed from their submit they would look fast."""
    from cnmnet_tpu_torch.serve import MicroBatcher

    submit, calls = MicroBatcher.submit, [0]

    def slow_once(self, images, cams):
        calls[0] += 1
        if calls[0] == 50:
            time.sleep(0.4)
        return submit(self, images, cams)

    monkeypatch.setattr(MicroBatcher, "submit", slow_once)
    r = _measure(FakeSession())
    assert r["generator_late_ms"] >= 300.0
    assert (r["due_latency_ms"] > 150.0).sum() >= 15


def test_rate_counts_what_the_window_answered_over_the_whole_window():
    r = _measure(FakeSession(), rate=50.0, seconds=2.0)
    assert r["attempted"] == 100
    assert run.reader("serve_rps")(dict(r, window_s=2.0)) == pytest.approx(50.0, rel=0.05)
    # a stall in the last quarter: what is answered after the close is not counted
    stalled = _measure(FakeSession(stall_after_s=1.5, stall_s=1.0), rate=50.0, seconds=2.0)
    assert stalled["failed"] == 0
    assert run.reader("serve_rps")(dict(stalled, window_s=2.0)) < 0.9 * 50.0


def test_readers_with_nothing_to_read_return_nothing():
    empty = {"window_s": 10.0}
    for name in ("cv_roofline.open", "d2n_roofline.open", "idle_pct.open", "mfu.overload",
                 "step_mfu.open", "mean_batch.open", "dispatch_host_ms.open"):
        assert run.reader(name)(empty) is None, name
    calls = {"cost_volume": [((24, 192, 256, 64), 4)]}
    assert run.reader("cv_roofline.open")({"kernel_calls": calls, "device_kernels": {}}) is None
    share = run.reader("cv_roofline.open")({"kernel_calls": calls, "device_kernels": {
        "void cost_volume_kernel<float>(...)": 0.0008, "pack_source_kernel": 0.0002}})
    assert share == pytest.approx(100 * 0.0986 / 1.0, rel=1e-2)


def test_new_cell_configuration_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(run.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    here = root / "benchmark"
    (here / "configs" / "cnm-5view-192x256.json").write_text(json.dumps(
        {"image_height": 192, "image_width": 256, "sources": [10, -10, 5, -5],
         "model": {"idepth_scale": 3.0, "num_planes": 64, "k_size": 9}}))
    (here / "traffic" / "open-5v-bursts.json").write_text(json.dumps(
        {"driver": "open_loop", "rate_rps": 40.0, "max_batch": 4}))
    (here / "limits" / "serve-5v.json").write_text(json.dumps({"idepth_gap": 2.0}))
    (here / "metrics" / "batches.py").write_text(
        "def read(r):\n    return r['dispatched'] / 2\n")
    bench["configs"].append({"name": "cnm-5view-192x256", "source": "x",
                             "file": "benchmark/configs/cnm-5view-192x256.json", "reduced": []})
    bench["workloads"].append({"name": "serve-5v", "config": "cnm-5view-192x256",
                               "traffic": "open-5v-bursts", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "batches.serve5", "unit": "batches", "better": "lower",
                               "source": "program_counter", "layer": "batcher",
                               "moves": "serve_rps", "workloads": ["serve-5v"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_spec("serve-5v", root=root, here=here)
    assert spec.config["sources"] == [10, -10, 5, -5]
    assert spec.traffic["max_batch"] == 4 and spec.limits == {"idepth_gap": 2.0}
    names = [m["name"] for m in spec.metrics]
    assert "batches.serve5" in names and "setup_s" in names and "serve_p95_ms" not in names
    assert run.reader("batches.serve5", here=here)({"dispatched": 10}) == 5


def test_step_share_is_the_answered_work_over_the_busy_time():
    r = {"answered": 100, "request_flops": 4e11, "busy_s": 2.0, "peak_flops": 1e15}
    assert run.reader("step_mfu.open")(r) == pytest.approx(2.0)
    assert run.reader("step_mfu.open")(dict(r, busy_s=4.0)) == pytest.approx(1.0)
