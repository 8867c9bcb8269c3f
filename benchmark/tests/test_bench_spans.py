"""The span readers' arithmetic on synthetic spans and device intervals, and
a CPU run of a serving cell with the program's span recorder on
(``benchmark/spans.py``)."""

import numpy as np
import pytest

from benchmark import run, spans as bspans
from benchmark.tests import small
from cnmnet_tpu_torch.obs.spans import Span

T = 1_000  # the thread of the synthetic batcher


def _span(name, start, end, sid=0, parent=None, thread=T, **attrs):
    return Span(name, sid, parent, thread, start, end, attrs)


def _covered_brute(intervals, t):
    return sum(max(min(b, t) - a, 0) for a, b in intervals)


def test_covered_and_idle_time_against_a_plain_count():
    rng = np.random.default_rng(0)
    edges = np.sort(rng.choice(10_000, 40, replace=False))
    busy = edges.reshape(-1, 2)
    for t in list(rng.integers(-10, 10_100, 50)) + list(edges):
        assert bspans.covered_before(busy, [t])[0] == _covered_brute(busy, t)
    a = rng.integers(0, 9_000, 30)
    b = a + rng.integers(0, 1_000, 30)
    want = [(y - x) - (_covered_brute(busy, y) - _covered_brute(busy, x)) for x, y in zip(a, b)]
    np.testing.assert_array_equal(bspans.idle_inside(busy, a, b), want)
    empty = np.zeros((0, 2), np.int64)
    np.testing.assert_array_equal(bspans.idle_inside(empty, [5], [9]), [4])


def test_innermost_puts_each_moment_under_the_deepest_open_span():
    spans = [_span("outer", 0, 100), _span("a", 10, 30), _span("a.1", 15, 20),
             _span("b", 40, 100), _span("next", 120, 130)]
    assert bspans.innermost(spans) == [
        (0, 10, "outer"), (10, 15, "a"), (15, 20, "a.1"), (20, 30, "a"), (30, 40, "outer"),
        (40, 100, "b"), (120, 130, "next")]


def _timeline():
    """Two batches on one thread, the device busy in [20, 60) and [150, 170)
    of a traced window [0, 200) (ns on the profiler's clock: offset 1000)."""
    off = -1_000
    spans = [
        _span("serve.batcher.queue", 1_000, 1_010, sid=1),
        _span("serve.batcher.queue", 1_005, 1_010, sid=2),
        _span("serve.batcher.collect", 1_000, 1_010, sid=10),
        _span("serve.batcher.dispatch", 1_010, 1_050, sid=11, requests=[1, 2]),
        _span("serve.session.dispatch", 1_010, 1_050, sid=12, parent=11, bucket=4, frames=2),
        _span("serve.session.stage", 1_010, 1_020, sid=13, parent=12),
        _span("serve.session.forward", 1_020, 1_045, sid=14, parent=13),
        _span("serve.session.wire", 1_045, 1_050, sid=15, parent=12),
        _span("serve.batcher.queue", 1_060, 1_100, sid=3),
        _span("serve.batcher.collect", 1_050, 1_100, sid=16),
        _span("serve.batcher.dispatch", 1_100, 1_140, sid=17, requests=[3]),
        _span("serve.session.fetch", 1_140, 1_170, sid=18),
        _span("serve.session.device_wait", 1_140, 1_160, sid=19, parent=18),
        _span("serve.session.unpack", 1_160, 1_170, sid=20, parent=18),
        _span("serve.batcher.deliver", 1_170, 1_180, sid=21, requests=[1, 2]),
    ]
    return {"spans": spans, "span_offset_ns": off,
            "device_busy_ns": np.asarray([[20, 60], [150, 170]], np.int64),
            "busy_s": 60e-9, "trace_window_s": 200e-9, "frames_real": 3, "frames_run": 5}


def test_idle_inside_the_batcher_dispatch_is_the_hosts_share():
    r = _timeline()
    # dispatch [10, 50): idle [10, 20) = 10; dispatch [100, 140): all 40 idle
    assert run.reader("idle_dispatch_pct.open")(r) == pytest.approx(100 * 50 / 200)
    assert run.reader("idle_dispatch_pct.open")(r) <= run.reader("idle_pct.open")(r)
    idle = bspans.idle_by_span(r)
    assert idle["serve.session.stage"] == pytest.approx(10e-9)
    assert idle["serve.session.forward"] == pytest.approx(0.0)
    assert idle["serve.batcher.dispatch"] == pytest.approx(40e-9)
    assert idle["serve.batcher.collect"] == pytest.approx(50e-9)  # [0, 10) and [50, 100)
    assert idle["serve.session.device_wait"] == pytest.approx(10e-9)  # [140, 150)
    assert idle["serve.session.unpack"] == pytest.approx(0.0)
    assert idle["serve.batcher.deliver"] == pytest.approx(10e-9)
    assert idle["(none)"] == pytest.approx(20e-9)  # [180, 200)
    assert sum(idle.values()) == pytest.approx(r["trace_window_s"] - r["busy_s"])


def test_span_and_counter_readers():
    r = _timeline()
    assert run.reader("queue_wait_ms.open")(r) == pytest.approx(np.percentile([1e-5, 5e-6, 4e-5], 95))
    assert run.reader("stage_ms.open")(r) == pytest.approx(1e-5)
    assert run.reader("launch_ms.open")(r) == pytest.approx(2.5e-5)
    assert run.reader("device_wait_ms.open")(r) == pytest.approx(2e-5)
    assert run.reader("pad_pct.open")(r) == pytest.approx(40.0)


def test_span_readers_with_nothing_to_read_return_nothing():
    empty = {"window_s": 10.0}
    for stem in bspans.STEMS:
        assert run.reader(f"{stem}.open")(empty) is None, stem
    no_trace = {"spans": _timeline()["spans"], "span_offset_ns": 0}
    assert run.reader("idle_dispatch_pct.overload")(no_trace) is None
    assert run.reader("pad_pct.open")({"frames_real": 0, "frames_run": 0}) is None


def test_breakdown_of_the_slowest_requests():
    spans = _timeline()["spans"]
    # requests 1 and 2 wait through batch 2's collect and dispatch and the fetch
    out = bspans.breakdown(spans, share=0.0)
    assert out["requests"] == 2
    parts = {k: v * 1e6 for k, v in out.items() if k != "requests"}
    assert parts["queue"] == pytest.approx(7.5) and parts["own_dispatch"] == pytest.approx(40)
    assert parts["next_collect"] == pytest.approx(50) and parts["next_dispatch"] == pytest.approx(40)
    assert parts["device_wait"] == pytest.approx(20) and parts["unpack"] == pytest.approx(10)
    assert parts["deliver"] == pytest.approx(10) and parts["other_deliveries"] == 0
    assert parts["total"] == pytest.approx(177.5)
    assert parts["rest"] == pytest.approx(177.5 - 7.5 - 40 - 50 - 40 - 20 - 10 - 10)
    assert bspans.breakdown(spans[:2]) == {}


def test_a_cpu_run_reads_the_program_spans():
    """The serving cell at 32x64 on the CPU with the recorder on and no
    device trace: correct, and every span and counter metric read."""
    spec = small.spec("serve-3v-open", rate=8.0, warmup_s=0.0)
    out = bspans.run_spans(spec, 5, 1.5, profile=False, record=True, device="cpu")
    assert out["correct"] and out["device"] == "cpu"
    m = out["metrics"]
    for name in ("queue_wait_ms.open", "stage_ms.open", "launch_ms.open", "device_wait_ms.open",
                 "pad_pct.open", "dispatch_host_ms.open", "serve_p95_ms", "mean_batch.open"):
        assert name in m, name
    assert "idle_dispatch_pct.open" not in m and "idle_pct.open" not in m  # no device trace
    assert 0.0 <= m["pad_pct.open"] < 100.0
    means = out["spans"]["mean_ms"]
    # the chunk's children tile the session's dispatch; the proxy times the same call
    inside = means["serve.session.stage"] + means["serve.session.forward"]
    assert inside <= means["serve.session.dispatch"] <= m["dispatch_host_ms.open"]
    assert inside > 0.9 * m["dispatch_host_ms.open"]
    assert out["spans"]["breakdown"]["requests"] >= 1
