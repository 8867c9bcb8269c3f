"""The span recorder (``obs/spans.py``) and the serving path's spans and
counters, on the CPU.

* Off, a span records nothing and costs well under a microsecond.
* A span's parent is the innermost span open on its own thread; two
  threads' spans do not mix.
* A ``MicroBatcher`` over a 32x64 session at buckets (1, 4) gives every
  request one ``serve.batcher.queue`` span, whose id appears in exactly one
  ``serve.batcher.dispatch``; the session's spans tile
  ``serve.session.dispatch`` and ``serve.session.fetch``; ``frames_real``
  and ``frames_run`` count the padding, with the recorder on or off.
* After the offset, a recorder span and a ``torch.profiler`` range around
  the same sleep sit within 1 ms of each other on the profiler's timeline.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.obs import spans  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession, MicroBatcher  # noqa: E402

H, W, V = 32, 64, 3


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


@pytest.fixture(scope="module")
def session():
    cfg = Config()
    cfg.model.num_planes = 8
    cfg.model.k_size = 5
    return InferenceSession(cfg, seed=0, batch_buckets=(1, 4), device="cpu")


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, V, H, W, 3), dtype=np.uint8)
    cams = np.broadcast_to(np.eye(4, dtype=np.float32), (n, V, 2, 4, 4)).copy()
    cams[:, :, 1, :3, :3] = np.asarray([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    cams[:, 1:, 0, 0, 3] = np.arange(1, V, dtype=np.float32) * 0.05  # sources shifted along x
    return images, cams


def _named(taken, name):
    return [s for s in taken if s.name == name]


def test_off_records_nothing_and_costs_under_a_microsecond():
    """The cost is the calling thread's CPU time, the least of many short
    repeats as ``timeit`` takes it: each fits in one time slice and one
    switch interval, so neither the host's other processes nor another
    thread holding the interpreter lock count against the span."""
    n, cpu, wall = 2_000, [], []
    for _ in range(200):
        t, c = time.perf_counter_ns(), time.thread_time_ns()
        for _ in range(n):
            with spans.span("off", bucket=4):
                pass
        cpu.append((time.thread_time_ns() - c) / n)
        wall.append((time.perf_counter_ns() - t) / n)
    spans.record("off", 0, 1)
    print(f"a span with the recorder off: {min(cpu):.1f} ns of CPU time (least of 200 x {n}; "
          f"median {np.median(cpu):.1f} ns; wall {min(wall):.1f} / {np.median(wall):.1f} ns)")
    assert min(cpu) < 1_000
    assert spans.take().spans == []
    assert spans.span("a") is spans.span("b")  # one shared no-op, nothing allocated


def test_parents_follow_nesting_on_each_thread():
    spans.enable()
    both_open = threading.Barrier(2, timeout=30)

    def work(tag):
        with spans.span(f"{tag}.outer"):
            with spans.span(f"{tag}.middle"):
                both_open.wait()  # the other thread's spans are open now too
                with spans.span(f"{tag}.inner", tag=tag):
                    pass
            with spans.span(f"{tag}.second"):
                pass

    threads = [threading.Thread(target=work, args=(tag,)) for tag in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    taken = spans.take()
    by_name = {s.name: s for s in taken.spans}
    assert len(by_name) == len(taken.spans) == 8
    assert len({s.id for s in taken.spans}) == 8
    for tag in ("a", "b"):
        outer, middle, inner, second = (by_name[f"{tag}.{n}"]
                                        for n in ("outer", "middle", "inner", "second"))
        assert outer.parent is None
        assert middle.parent == outer.id and second.parent == outer.id
        assert inner.parent == middle.id and inner.attrs == {"tag": tag}
        assert len({s.thread for s in (outer, middle, inner, second)}) == 1
        assert outer.start_ns <= middle.start_ns <= inner.start_ns <= inner.end_ns \
            <= middle.end_ns <= second.start_ns <= second.end_ns <= outer.end_ns
    assert by_name["a.outer"].thread != by_name["b.outer"].thread


def test_record_take_and_enable():
    spans.enable()
    rid = spans.new_id()
    spans.record("queue", 10, 20, span_id=rid, where="x")
    spans.record("free", 30, 40)
    taken = spans.take()
    queue, free = taken.spans
    assert (queue.name, queue.id, queue.parent, queue.start_ns, queue.end_ns, queue.attrs) == \
        ("queue", rid, None, 10, 20, {"where": "x"})
    assert free.id not in (rid, None) and free.parent is None
    assert spans.take().spans == []  # take() forgets
    spans.record("dropped", 0, 1)
    spans.enable()  # starts afresh
    assert spans.take().spans == []
    spans.disable()
    with spans.span("off"):
        pass
    assert spans.take().spans == []


def test_spans_sit_on_the_profiler_timeline():
    from torch.profiler import ProfilerActivity, profile, record_function

    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the first range pays for looking up its op
            pass
        for i in range(3):
            with spans.span(f"sleep{i}"), record_function(f"sleep{i}"):
                time.sleep(0.02)
    taken = spans.take()
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("sleep")}
    assert sorted(ranges) == ["sleep0", "sleep1", "sleep2"]
    for s in taken.spans:
        a, b = ranges[s.name]
        gaps = (abs(s.start_ns + taken.offset_ns - a), abs(s.end_ns + taken.offset_ns - b))
        print(f"{s.name}: recorder - profiler at start {gaps[0] / 1e3:.1f} us, "
              f"at end {gaps[1] / 1e3:.1f} us")
        assert max(gaps) < 1_000_000


def _assert_tiled(parent, children, names):
    """``children`` (in time order) are ``names``, children of ``parent``,
    one after another inside it, leaving only the statements between them
    uncovered: under 2 ms or 2% of it (a loaded host may preempt the thread
    there)."""
    assert [c.name for c in children] == names
    assert all(c.parent == parent.id and c.thread == parent.thread for c in children)
    assert parent.start_ns <= children[0].start_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(children, children[1:]))
    assert children[-1].end_ns <= parent.end_ns
    covered = sum(c.end_ns - c.start_ns for c in children)
    length = parent.end_ns - parent.start_ns
    assert length - covered < max(2_000_000, 0.02 * length)


def test_batcher_spans_and_padding_counters(session):
    """The batcher is held inside its first dispatch (one request, bucket 1)
    while three more are submitted: they are collected as one batch of 3,
    which runs in bucket 4."""
    images, cams = _requests(4)
    real0, run0 = session.frames_real, session.frames_run
    entered, release = threading.Event(), threading.Event()
    inner = session.predict_async

    def gated(*args):
        entered.set()
        assert release.wait(60)
        return inner(*args)

    spans.enable()
    session.predict_async = gated
    mb = MicroBatcher(session, max_batch=4, max_wait_ms=5)
    try:
        futs = [mb.submit(images[0], cams[0])]
        assert entered.wait(60)
        futs += [mb.submit(images[i], cams[i]) for i in range(1, 4)]
        release.set()
        got = [f.result(timeout=120) for f in futs]
    finally:
        release.set()
        mb.close()
        del session.predict_async
    taken = spans.take().spans
    assert all(g["idepth"].shape == (H, W) for g in got)
    assert (mb.dispatched, mb.served) == (2, 4)
    assert (session.frames_real - real0, session.frames_run - run0) == (4, 5)

    queue = _named(taken, "serve.batcher.queue")
    rids = sorted(s.id for s in queue)
    assert len(rids) == len(set(rids)) == 4
    assert all(s.start_ns <= s.end_ns and s.parent is None for s in queue)
    batches = sorted(_named(taken, "serve.batcher.dispatch"), key=lambda s: s.start_ns)
    assert [len(b.attrs["requests"]) for b in batches] == [1, 3]
    held = [rid for b in batches for rid in b.attrs["requests"]]
    assert sorted(held) == rids  # each request's id in exactly one batch
    delivered = [rid for s in _named(taken, "serve.batcher.deliver") for rid in s.attrs["requests"]]
    assert sorted(delivered) == rids
    for q in queue:
        (batch,) = [b for b in batches if q.id in b.attrs["requests"]]
        assert q.end_ns <= batch.start_ns  # queued until the batch that takes it

    thread = batches[0].thread
    chunks = sorted(_named(taken, "serve.session.dispatch"), key=lambda s: s.start_ns)
    assert [(c.attrs["bucket"], c.attrs["frames"]) for c in chunks] == [(1, 1), (4, 3)]
    for chunk, batch in zip(chunks, batches):
        assert chunk.parent == batch.id and chunk.thread == thread
        kids = sorted((s for s in taken if s.parent == chunk.id), key=lambda s: s.start_ns)
        _assert_tiled(chunk, kids, ["serve.session.stage", "serve.session.forward"])  # no wire on the CPU
    fetches = _named(taken, "serve.session.fetch")
    assert len(fetches) == 2
    for fetch in fetches:
        kids = sorted((s for s in taken if s.parent == fetch.id), key=lambda s: s.start_ns)
        _assert_tiled(fetch, kids, ["serve.session.device_wait", "serve.session.unpack"])
    collects = _named(taken, "serve.batcher.collect")
    assert collects and all(s.thread == thread and s.parent is None for s in collects)


def test_off_the_session_records_nothing_and_still_counts(session):
    images, cams = _requests(3, seed=1)
    real0, run0 = session.frames_real, session.frames_run
    out = session.predict(images, cams)
    session.predict(images[:1], cams[:1])
    assert out["depth"].shape == (3, H, W)
    assert (session.frames_real - real0, session.frames_run - run0) == (4, 5)
    assert spans.take().spans == []
