"""Share of the traced window in which the device idled while the batcher
dispatched (inside ``serve.batcher.dispatch`` spans, put on the device
trace's clock): the part of ``idle_pct`` that the host causes."""

from benchmark.spans import BATCH, idle_inside, named


def read(r):
    busy, window = r.get("device_busy_ns"), r.get("trace_window_s")
    batches = named(r.get("spans") or (), BATCH)
    if busy is None or not window or not batches:
        return None
    offset = r["span_offset_ns"]
    idle = idle_inside(busy, [s.start_ns + offset for s in batches],
                       [s.end_ns + offset for s in batches])
    return 100.0 * float(idle.sum()) / 1e9 / window
