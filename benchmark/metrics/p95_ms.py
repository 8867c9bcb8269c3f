"""The due-time 95th percentile of a cell above capacity, where the queue
grows through the window: recorded, never judged."""

from benchmark.metrics.serve_p95_ms import read  # noqa: F401
