"""95th percentile of each request's wait in the batcher's queue: the
program's ``serve.batcher.queue`` spans (submit -> the batch that takes
it) over the window's requests."""

import numpy as np

from benchmark.spans import durations_ms


def read(r):
    waits = durations_ms(r.get("spans") or (), "serve.batcher.queue")
    return float(np.percentile(waits, 95)) if len(waits) else None
