"""95th percentile of the time from each request's due time on the open-loop
schedule to its answer on the host, over every request due in the window;
a request never answered counts with the time waited for it."""

import numpy as np


def read(r):
    lat = r.get("due_latency_ms")
    return None if lat is None or not len(lat) else float(np.percentile(lat, 95))
