"""Share of the traced window in which no operation ran on the device."""


def read(r):
    if not r.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["trace_window_s"])
