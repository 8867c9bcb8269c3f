"""Share of the frames run on the device that were padding: 100 x (1 -
``frames_real`` / ``frames_run``), the session's counters taken as their
change across the window."""


def read(r):
    if not r.get("frames_run"):
        return None
    return 100.0 * (1.0 - r["frames_real"] / r["frames_run"])
