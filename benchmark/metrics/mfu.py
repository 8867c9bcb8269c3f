"""The window's work by the frozen count (``counts``), over the window and
the peak of the configuration's compute type."""


def read(r):
    if not r.get("work_flops"):
        return None
    return 100.0 * r["work_flops"] / r["window_s"] / r["peak_flops"]
