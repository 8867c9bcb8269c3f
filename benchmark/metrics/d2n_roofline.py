"""Depth -> normal's share of its roofline (see ``_roofline.py``)."""

from benchmark.metrics._roofline import share


def read(r):
    return share(r, "depth_to_normal", ("depth_to_normal_kernel",))
