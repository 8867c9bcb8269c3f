"""The cost volume's share of its roofline (see ``_roofline.py``): its
source pack and its sweep."""

from benchmark.metrics._roofline import share


def read(r):
    return share(r, "cost_volume", ("cost_volume_kernel", "pack_source_kernel"))
