"""A hand kernel's share of its roofline: the least time of every call of
its entry in the traced window (``counts.least_seconds`` of the call's
shapes) over the device time of the kernels whose names hold one of its
fragments. With no call, or no such kernel on the device, there is nothing
to read."""

from benchmark import counts


def share(r, entry, fragments):
    calls = (r.get("kernel_calls") or {}).get(entry)
    seconds = sum(s for name, s in (r.get("device_kernels") or {}).items()
                  if any(f in name for f in fragments))
    if not calls or not seconds:
        return None
    return 100.0 * sum(counts.least_seconds(entry, shape, nbytes) for shape, nbytes in calls) / seconds
