"""The model step's share of the card's peak while the card works: the frozen
count (``counts``) of every request answered in the traced span (the window
and its drain) over the traced busy time and the peak of the configuration's
compute type. Below capacity the answered rate is the offered rate, so the
share is taken over the busy time and not over the window."""


def read(r):
    if not r.get("busy_s") or not r.get("request_flops"):
        return None
    return 100.0 * r["answered"] * r["request_flops"] / r["busy_s"] / r["peak_flops"]
