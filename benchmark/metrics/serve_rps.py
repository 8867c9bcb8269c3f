"""Requests answered inside the window, over the window."""


def read(r):
    return r["answered_in_window"] / r["window_s"] if "answered_in_window" in r else None
