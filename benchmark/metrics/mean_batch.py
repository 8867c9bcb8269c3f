"""Requests per forward in the window: the batcher's ``served`` over its
``dispatched`` counter, both taken as their change across the window."""


def read(r):
    return r["served"] / r["dispatched"] if r.get("dispatched") else None
