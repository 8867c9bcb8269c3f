"""Set-up seconds: process start to the window's first request or flush
(imports, the kernels' build or load, seeded inputs and weights, warm-up)."""


def read(r):
    return r["setup_s"]
