"""Mean ms a chunk of the program's ``serve.session.forward`` spans: the
forward's host time, which is the model's and the kernels' launches."""

from benchmark.spans import mean_ms


def read(r):
    return mean_ms(r, "serve.session.forward")
