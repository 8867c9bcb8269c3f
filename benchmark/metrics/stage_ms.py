"""Mean ms a chunk of the program's ``serve.session.stage`` spans: padding to
the bucket, the copy into pinned memory and the uploads' enqueue."""

from benchmark.spans import mean_ms


def read(r):
    return mean_ms(r, "serve.session.stage")
