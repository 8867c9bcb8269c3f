"""Mean ms a chunk of the program's ``serve.session.device_wait`` spans: the
fetch's wait for the event recorded after the wire's copy, the device's time
that the host did not hide."""

from benchmark.spans import mean_ms


def read(r):
    return mean_ms(r, "serve.session.device_wait")
