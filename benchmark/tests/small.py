"""The cells of ``BENCHMARK.json`` for the CPU tests, cut to a size the CPU
runs in seconds: the same widths and traffic shape, small images and a low
rate."""

from benchmark import run

HEIGHT, WIDTH = 32, 64


def spec(workload: str, rate: float = 8.0, **traffic) -> run.Spec:
    s = run.load_spec(workload)
    s.config.update(image_height=HEIGHT, image_width=WIDTH)
    if "rate_rps" in s.traffic:
        s.traffic["rate_rps"] = rate
    s.traffic.update(traffic)
    return s


def context(s, seed: int = 5, seconds: float = 1.5):
    return run.Context(s, seed, seconds, False, "cpu", run.T_START)
