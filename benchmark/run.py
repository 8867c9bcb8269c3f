"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
A cell names a configuration (``configs/<name>.json``: sizes and
precisions) and a traffic mix (``traffic/<name>.json``: parameters and the
driver in ``drivers/`` that runs them); its limits are in
``limits/<cell>.json`` and each metric has a reader in ``metrics/`` (its
full name, or the part before the first dot). Adding a cell, a
configuration, a traffic mix or a metric is adding files.

A run: set-up (imports, the kernels' build or load, seeded inputs and
weights, warm-up of the cell's own shapes; ``setup_s``), the window of
``--seconds``, then the comparison of a sample of what the window produced
with the plain reference (``check.py``). ``--trace 1`` traces the window
(``trace.py``) and reports the cell's per-layer metrics instead of its
end-to-end ones. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.

Exits 2, printing no result, without CUDA or with fewer cards than the
cell asks for, and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cnmnet_tpu")


class Spec(NamedTuple):
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: list  # BENCHMARK.json entries reported by this cell, end-to-end then per-layer


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(workload: str, root: Path = ROOT, here: Path = HERE) -> Spec:
    bench = _json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = _json(root / conf["file"])
    traffic = _json(here / "traffic" / f"{cell['traffic']}.json")
    limits = _json(here / "limits" / f"{workload}.json")
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
               for m in bench[kind] if workload in m.get("workloads", [workload])]
    return Spec(cell, config, traffic, limits, metrics)


def reader(name: str, here: Path = HERE):
    """The ``read(readings)`` of metric ``name``: ``metrics/<name>.py``, or
    ``metrics/<part before the first dot>.py``."""
    for stem in (name, name.split(".")[0]):
        path = here / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise SystemExit(f"no reader for metric {name!r} under {here / 'metrics'}")


class Window:
    """The measured window: ``setup_s`` ends and the clock ``t0`` starts at
    entry, ``t1`` is taken at exit. With ``trace`` the device trace and the
    recorder of kernel calls start just before ``t0``, while nothing else
    launches work on the card, and run until the driver calls
    ``end_trace()`` once the card is quiet again (a driver with a thread of
    the program's in flight ends it after that thread has drained): the
    profiler is started and stopped only while no other thread launches,
    which it does not survive reliably. Reading the trace comes after."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.t0 = self.t1 = self.traced = None
        self.trace = self.kernels = None

    def __enter__(self):
        if self.ctx.trace:
            from benchmark.trace import DeviceTrace, KernelCalls

            self.kernels = KernelCalls().__enter__()
            self.trace = DeviceTrace().__enter__()
        self.t0 = time.perf_counter()
        self.ctx.setup_s = self.t0 - self.ctx.t_start
        self.ctx.windows.append(self)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        return False

    def end_trace(self) -> None:
        if self.trace is not None and self.traced is None:
            self.traced = time.perf_counter() - self.t0
            self.trace.__exit__(None, None, None)
            self.kernels.__exit__(None, None, None)


class Context:
    """What a driver gets: the cell's configuration and traffic, the run's
    seed, window length, trace flag and device, and ``window()``."""

    def __init__(self, spec: Spec, seed: int, seconds: float, trace: bool, device: str,
                 t_start: float):
        self.config, self.traffic = spec.config, spec.traffic
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), trace, device
        self.views = 1 + len(spec.config["sources"])
        self.t_start = t_start
        self.setup_s = None
        self.windows = []

    def window(self) -> Window:
        return Window(self)

    def mark(self, step: str) -> None:
        """Note on standard error how far set-up has come."""
        print(f"set-up: {step} done at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr)


def _finite(x):
    return x if x is None or math.isfinite(x) else None


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """One run of the cell; returns the result object."""
    import torch

    from benchmark import check

    ctx = Context(spec, seed, seconds, trace, device, T_START if t_start is None else t_start)
    driver = importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")
    readings = driver.run(ctx)
    (window,) = ctx.windows
    window.end_trace()
    readings["setup_s"] = ctx.setup_s
    readings["window_s"] = seconds
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(spec.cell["chips"]),
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    breakdown = None
    if window.trace is not None:
        summary = window.trace.summary(window.traced)
        readings["busy_s"], readings["trace_window_s"] = summary["busy_s"], summary["window_s"]
        readings["device_kernels"] = summary["device_kernels"]
        readings["kernel_calls"] = window.kernels.calls
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        breakdown = summary["breakdown"]
    sample = readings.pop("check")
    del window, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, checks = check.judge(sample, spec.config, spec.limits)
    print(f"the comparison with the reference took {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    correct = correct and readings["failed"] == 0
    metrics = {}
    for m in spec.metrics:
        if (m["kind"] == "per_layer") != bool(trace):
            continue
        value = reader(m["name"])(readings)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(readings["attempted"]),
              "failed": int(readings["failed"]), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    # every cache the program or its libraries keep stays inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(HERE / ".cache" / "triton"))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(spec.cell["chips"]):
        print(f"{spec.cell['name']} needs {spec.cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
