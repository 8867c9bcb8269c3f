"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 11,12,13 [--seconds 3]

For each seed: one short window of the cell's own traffic at its own load,
then the numbers of ``check.py`` twice over the same sample: the program's
outputs against the reference (the lower readings), and the control's,
the reference itself in the program's place, one step below each
precision the configuration states (``control`` in its file: the
convolutions' operands in float8 under bfloat16, in bfloat16 under TF32;
the normals' float32 fit in bfloat16), judged the same way (the upper
readings). One JSON line a seed, then each number's largest program reading
and smallest control reading. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch


def readings(spec, seed: int, seconds: float, device: str = "cuda"):
    """``(program numbers, control numbers, frames compared)`` of one short
    window."""
    from benchmark import check, run

    ctx = run.Context(spec, seed, seconds, False, device, run.T_START)
    driver = importlib.import_module(f"benchmark.drivers.{spec.traffic['driver']}")
    sample = driver.run(ctx)["check"]
    ref = check.reference_outputs(sample, spec.config)
    stated = check.reference_outputs(sample, spec.config, spec.config["stated"])
    ctl = spec.config["control"]
    control = check.reference_outputs(sample, spec.config, ctl["convs"], getattr(torch, ctl["fit"]))
    names = tuple(spec.limits)
    return (check.numbers(sample, spec.config, sample["outputs"], ref, stated, names),
            check.numbers(sample, spec.config, control, ref, stated, names), len(sample["images"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from benchmark import run

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_spec(args.workload)
    low, high = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        prog, ctl, n = readings(spec, seed, args.seconds)
        print(json.dumps({"seed": seed, "frames": n, "program": prog, "control": ctl}), flush=True)
        for k in prog:
            low[k] = max(low.get(k, 0.0), prog[k])
            high[k] = min(high.get(k, float("inf")), ctl[k])
    print(json.dumps({"workload": args.workload, "control": spec.config["control"],
                      "lower": low, "upper": high, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
