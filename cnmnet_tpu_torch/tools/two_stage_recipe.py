"""The reference's published two-stage training, end to end through the
port's command line (``tools/two_stage_recipe.py``).

The reference trains in two stages (its README): the disparity-only recipe
(``train.py train_wo_normal``), then the full CNM + refinement recipe
resumed from the stage-1 checkpoint. Here, on synthetic data at 32x64 with
8 planes and k = 5:

  stage 1: cli train --wo-normal --synthetic --max-steps N
  stage 2: cli train --synthetic --max-steps 2N  train.resume_dir=<stage 1>

and three checks on what they leave:

* stage 2 resumed: its last checkpoint is at step 2N, past stage 1's N;
* the warm start carried over: stage 2's first logged ``loss_idepth`` (the
  term both recipes optimise) is below stage 1's first;
* each stage left a restorable checkpoint: stage 1's at step N and stage
  2's at step 2N restore into a fresh train state.

Each stage checkpoints only at its exit (``train.ckpt_interval`` past the
run): a checkpoint of the full-width model with its Adam moments is about
530 MB.

    python -m cnmnet_tpu_torch.tools.two_stage_recipe [--steps 6] [--workdir DIR] [--device cuda]

Exit 0 iff all three checks hold; prints one line per check.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

SMOKE_OVERRIDES = [
    "dataset.batch_size=2",
    "dataset.synthetic_size=8",
    "dataset.image_height=32",
    "dataset.image_width=64",
    "model.num_planes=8",
    "model.k_size=5",
    "train.num_epochs=1000",  # max-steps is the stop condition
    "train.ckpt_interval=1000000",  # a checkpoint at each stage's exit only
]


def first_logged(log_dir: str, key: str) -> float:
    """First logged value of a metric in a run's ``events.jsonl``."""
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "scalars" and key in rec:
                return float(rec[key])
    raise RuntimeError(f"no {key} events in {log_dir}")


def restored_steps(ckpt_dirs, device):
    """The step of each directory's newest checkpoint, restored (weights and
    optimizer state) into a fresh model of the smoke configuration (-1 where
    there is none)."""
    from cnmnet_tpu_torch.config import Config, apply_overrides
    from cnmnet_tpu_torch.serve import resolve_device
    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.state import TrainState, build_model

    model = build_model(apply_overrides(Config(), list(SMOKE_OVERRIDES)))
    template = TrainState(model=model.to(resolve_device(device)))
    states = [CheckpointManager(d, device=device).restore("latest", template) for d in ckpt_dirs]
    return [-1 if state is None else state.step for state in states]


def run_two_stage(workdir: str, steps: int, device: str = "cuda") -> dict:
    from cnmnet_tpu_torch.cli import main as cli_main

    dirs = {name: os.path.join(workdir, name)
            for name in ("stage1_ckpt", "stage1_logs", "stage2_ckpt", "stage2_logs")}
    rc = cli_main(["train", "--wo-normal", "--synthetic", "--max-steps", str(steps),
                   "--device", device] + SMOKE_OVERRIDES
                  + [f"train.checkpoint_dir={dirs['stage1_ckpt']}",
                     f"train.log_dir={dirs['stage1_logs']}"])
    if rc != 0:
        raise RuntimeError(f"stage 1 exited {rc}")
    rc = cli_main(["train", "--synthetic", "--max-steps", str(2 * steps), "--device", device]
                  + SMOKE_OVERRIDES
                  + [f"train.resume_dir={dirs['stage1_ckpt']}",
                     f"train.checkpoint_dir={dirs['stage2_ckpt']}",
                     f"train.log_dir={dirs['stage2_logs']}"])
    if rc != 0:
        raise RuntimeError(f"stage 2 exited {rc}")
    stage1_step, stage2_step = restored_steps([dirs["stage1_ckpt"], dirs["stage2_ckpt"]], device)
    return {
        "stage1_step": stage1_step,
        "stage2_step": stage2_step,
        "stage1_first_idepth": first_logged(dirs["stage1_logs"], "loss_idepth"),
        "stage2_first_idepth": first_logged(dirs["stage2_logs"], "loss_idepth"),
    }


def check(results: dict, steps: int) -> int:
    ok = True

    def line(cond, msg):
        nonlocal ok
        print(("PASS " if cond else "FAIL ") + msg)
        ok = ok and cond

    line(results["stage1_step"] == steps,
         f"stage 1 left a restorable checkpoint at step {results['stage1_step']} == {steps}")
    line(results["stage2_step"] == 2 * steps,
         f"stage 2 resumed, ran to and left a restorable checkpoint at step "
         f"{results['stage2_step']} == {2 * steps}")
    line(results["stage2_first_idepth"] < results["stage1_first_idepth"],
         "warm start carried over: stage-2 first loss_idepth "
         f"{results['stage2_first_idepth']:.4f} < stage-1 first "
         f"{results['stage1_first_idepth']:.4f}")
    print(json.dumps({**results, "steps": steps, "ok": ok}))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.workdir:
        print(f"workdir: {args.workdir}")
        return check(run_two_stage(args.workdir, args.steps, args.device), args.steps)
    with tempfile.TemporaryDirectory(prefix="two_stage_") as workdir:
        print(f"workdir: {workdir} (removed at the end)")
        return check(run_two_stage(workdir, args.steps, args.device), args.steps)


if __name__ == "__main__":
    raise SystemExit(main())
