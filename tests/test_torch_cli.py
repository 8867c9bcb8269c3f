"""The port's command line (``cnmnet_tpu_torch/cli.py``) on the CPU, at
32x64 with 8 planes and k = 5 (``--device cpu``).

* The parser: every subcommand the port shares with the JAX CLI has the
  JAX parser's arguments, defaults, types, choices and nargs, plus
  ``--device``; dotted overrides give the JAX config.
* ``train``, ``eval``, ``cal-metrics``, ``eval-scannet``, ``infer`` and
  ``export-tb`` run end to end and are held to the port functions that the
  other port tests hold to the JAX package: ``train_loop`` (the same logged
  losses and checkpointed weights), ``evaluate_seven_scenes`` and
  ``cal_metrics`` (the same metrics), ``evaluate_scannet`` and
  ``evaluate_scannet_planes``, ``InferenceSession.predict`` (equal
  ``.pred.npz`` arrays), and ``events.jsonl`` (the exported scalars).
  No JAX model is compiled here.
* Without a card the default device raises; a training configuration with
  a tile axis reaches the process group.
"""

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cnmnet_tpu import cli as jcli  # noqa: E402
from cnmnet_tpu import config as jconfig  # noqa: E402
from cnmnet_tpu_torch import cli  # noqa: E402
from cnmnet_tpu_torch.config import Config, apply_overrides, to_dict  # noqa: E402
from cnmnet_tpu_torch.data.imageio import write_png  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import normalize_images  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes, train_data_fn  # noqa: E402
from cnmnet_tpu_torch.evals import cal_metrics as tcal  # noqa: E402
from cnmnet_tpu_torch.evals import scannet_eval as tscannet  # noqa: E402
from cnmnet_tpu_torch.evals import seven_scenes_eval as teval  # noqa: E402
from cnmnet_tpu_torch.obs.tb_export import parse_proto, read_records  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession  # noqa: E402
from cnmnet_tpu_torch.train.loop import train_loop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["dataset.image_height=32", "dataset.image_width=64", "model.num_planes=8",
         "model.k_size=5"]
TRAIN = SMALL + ["dataset.batch_size=2", "dataset.synthetic_size=32", "train.print_interval=1",
                 "train.seed=5"]


def _subcommands(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _arguments(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs, a.required,
                     type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax_on_the_shared_subcommands(monkeypatch):
    ours = _subcommands(cli.build_parser())
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", lambda self, *a, **k: self)
    theirs = _subcommands(jcli._parse([]))
    assert set(ours) <= set(theirs)
    for name, sp in ours.items():
        got = _arguments(sp)
        if name in ("train", "eval", "eval-scannet", "infer", "bench"):  # they run the model
            assert got.pop("device") == (("--device",), "cuda", None, None, None, False,
                                         "_StoreAction")
        if name == "bench":  # the options of the JAX bench.py's own parser (bench.py:99-101)
            for dest, default in (("height", 192), ("width", 256)):
                assert got.pop(dest) == ((f"--{dest}",), default, int, None, None, False,
                                         "_StoreAction")
        assert got == _arguments(theirs[name]), name


@pytest.mark.parametrize("argv", [
    ["train", "--synthetic", "dataset.batch_size=2", "solver.grad_clip_norm=none"],
    ["eval", "--views", "5", "model.num_planes=8", "train.steps_per_epoch=3"],
    ["eval-scannet", "--synthetic", "model.use_refiner=false", "solver.lr=5e-4"],
    ["infer", "--inputs", "x/*.npz", "--out-dir", "y", "train.resume_dir=/r"],
])
def test_overrides_give_the_jax_config(argv):
    ours = cli._build_config(cli.build_parser().parse_args(argv))
    theirs = jcli._build_config(jcli._parse(argv))
    assert to_dict(ours) == jconfig.to_dict(theirs)


@pytest.mark.parametrize("argv", [
    ["prep-cameras", "--scene-dir", "s"],
    ["prep-cameras", "--scene-dir", "s", "--out-width", "320", "--out-height", "240"],
    ["prep-planes", "--scene-dir", "s", "--num-workers", "2", "--limit", "5"],
    ["prep-list", "--root-dir", "r", "--out", "l.txt"],
    ["prep-list", "--root-dir", "r", "--out", "l.txt", "--interval", "20", "--view-num", "5",
     "--frame-stride", "10"],
    ["report", "runs/a"],
    ["report", "runs/a", "--compare", "runs/b", "runs/c", "--image-width", "128"],
])
def test_offline_commands_parse_as_jax(argv):
    """The offline tools take the JAX parser's arguments and defaults, and no
    ``--device``: they compute on the host."""
    ours = vars(cli.build_parser().parse_args(argv))
    assert ours == vars(jcli._parse(argv)) and "device" not in ours
    assert cli.COMMANDS[argv[0]].__name__ == "cmd_" + argv[0].replace("-", "_")


@pytest.mark.parametrize("argv", [
    ["train", "--synthetic", "--max-steps", "1"] + SMALL,
    ["eval", "dataset.root_dir=/nowhere"] + SMALL,
    ["eval-scannet", "--synthetic"] + SMALL,
    ["infer", "--inputs", os.path.join(ROOT, "tests", "*.py"), "--out-dir", "unused"] + SMALL,
])
def test_the_default_device_needs_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv)


def test_multi_process_training_waits_for_the_distribution_slice(tmp_path, monkeypatch):
    """Multi-process training runs, a tile axis included
    (``tests/test_torch_ranks.py``):
    ``parallel.tile_axis=2`` reaches the process group with a coordinator
    address, and without one it raises before anything runs, since its rows
    split over that many processes."""
    seen = []

    def join(cfg, device):
        seen.append(cfg.parallel.tile_axis)
        raise RuntimeError("joined")

    monkeypatch.setattr(cli, "_join_processes", join)
    with pytest.raises(RuntimeError, match="joined"):
        cli.main(["train", "--synthetic", "--device", "cpu", "parallel.coordinator_address=h:1",
                  "parallel.tile_axis=2", f"train.log_dir={tmp_path}/logs"])
    assert seen == [2]
    with pytest.raises(ValueError, match="parallel.coordinator_address"):
        cli.main(["train", "--synthetic", "--device", "cpu", "parallel.tile_axis=2",
                  f"train.log_dir={tmp_path}/logs"])


def test_python_dash_m_runs_the_cli():
    out = subprocess.run([sys.executable, "-m", "cnmnet_tpu_torch.cli", "--help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in cli.COMMANDS:
        assert name in out.stdout


def _config(overrides):
    return apply_overrides(Config(), list(overrides))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --synthetic --max-steps 2`` into a fresh directory; the
    checkpoint (a whole CNMModel with Adam moments, some 540 MB) is removed
    after the module."""
    d = tmp_path_factory.mktemp("cli")
    run = [f"train.log_dir={d}/logs", f"train.checkpoint_dir={d}/ckpt"]
    assert cli.main(["train", "--synthetic", "--max-steps", "2", "--device", "cpu"]
                    + TRAIN + run) == 0
    yield d, run
    shutil.rmtree(d / "ckpt", ignore_errors=True)


def test_train_matches_train_loop(trained):
    d, run = trained
    with open(d / "logs" / "events.jsonl") as f:
        records = [json.loads(line) for line in f]
    scalars = [r for r in records if r["type"] == "scalars"]
    assert [r["step"] for r in scalars] == [1]  # step 2 ends the run before its log line
    assert sorted(r["tag"] for r in records if r["type"] == "histogram") == \
        ["pred_idepth_01", "prob_map"]
    images = sorted(os.path.relpath(p, d / "logs") for p in glob.glob(f"{d}/logs/images/*/*.png"))
    assert images == [f"images/{t}/00000001.png" for t in sorted(
        ["rgb", "gt_idepth", "gt_normal", "pred_idepth_01", "pred_idepth_refined", "prob_map"])]
    cfg = _config(TRAIN + run + ["dataset.synthetic=true"])
    with open(d / "logs" / "config.json") as f:
        assert json.load(f) == json.loads(json.dumps(to_dict(cfg), default=str))

    from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
    from cnmnet_tpu_torch.train.state import create_train_state

    mgr = CheckpointManager(f"{d}/ckpt", device="cpu")
    assert mgr.all_steps() == [2]  # ckpt_interval: 16 batches an epoch / 8
    restored = mgr.restore("latest", create_train_state(cfg, 99, "cpu"))
    logged = []

    class Logger:
        def log_scalars(self, step, values, prefix=""):
            logged.append(values)

        def log_image(self, step, tag, image):
            pass

        def log_histogram(self, step, tag, values):
            pass

    cfg.train.ckpt_interval = 2
    state = train_loop(cfg, train_data_fn(cfg), logger=Logger(), max_steps=2, device="cpu")
    assert restored.step == state.step == 2
    want = {k: v for k, v in logged[0].items() if k != "step_time"}
    assert {k: scalars[0][k] for k in want} == want
    a, b = state.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _write_sequence(root, frames=26, h=48, w=64):
    """One 7-Scenes test sequence (chess/seq-03) of small frames: a sliding
    texture, a depth of 2 m plus 2.5 cm a frame, a camera moving 1 cm a
    frame."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[:h, :w + frames]
    tex = np.stack([128 + 90 * np.sin(x / 5.0 + y / 7.0), 128 + 90 * np.cos(x / 9.0 - y / 4.0),
                    128 + 80 * np.sin((x + y) / 3.0)], -1)
    tex = np.clip(tex + rng.normal(0, 10, tex.shape), 0, 255).astype(np.uint8)
    seq = os.path.join(root, "chess", "seq-03")
    os.makedirs(seq)
    for i in range(frames):
        name = os.path.join(seq, f"frame-{i:06d}")
        write_png(f"{name}.color.png", np.ascontiguousarray(tex[:, i:i + w]))
        write_png(f"{name}.depth.png", np.full((h, w), 2000 + 25 * i, np.uint16))
        pose = np.eye(4)
        pose[0, 3] = 0.01 * i
        np.savetxt(f"{name}.pose.txt", pose)


def _restored(run):
    return cli._restored_model(_config(SMALL + run), "latest")


@pytest.fixture(scope="module")
def evaluated(trained):
    """``eval --views 3 --checkpoint latest --save-dir`` on a mock tree, with
    the metrics that ``evaluate_seven_scenes`` returned inside the CLI."""
    d, run = trained
    root = str(d / "7scenes")
    _write_sequence(root)
    seen = []
    real = teval.evaluate_seven_scenes

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    teval.evaluate_seven_scenes = spy
    try:
        assert cli.main(["eval", "--views", "3", "--checkpoint", "latest", "--device", "cpu",
                         "--max-frames-per-seq", "8", "--save-dir", str(d / "artifacts"),
                         f"dataset.root_dir={root}"] + SMALL + run) == 0
    finally:
        teval.evaluate_seven_scenes = real
    return root, str(d / "artifacts"), seen[0]


def test_eval_matches_evaluate_seven_scenes(trained, evaluated):
    _, run = trained
    root, _, got = evaluated
    fwd = teval.make_eval_forward(_restored(run), k_size=5, device="cpu")
    want = teval.evaluate_seven_scenes(fwd, root, num_sources=2, image_height=32, image_width=64,
                                       max_frames_per_seq=8)
    assert got["frames"] == want["frames"] == 2.0
    for k in want:
        if k != "seconds_per_frame":
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-12), k


def test_cal_metrics_rescores_the_eval_artifacts(evaluated, capsys):
    _, artifacts, _ = evaluated
    capsys.readouterr()
    assert cli.main(["cal-metrics", artifacts]) == 0
    printed = capsys.readouterr().out.splitlines()
    want = tcal.cal_metrics(artifacts, write_txt=False)
    assert printed == [f"{k}: {v:.4f}" for k, v in want.items()] + \
        [f"wrote {artifacts}/evaluation_errors.txt"]
    assert os.path.isfile(os.path.join(artifacts, "evaluation_errors.txt"))


def test_eval_scannet_matches_the_evals(trained, capsys):
    _, run = trained
    capsys.readouterr()
    assert cli.main(["eval-scannet", "--synthetic", "--planes", "--max-samples", "2",
                     "--checkpoint", "latest", "--device", "cpu",
                     "dataset.synthetic_size=2"] + SMALL + run) == 0
    printed = capsys.readouterr().out.splitlines()
    cfg = _config(SMALL)
    scenes = SyntheticScenes(num_samples=2, height=32, width=64, view_num=3, seed=cfg.train.seed)

    class Normalized:
        def __len__(self):
            return len(scenes)

        def __getitem__(self, i):
            return {**scenes[i], "images": normalize_images(scenes[i]["images"])}

    fwd = teval.make_eval_forward(_restored(run), k_size=5, device="cpu")
    depth = tscannet.evaluate_scannet(fwd, Normalized(), max_samples=2)
    planes = tscannet.evaluate_scannet_planes(fwd, Normalized(), max_samples=2)
    assert depth["frames"] == 2
    assert printed == [f"{k}: {v:.4f}" for r in (depth, planes) for k, v in r.items()]


def test_infer_writes_the_session_predictions(trained, tmp_path):
    d, run = trained
    scenes = SyntheticScenes(num_samples=3, height=32, width=64, view_num=3, seed=8)
    frames = [scenes[i] for i in range(3)]
    for i, f in enumerate(frames):
        np.savez(tmp_path / f"frame{i}.npz", images=(f["images"] * 255).astype(np.uint8),
                 cams=f["cams"])
    assert cli.main(["infer", "--inputs", str(tmp_path / "*.npz"), "--out-dir",
                     str(tmp_path / "out"), "--batch", "2", "--checkpoint", "latest",
                     "--device", "cpu"] + SMALL + run) == 0
    session = InferenceSession(_config(SMALL + run), checkpoint="latest", batch_buckets=(1, 2),
                               device="cpu")
    want = {}
    for batch in ([0, 1], [2]):  # the CLI's flushes
        images = np.stack([np.load(tmp_path / f"frame{i}.npz")["images"] for i in batch])
        cams = np.stack([np.load(tmp_path / f"frame{i}.npz")["cams"] for i in batch])
        out = session.predict(images, cams)
        want.update({i: {k: v[j] for k, v in out.items()} for j, i in enumerate(batch)})
    for i in range(3):
        with np.load(tmp_path / "out" / f"frame{i}.pred.npz") as z:
            assert set(z.files) == {"idepth", "depth", "prob", "normal"}
            for k in z.files:
                np.testing.assert_array_equal(z[k], want[i][k])


def test_export_tb_carries_the_logged_scalars(trained):
    d, _ = trained
    assert cli.main(["export-tb", str(d / "logs"), "--out", str(d / "tb")]) == 0
    (path,) = glob.glob(str(d / "tb" / "events.out.tfevents.*"))
    with open(d / "logs" / "events.jsonl") as f:
        scalars = [json.loads(line) for line in f]
    scalars = [r for r in scalars if r["type"] == "scalars"]
    exported = []
    for rec in read_records(path):
        event = parse_proto(rec)
        if 5 not in event:
            continue
        values = [parse_proto(v) for v in parse_proto(event[5][0])[1]]
        if all(2 in v for v in values):  # simple_value: a scalar event
            exported.append((event[2][0], {v[1][0].decode(): v[2][0] for v in values}))
    want = [(r["step"], {k: float(np.float32(v)) for k, v in r.items()
                         if k not in ("step", "time", "type")}) for r in scalars]
    assert exported == want
