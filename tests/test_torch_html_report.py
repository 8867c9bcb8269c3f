"""The port's ``evals/html_report.py`` against the JAX package's: the same
HTML, byte for byte, over an artifact tree written by the port's
``evaluate_seven_scenes(save_dir=)`` saver, through the functions and
through ``cli report``."""

import glob
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from cnmnet_tpu import cli as jcli  # noqa: E402
from cnmnet_tpu.evals import html_report as jreport  # noqa: E402
from cnmnet_tpu_torch import cli  # noqa: E402
from cnmnet_tpu_torch.evals import html_report as report  # noqa: E402
from cnmnet_tpu_torch.evals.seven_scenes_eval import _save_frame_artifacts  # noqa: E402

SEQS = (("chess", "seq-03"), ("fire", "seq-04"))


def _artifacts(run, seed):
    """Three frames per sequence; the last frame of each has no prob map
    (a two-view protocol's frames), so its row shows a dash."""
    rng = np.random.default_rng(seed)
    for scene, seq in SEQS:
        for i in range(3):
            p = {"scene": scene, "seq": seq, "name": f"frame-{10 * i:06d}",
                 "images": rng.normal(0, 1, (3, 8, 12, 3)).astype(np.float32),
                 "gt_depth": rng.uniform(0.5, 4, (8, 12)).astype(np.float32)}
            idepth = rng.uniform(0.1, 1, (8, 12)).astype(np.float32)
            normal = rng.normal(0, 1, (8, 12, 3)).astype(np.float32)
            prob = rng.uniform(0, 1, (8, 12)).astype(np.float32) if i < 2 else None
            _save_frame_artifacts(str(run), p, idepth, prob, normal)
    (run / "notes.txt").write_text("not a scene\n")


def _html(run):
    return {os.path.relpath(p, run): open(p, "rb").read()
            for p in sorted(glob.glob(f"{run}/**/*.html", recursive=True))}


@pytest.fixture()
def runs(tmp_path):
    a, b = tmp_path / "run_a", tmp_path / "run_b"
    _artifacts(a, 0)
    _artifacts(b, 1)
    return a, b


@pytest.mark.parametrize("width", [256, 0])
def test_write_report_bytes_equal_jax(runs, width):
    run = runs[0]
    pages = report.write_report(str(run), image_width=width)
    ours = _html(run)
    assert jreport.write_report(str(run), image_width=width) == pages
    assert _html(run) == ours
    assert len(pages) == len(SEQS) and len(ours) == len(SEQS) + 1
    page = ours[os.path.join("chess", "seq-03", "index.html")].decode()
    assert page.count("<img") == 3 * 5 - 1 and "—" in page  # one prob map missing


def test_write_comparison_bytes_equal_jax(runs, tmp_path):
    a, b = runs
    out = str(tmp_path / "cmp.html")
    kw = dict(labels=["a", "b"], kinds=("pred_depth", "prob_map"), image_width=128)
    assert report.write_comparison(out, [str(a), str(b)], **kw) == out
    ours = open(out, "rb").read()
    jreport.write_comparison(out, [str(a), str(b)], **kw)
    assert open(out, "rb").read() == ours
    assert ours.count(b"<img") == len(SEQS) * (3 * 2 + 3 * 2 * 2 - 2)


@pytest.mark.parametrize("compare", [False, True])
def test_cli_report_equals_jax(runs, capsys, compare):
    a, b = runs
    argv = ["report", str(a)] + (["--compare", str(b)] if compare else [])
    assert cli.main(argv) == 0
    ours, printed = _html(a), capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert capsys.readouterr().out == printed
    assert _html(a) == ours
    if compare:
        assert printed == f"wrote {os.path.join(str(a), 'comparison.html')}\n"
    else:
        assert printed == f"wrote {len(SEQS)} sequence pages + index under {a}\n"
