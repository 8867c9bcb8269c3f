"""The port's recipe tools end to end on the CPU.

* ``two_stage_recipe`` at 32x64 (8 planes, k = 5; two steps a stage, the
  fewest that log a loss before the last step)
  passes its three checks: stage 2 resumed past stage 1's step, its first
  ``loss_idepth`` is below stage 1's first, and each stage left a
  checkpoint that restores into a fresh train state.

``train_synth`` and ``visualize`` run on the card in ``chip_smoke.py``
phase 12; a full-width train state costs seconds to build on the CPU, so
the recipe test is the one that builds it here.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cnmnet_tpu_torch.tools import two_stage_recipe  # noqa: E402
from tests.test_torch_tools import run  # noqa: E402


def test_two_stage_recipe_passes_its_checks(tmp_path):
    rc, lines, (row,) = run(two_stage_recipe.main, ["--steps", "2", "--device", "cpu",
                                                    "--workdir", str(tmp_path)])
    assert rc == 0 and row["ok"], lines
    assert (row["stage1_step"], row["stage2_step"]) == (2, 4)
    assert row["stage2_first_idepth"] < row["stage1_first_idepth"]
    assert [line.split()[0] for line in lines if line.startswith(("PASS", "FAIL"))] == ["PASS"] * 3
    # each stage checkpointed at its exit only
    assert sorted(p.name for p in (tmp_path / "stage1_ckpt").iterdir()) == ["2"]
    assert sorted(p.name for p in (tmp_path / "stage2_ckpt").iterdir()) == ["4"]


def test_two_stage_check_fails_without_a_warm_start(capsys):
    results = {"stage1_step": 3, "stage2_step": 6, "stage1_first_idepth": 1.0,
               "stage2_first_idepth": 1.5}
    assert two_stage_recipe.check(results, 3) == 1
    assert capsys.readouterr().out.splitlines()[2].startswith("FAIL warm start")
