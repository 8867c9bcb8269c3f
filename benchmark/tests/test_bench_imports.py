"""What a run loads: never JAX nor the JAX package (``cnmnet_tpu``), whose
name the port's (``cnmnet_tpu_torch``) begins with, so top-level names are
compared whole; and the reference loads nothing of the program."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HARNESS = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in (ROOT / "benchmark").rglob("*.py")
    if "tests" not in p.parts and p.name != "__init__.py" and not p.name.startswith("_"))
# the program modules the drivers import inside their functions
PROGRAM = ("cnmnet_tpu_torch.serve", "cnmnet_tpu_torch.config",
           "cnmnet_tpu_torch.kernels.dispatch")


def _top_level_after(modules):
    code = ("import importlib, sys\n"
            f"for m in {list(modules)!r}:\n"
            "    importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_lists_every_module():
    assert "benchmark.run" in HARNESS and "benchmark.reference.model" in HARNESS
    assert "benchmark.drivers.open_loop" in HARNESS and "benchmark.metrics.mfu" in HARNESS


def test_harness_and_program_load_no_jax():
    loaded = _top_level_after(HARNESS + list(PROGRAM))
    assert "cnmnet_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "cnmnet_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(["benchmark.reference.model", "benchmark.reference.geometry",
                               "benchmark.counts"])
    assert "cnmnet_tpu_torch" not in loaded and "cnmnet_tpu" not in loaded


def test_forbidden_names_are_compared_whole():
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules["cnmnet_tpu_torch_fake"] = sys
        sys.modules.pop("cnmnet_tpu", None)
        sys.modules.pop("jax", None)
        assert run.forbidden_modules() == []
        sys.modules["cnmnet_tpu.fake"] = sys
        assert run.forbidden_modules() == ["cnmnet_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
