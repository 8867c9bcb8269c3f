"""The frozen reference and the frozen counts against the port, on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import check, counts, inputs
from benchmark.reference import model as reference
from benchmark.tests import small

MODEL = {"idepth_scale": 3.0, "num_planes": 64, "k_size": 9}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_config():
    from cnmnet_tpu_torch.config import Config, apply_overrides

    return apply_overrides(Config(), [f"dataset.image_height={small.HEIGHT}",
                                      f"dataset.image_width={small.WIDTH}"])


def _check_against(out, ref, cams):
    """The port's float32 outputs equal the reference's to float32 rounding;
    its normals equal the reference's fit of the port's own depth (the fit
    is ill-conditioned: two depths a rounding apart can give other normals)."""
    assert _rel(out["idepth"], ref["idepth"]) < 1e-5
    assert _rel(out["prob"], ref["prob"]) < 1e-5
    fitted = reference.normals(torch.from_numpy(out["idepth"]), torch.from_numpy(cams), 9).numpy()
    assert check.angles_deg(out["normal"], fitted).mean() < 0.1


def test_reference_equals_the_port_serving_forward():
    from cnmnet_tpu_torch.serve import InferenceSession

    images, cams = inputs.request_pool(3, 2, small.HEIGHT, small.WIDTH, [10, -10], 7, "cpu")
    state = inputs.make_state(64, 7, "cpu")
    session = InferenceSession(_port_config(), state_dict=state, device="cpu",
                               compute_dtype="float32")
    out = session.predict(images, cams)
    with reference.exact_float32():
        ref = reference.forward(state, torch.from_numpy(images), torch.from_numpy(cams), MODEL)
    _check_against(out, {k: v.numpy() for k, v in ref.items()}, cams)
    assert _rel(out["depth"], ref["depth"].numpy()) < 1e-5


@pytest.mark.parametrize("precision,low,high", [("tf32", 1e-5, 3e-3), ("bfloat16", 1e-4, 3e-2),
                                                ("float8", 3e-3, 0.3)])
def test_rounded_reference_departs_by_its_precision(precision, low, high):
    images, cams = inputs.request_pool(2, 2, small.HEIGHT, small.WIDTH, [10, -10], 3, "cpu")
    state = inputs.make_state(64, 3, "cpu")
    args = (state, torch.from_numpy(images), torch.from_numpy(cams), MODEL)
    with reference.exact_float32():
        exact, rounded = reference.forward(*args), reference.forward(*args, precision)
    assert low < _rel(rounded["idepth"].numpy(), exact["idepth"].numpy()) < high


def test_forward_count_reproduces_the_roofline_tools():
    """435.65 GFLOP of convolutions and 0.357 of kernels for the 3-view
    forward at batch 1, 192x256 (PERF.md's roofline table)."""
    net = counts.net_flops(MODEL, 192, 256, 3)
    total = counts.forward_flops(MODEL, 192, 256, 3)
    assert round(net / 1e9, 2) == 435.65
    assert round((total - net) / 1e9, 3) == 0.357


def test_train_count_reproduces_the_roofline_tools():
    """9,797.77 GFLOP for the bf16 train step at batch 8, remat off."""
    assert round(counts.train_step_flops(MODEL, 192, 256, 3, 8) / 1e9, 2) == 9797.77


def test_least_time_is_the_larger_bound():
    flops, nbytes = counts.kernel_cost("cost_volume", (24, 192, 256, 64))
    assert counts.least_seconds("cost_volume", (24, 192, 256, 64)) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))
    flops, nbytes = counts.kernel_cost("depth_to_normal", (4, 192, 256, 9))
    assert nbytes / 3.35e12 > flops / 67e12  # bytes-bound
