"""The published seven-view configuration (``benchmark/configs/
cnm-7view-192x256.json``: six sources at +10, -10, +5, -5, +20 and -20
frames, each sign's three averaged into one hypothesis) served by the port,
on the CPU at 32x64.

* ``InferenceSession.predict`` in float32 equals the benchmark's plain
  reference (``benchmark/reference``) under ``exact_float32``: idepth, depth
  and prob to float32 rounding, the normals to the reference's fit of the
  port's own depth.
* The configuration's sources are the 7-Scenes protocol's, and the port
  averages {+10, +5, +20} into one hypothesis and {-10, -5, -20} into the
  other.
* The frozen count of its nets: 1,081.37 GFLOP a frame.
* ``benchmark/check.py`` at the cell's limits passes the bf16 program and
  fails one that drops the +-5 and +-20 sources or averages one source a
  group: the comparison sees the six-source mechanism.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import check, counts, inputs, run  # noqa: E402
from benchmark.reference import model as reference  # noqa: E402
from cnmnet_tpu_torch.config import Config, apply_overrides  # noqa: E402
from cnmnet_tpu_torch.evals.seven_scenes_eval import EVAL_PROTOCOLS  # noqa: E402
from cnmnet_tpu_torch.models import CNMModel  # noqa: E402
from cnmnet_tpu_torch.ops.images import prepare_images  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession  # noqa: E402

CELL = "serve-7v-open"
H, W, FRAMES, SEED = 32, 64, 2, 2**31 + 18
SPEC = run.load_spec(CELL)
CONFIG = dict(SPEC.config, image_height=H, image_width=W)
SOURCES = CONFIG["sources"]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _session(dtype):
    m = CONFIG["model"]
    cfg = apply_overrides(Config(), [f"dataset.image_height={H}", f"dataset.image_width={W}",
                                     f"model.idepth_scale={m['idepth_scale']}",
                                     f"model.num_planes={m['num_planes']}",
                                     f"model.k_size={m['k_size']}"])
    state = inputs.make_state(m["num_planes"], SEED, "cpu", getattr(torch, dtype))
    return InferenceSession(cfg, state_dict=state, compute_dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def requests():
    """Two seven-view requests of the cell's kind and the weights in float32."""
    images, cams = inputs.request_pool(FRAMES, 2, H, W, SOURCES, SEED, "cpu")
    return images, cams, inputs.make_state(CONFIG["model"]["num_planes"], SEED, "cpu")


def test_sources_are_the_protocol_and_group_by_sign(requests):
    """The configuration's offsets are the 7-Scenes protocol's six, and the
    port's hypotheses are the means of DepthNet's disparities over the
    positive offsets (+10, +5, +20) and over the negative ones."""
    assert tuple(SOURCES) == EVAL_PROTOCOLS[6]["offsets"] == (10, -10, 5, -5, 20, -20)
    assert SOURCES[0::2] == [10, 5, 20] and SOURCES[1::2] == [-10, -5, -20]
    images, cams, _ = requests
    model = CNMModel(num_planes=8).eval()
    with torch.inference_mode():
        out = model(prepare_images(torch.from_numpy(images)), torch.from_numpy(cams))
    disp = out.disps[0]  # [B, 6, H, W, 1], one map a source in the configuration's order
    forward = [i for i, o in enumerate(SOURCES) if o > 0]
    backward = [i for i, o in enumerate(SOURCES) if o < 0]
    torch.testing.assert_close(out.idepth_g1, disp[:, forward].mean(1), rtol=0, atol=1e-6)
    torch.testing.assert_close(out.idepth_g2, disp[:, backward].mean(1), rtol=0, atol=1e-6)
    assert not torch.allclose(out.idepth_g1, disp[:, 0], atol=1e-4)  # three maps, not one


def test_predict_equals_the_reference(requests):
    images, cams, state = requests
    out = _session("float32").predict(images, cams)
    with reference.exact_float32():
        ref = reference.forward(state, torch.from_numpy(images), torch.from_numpy(cams),
                                CONFIG["model"])
    for name in ("idepth", "depth", "prob"):
        assert _rel(out[name], ref[name].numpy()) < 1e-5, name
    fitted = reference.normals(torch.from_numpy(out["idepth"]), torch.from_numpy(cams),
                               CONFIG["model"]["k_size"]).numpy()
    assert check.angles_deg(out["normal"], fitted).mean() < 0.1


def test_net_count_at_seven_views():
    """Six DepthNet pairs (161.43 GFLOP each) and one RefineNet (112.79)."""
    assert round(counts.net_flops(CONFIG["model"], 192, 256, 7) / 1e9, 2) == 1081.37


# -- the comparison sees the six sources ----------------------------------------


def _three_view(session, images, cams):
    """The +-5 and +-20 sources dropped: the reference and +-10 alone."""
    return session.predict(np.ascontiguousarray(images[:, :3]), np.ascontiguousarray(cams[:, :3]))


def _one_a_group(session, images, cams, monkeypatch):
    """Each hypothesis the disparity of one source, +20 and -20 (the last of
    each group), in place of the mean of three."""
    nets = CNMModel.nets

    def last_of_each_group(self, ref, volume, views):
        S = views - 1
        keep = torch.arange(ref.shape[0]).view(-1, S)[:, S - 2:].reshape(-1)
        return nets(self, ref[keep], volume[keep], 3)

    monkeypatch.setattr(CNMModel, "nets", last_of_each_group)
    return session.predict(images, cams)


@pytest.fixture(scope="module")
def judged(requests):
    """The bf16 program's answers (sound and with each fault) and the
    reference's readings of the checked frames, computed once."""
    images, cams, state = requests
    session = _session(CONFIG["serve_dtype"])
    answers = {"sound": session.predict(images, cams),
               "drops_5_and_20": _three_view(session, images, cams)}
    with pytest.MonkeyPatch.context() as mp:
        answers["one_a_group"] = _one_a_group(session, images, cams, mp)
    sample = {"images": images, "cams": cams, "state": state}
    refs = {None: check.reference_outputs(sample, CONFIG),
            CONFIG["stated"]: check.reference_outputs(sample, CONFIG, CONFIG["stated"])}
    return answers, sample, refs


@pytest.mark.parametrize("program", ["sound", "drops_5_and_20", "one_a_group"])
def test_check_at_the_cells_limits_sees_the_six_sources(judged, monkeypatch, program):
    answers, sample, refs = judged
    monkeypatch.setattr(check, "reference_outputs",
                        lambda s, config, precision=None: refs[precision])
    correct, checks = check.judge(dict(sample, outputs=answers[program]), CONFIG, SPEC.limits)
    assert correct == (program == "sound"), checks
