"""The nets in the memory layout of their input (``models/layers.py``).

``CNMModel.nets`` with channels-last conv weights and channels-last inputs
gives the NCHW nets' outputs, and every convolution and bilinear
upsampling inside it reads a channels-last input: no concatenation or
group average falls back to NCHW unseen. With NCHW inputs every such input
stays NCHW, so the CPU, mesh, training and eval paths run what they ran. A
session runs its nets channels-last on one CUDA device with no mesh only;
a CPU session replays no graph (the one-card path). At 32x64 with 8 planes, in
f64 on the CPU, where the two layouts' different sum orders leave ~1e-13
(this file imports no JAX).
"""

import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import collate, quantize_images_u8  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu_torch.models import CNMModel  # noqa: E402
from cnmnet_tpu_torch.models.layers import (  # noqa: E402
    Conv2d,
    Upsample2x,
    init_weights,
    is_channels_last,
    like_layout,
)
from cnmnet_tpu_torch.obs import spans  # noqa: E402
from cnmnet_tpu_torch.ops.images import prepare_images  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession, one_card  # noqa: E402

H, W, P = 32, 64, 8
CL = torch.channels_last
CASES = [(norm, views) for norm in ("batch", "group") for views in (2, 3, 7)]
IDS = [f"{norm}-{views}v" for norm, views in CASES]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _inputs(model, views, n):
    ds = SyntheticScenes(num_samples=n, height=H, width=W, view_num=views, seed=5)
    batch = collate([ds[i] for i in range(n)])
    images = prepare_images(torch.from_numpy(quantize_images_u8(batch["images"])))
    return model.front(images, torch.from_numpy(batch["cams"].astype(np.float32)))


def _watched(model):
    """What every Conv2d and Upsample2x of ``model`` reads, in call order:
    (layer, shape, strides, channels-last, NCHW)."""
    seen = []

    def hook(mod, args):
        x = args[0]
        seen.append((type(mod).__name__, tuple(x.shape), x.stride(),
                     x.is_contiguous(memory_format=CL), x.is_contiguous()))

    for m in model.modules():
        if isinstance(m, (Conv2d, Upsample2x)):
            m.register_forward_pre_hook(hook)
    return seen


@functools.lru_cache(maxsize=None)
def _run(norm):
    """One seeded f64 model's nets, NCHW and channels-last, on the same
    front output at 2, 3 and 7 views (two frames at three views, where the
    group averages fold the samples, else one): ``{views: {layout:
    (outputs, what the watched layers read)}}``."""
    model = CNMModel(num_planes=P, norm=norm)
    init_weights(model, torch.Generator().manual_seed(11))
    model = model.double().eval()
    last = copy.deepcopy(model).to(memory_format=CL)
    seen = {"nchw": _watched(model), "channels_last": _watched(last)}
    runs = {}
    with torch.inference_mode():
        for views in (2, 3, 7):
            ref, volume = _inputs(model, views, 2 if views == 3 else 1)
            runs[views] = {}
            for name, m, args in (("nchw", model, (ref, volume)),
                                  ("channels_last", last, (ref.contiguous(memory_format=CL),
                                                           volume.contiguous(memory_format=CL)))):
                seen[name].clear()
                runs[views][name] = m.nets(*args, views), list(seen[name])
    return runs


def _pairs(a, b):
    for name, x, y in zip(a._fields, a, b):
        if name == "disps":
            yield from ((f"disp{i + 1}", u, v) for i, (u, v) in enumerate(zip(x, y)))
        else:
            yield name, x, y


@pytest.mark.parametrize("norm,views", CASES, ids=IDS)
def test_channels_last_nets_equal_the_nchw_nets(norm, views):
    """Every output of the channels-last nets equals the NCHW nets' to f64
    rounding (the convolutions sum in another order; in f32 the random
    weights amplify that to ~2e-4 of maps in [0, 3]), in the same NHWC
    shapes; a map in the wrong layout would be off by far more."""
    runs = _run(norm)[views]
    (want, _), (got, _) = runs["nchw"], runs["channels_last"]
    assert (got.idepth_refined is None) == (views == 2)
    for name, x, y in _pairs(got, want):
        if y is None:
            assert x is None, name
            continue
        assert x.shape == y.shape and x.dtype == y.dtype == torch.float64, name
        scale = float(y.abs().max())
        torch.testing.assert_close(x, y, rtol=0, atol=1e-10 * max(scale, 1.0), msg=name)


@pytest.mark.parametrize("norm,views", CASES, ids=IDS)
def test_every_conv_and_upsampling_reads_channels_last(norm, views):
    """No layer of the channels-last nets falls back to NCHW: each Conv2d
    and each bilinear upsampling (5 in DepthNet, 3 in each RefineNet
    branch) reads a channels-last input."""
    _, seen = _run(norm)[views]["channels_last"]
    assert sum(layer == "Upsample2x" for layer, *_ in seen) == (5 if views == 2 else 11)
    bad = [r for r in seen if not r[3]]
    assert not bad, bad


@pytest.mark.parametrize("norm,views", CASES, ids=IDS)
def test_nchw_inputs_keep_every_layer_nchw(norm, views):
    """With NCHW weights and inputs (the CPU and mesh sessions, the trainer,
    the eval driver) every Conv2d and upsampling reads an NCHW input."""
    _, seen = _run(norm)[views]["nchw"]
    assert seen
    bad = [r for r in seen if not r[4]]
    assert not bad, bad


@pytest.mark.parametrize("c", [1, 5])
def test_like_layout_copies_only_where_the_layouts_differ(c):
    """``like_layout`` returns its argument where the layouts agree, and
    otherwise the same values with the other's strides: a 1-channel map
    with NHWC strides, which ``torch.cat`` then keeps channels-last."""
    nchw = torch.arange(2 * c * 3 * 4, dtype=torch.float32).reshape(2, c, 3, 4)
    other = torch.zeros(2, 6, 3, 4)
    assert like_layout(nchw, other) is nchw
    moved = like_layout(nchw, other.contiguous(memory_format=CL))
    assert is_channels_last(moved) and torch.equal(moved, nchw)
    joined = torch.cat([other.contiguous(memory_format=CL), moved], 1)
    assert joined.is_contiguous(memory_format=CL) and not joined.is_contiguous()
    assert like_layout(moved, other) is not moved and like_layout(moved, other).is_contiguous()


def test_only_one_cuda_device_without_a_mesh_runs_channels_last():
    """The session's rule, from what it observes: its device and its mesh."""
    assert one_card(torch.device("cuda"), None)
    assert not one_card(torch.device("cuda", 0), mesh=object())  # a mesh of ranks
    assert not one_card(torch.device("cpu"), None)


def test_a_cpu_session_runs_nchw_and_counts_no_channels_last_dispatch():
    cfg = Config()
    cfg.model.num_planes, cfg.model.k_size = P, 5
    session = InferenceSession(cfg, seed=0, device="cpu")
    assert not session.one_card
    assert all(m.weight.is_contiguous() for m in session.model.modules() if isinstance(m, Conv2d))
    ds = SyntheticScenes(num_samples=2, height=H, width=W, view_num=3, seed=2)
    batch = collate([ds[i] for i in range(2)])
    u8, cams = quantize_images_u8(batch["images"]), batch["cams"].astype(np.float32)
    spans.enable()
    try:
        session.predict(u8, cams)
        taken = spans.take().spans
    finally:
        spans.disable()
    assert session.graph_replays == 0
    forwards = [s for s in taken if s.name == "serve.session.forward"]
    assert [s.attrs["layout"] for s in forwards] == ["nchw"]
