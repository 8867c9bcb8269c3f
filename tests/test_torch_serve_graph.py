"""The serving forward split in two and its nets replayed as a CUDA graph.

On the CPU: ``CNMModel.front`` then ``CNMModel.nets``, on static copies of
the front's outputs as the session's graph holds them (the volume written
into the static buffer through ``out``), equal ``CNMModel.forward`` bit for
bit; a CPU session captures nothing and serves what the model's forward
gives; ``serve.graph_key`` tells every part of a batch's signature apart.

On the card (marked ``card``, skipped without one; this file imports no
JAX, so the card's machine runs it: ``python -m pytest
tests/test_torch_serve_graph.py --noconftest``): the replayed nets against
the eager ones at two, three and seven views, both channels-last, both hand
kernels launching on every dispatch, a replay for every dispatch after
``warmup``, the profiler seeing the kernels inside the graph, every replay
running the 11 bilinear upsamplings as the hand kernel
(``upsample_replayed``), and the channels-last nets leaving layout
transposes and upsampling a small share of the card's time.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import collate, normalize_images, quantize_images_u8  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu_torch.geometry.camera import invert_intrinsics  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch  # noqa: E402
from cnmnet_tpu_torch.models import CNMModel, cast_for_compute  # noqa: E402
from cnmnet_tpu_torch.models.layers import init_weights  # noqa: E402
from cnmnet_tpu_torch.ops.images import prepare_images  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession, graph_key  # noqa: E402

H, W, P, K = 32, 64, 8, 5


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _frames(n, views, h=H, w=W, seed=7):
    ds = SyntheticScenes(num_samples=n, height=h, width=w, view_num=views, seed=seed)
    batch = collate([ds[i] for i in range(n)])
    return quantize_images_u8(batch["images"]), batch["cams"].astype(np.float32)


def _small_cfg():
    cfg = Config()
    cfg.model.num_planes, cfg.model.k_size = P, K
    return cfg


# -- CPU ------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("views", [2, 3, 5, 7])
def test_front_then_nets_on_static_buffers_equal_forward(views, dtype):
    """The session's graph path on the CPU: the first batch's front output
    cloned into static buffers, a second batch's volume written into the
    static one through ``out`` and its reference copied in, the nets on the
    buffers: every output equals ``forward`` on the second batch."""
    model = CNMModel(num_planes=P)
    init_weights(model, torch.Generator().manual_seed(3))
    model = cast_for_compute(model, dtype, "cpu").eval()
    u8, cams = _frames(4, views)
    first = prepare_images(torch.from_numpy(u8[:2])), torch.from_numpy(cams[:2])
    second = prepare_images(torch.from_numpy(u8[2:])), torch.from_numpy(cams[2:])
    with torch.inference_mode():
        ref, volume = (t.clone() for t in model.front(*first))
        got_ref, got_volume = model.front(*second, volume_out=volume)
        assert got_volume.data_ptr() == volume.data_ptr()
        ref.copy_(got_ref)
        got = model.nets(ref, volume, views)
        want = model(*second)
    assert (want.idepth_refined is None) == (views == 2)
    for name, a, b in zip(want._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        for x, y in zip(a if name == "disps" else [a], b if name == "disps" else [b]):
            assert x.dtype == y.dtype and torch.equal(x, y), name


def test_front_into_a_static_volume_through_the_benchmarks_call_recorder():
    """The front's cost volume into a static buffer passes through the
    benchmark's recorder of ``dispatch.cost_volume`` calls (a traced run
    wraps that entry), which records its shape."""
    from benchmark.trace import KernelCalls

    model = cast_for_compute(CNMModel(num_planes=P), torch.bfloat16, "cpu").eval()
    u8, cams = _frames(2, 3)
    x, c = prepare_images(torch.from_numpy(u8)), torch.from_numpy(cams)
    with torch.inference_mode():
        _, volume = (t.clone() for t in model.front(x, c))
        with KernelCalls() as calls:
            _, got = model.front(x, c, volume_out=volume)
    assert got.data_ptr() == volume.data_ptr()
    assert calls.calls["cost_volume"] == [((4, H, W, P), 2)]


def test_cpu_session_captures_nothing_and_serves_the_forward():
    """A CPU session runs the nets eagerly: no capture, no replay, and its
    outputs are the model's forward, its depth and the normals of that depth."""
    session = InferenceSession(_small_cfg(), seed=0, device="cpu")
    u8, cams = _frames(3, 3)
    got = session.predict(u8, cams)
    assert session.graph_captures == session.graph_replays == session.upsample_replayed == 0
    assert session.frames_real == 3 and session.frames_run == 4  # one bucket of 4
    with torch.inference_mode():
        out = session.model(prepare_images(torch.from_numpy(u8)), torch.from_numpy(cams))
        depth = 1.0 / (out.idepth_refined[..., 0] + 1e-8)
        k_inv = invert_intrinsics(torch.from_numpy(cams[:, 0, 1, :3, :3]))
        normal, _ = dispatch.depth_to_normal(depth, k_inv, K)
    want = {"idepth": out.idepth_refined[..., 0], "depth": depth, "prob": out.prob_map[..., 0],
            "normal": normal}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w.numpy(), err_msg=name)


_LAYOUT = [("idepth", 1), ("depth", 1), ("prob", 1), ("normal", 3)]
_BASE = ((8, 3, 192, 256), torch.uint8, _LAYOUT, False)


@pytest.mark.parametrize("changed", [
    ((4, 3, 192, 256), torch.uint8, _LAYOUT, False),  # bucket
    ((8, 2, 192, 256), torch.uint8, _LAYOUT, False),  # views
    ((8, 3, 96, 256), torch.uint8, _LAYOUT, False),  # height
    ((8, 3, 192, 128), torch.uint8, _LAYOUT, False),  # width
    ((8, 3, 192, 256), torch.float32, _LAYOUT, False),  # image dtype
    ((8, 3, 192, 256), torch.uint8, _LAYOUT[:3], False),  # layout
    ((8, 3, 192, 256), torch.uint8, _LAYOUT, True),  # cuDNN's TF32 flag
], ids=["bucket", "views", "height", "width", "dtype", "layout", "tf32"])
def test_graph_key_separates_each_part_of_a_signature(changed):
    def key(shape, dtype, layout, tf32):
        return graph_key(torch.empty(shape + (3,), dtype=dtype, device="meta"), layout, tf32)

    assert key(*_BASE) == key(*_BASE)
    assert key(*changed) != key(*_BASE)
    hash(key(*changed))


# -- on the card ----------------------------------------------------------------


@pytest.fixture(scope="module")
def card_sessions():
    """A graph session and an eager one (its graphs switched off) with the
    same seeded weights, at the configuration's size, both warmed; both run
    the nets channels-last (one card, no mesh)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs capture and replay only there")
    cfg = Config()  # 64 planes, k = 9, 192x256, bf16 serving
    graphed = InferenceSession(cfg, seed=0, device="cuda")
    eager = InferenceSession(cfg, state_dict=graphed.model.state_dict(), device="cuda")
    eager._graphs = None
    h, w = cfg.dataset.image_height, cfg.dataset.image_width
    for s in (graphed, eager):
        s.warmup(3, h, w)
    return graphed, eager, h, w


def _signatures(h, w):
    """uint8 three-view frames, float32 two-view ones and uint8 seven-view
    ones (six pairs a frame, 48 a bucket of 8): three graphs a bucket."""
    u8, cams = _frames(8, 3, h, w, seed=11)
    f32 = normalize_images(u8[:, :2].astype(np.float32) / 255.0)
    return {"u8-3v": (u8, cams), "f32-2v": (f32, np.ascontiguousarray(cams[:, :2])),
            "u8-7v": _frames(8, 7, h, w, seed=13)}


@pytest.mark.card
@pytest.mark.parametrize("frames", [1, 3, 6, 8], ids=["b1", "b4-pad", "b8-pad", "b8"])
def test_replay_equals_the_eager_nets(card_sessions, frames):
    """Every output of the replayed nets equals the eager session's bit for
    bit: the same kernels on the same inputs, in one order on one stream,
    channels-last in both."""
    from cnmnet_tpu_torch.kernels import cost_volume as kcv
    from cnmnet_tpu_torch.kernels import normals as kn

    graphed, eager, h, w = card_sessions
    assert graphed.one_card and eager.one_card
    for name, (images, cams) in _signatures(h, w).items():
        replays, captures = graphed.graph_replays, graphed.graph_captures
        cv, d2n = kcv.cost_volume_kernel.launches, kn.depth_to_normal_kernel.launches
        got = graphed.predict(images[:frames], cams[:frames])
        assert kcv.cost_volume_kernel.launches - cv == 1, name
        assert kn.depth_to_normal_kernel.launches - d2n == 1, name
        assert graphed.graph_replays - replays == 1, name
        want = eager.predict(images[:frames], cams[:frames])
        assert eager.graph_replays == 0, name  # channels-last nets, run eagerly
        assert graphed.graph_captures - captures <= 1, name  # a new signature's first batch
        assert set(got) == set(want), name
        for k in want:
            assert torch.equal(torch.from_numpy(got[k]), torch.from_numpy(want[k])), (name, k)


@pytest.mark.card
def test_warmup_captures_and_every_dispatch_replays(card_sessions):
    """After ``warmup`` of a signature, its batches capture nothing and each
    dispatch is one replay of channels-last nets, through the batcher's
    ``predict_async``."""
    graphed, _, h, w = card_sessions
    graphed.warmup(3, h, w)  # captured already: replays only
    images, cams = _signatures(h, w)["u8-3v"]
    captures, replays = graphed.graph_captures, graphed.graph_replays
    handles = [graphed.predict_async(images[:n], cams[:n]) for n in (1, 2, 5, 8, 4)]
    for hd in handles:
        graphed.fetch(hd)
    assert graphed.graph_captures == captures
    assert graphed.one_card and graphed.graph_replays - replays == len(handles)


_NETS = ("upsampling", "convolutions", "batch norm")


def _kernel_seconds(session, images, cams, reps):
    """Device seconds by kernel name over ``reps`` batches, from
    ``torch.profiler`` (CUPTI) as the benchmark's trace reads them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            session.predict(images, cams)
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e9
    return out


def _device_seconds(session, images, cams, reps):
    """Device seconds by kernel class (``benchmark/trace.kernel_class``)."""
    from benchmark.trace import kernel_class

    out = {}
    for name, secs in _kernel_seconds(session, images, cams, reps).items():
        out[kernel_class(name)] = out.get(kernel_class(name), 0.0) + secs
    return out


@pytest.mark.card
def test_the_profiler_sees_the_kernels_inside_the_graph(card_sessions):
    """A traced run of replays lists the nets' upsampling, convolution and
    batch norm kernels, each class within 10% of the eager run's device
    seconds a frame: the busy time and the kernel breakdown of a traced
    window still count the graph's work."""
    graphed, eager, h, w = card_sessions
    images, cams = _signatures(h, w)["u8-3v"]
    reps = 10
    got = _device_seconds(graphed, images, cams, reps)
    want = _device_seconds(eager, images, cams, reps)
    for cls in _NETS:
        assert want.get(cls, 0.0) > 0.0, (cls, want)
        assert abs(got.get(cls, 0.0) - want[cls]) <= 0.1 * want[cls], (cls, got, want)


@pytest.mark.card
def test_channels_last_replays_leave_transposes_and_upsampling_small(card_sessions):
    """A traced bucket-8 replay at three views: cuDNN's layout transposes
    take under 2% of the card's time and the upsampling (the hand kernel's
    bilinear and PyTorch's nearest x2 of the disparities) under 5% (NCHW
    nets: 14% and 45%; channels-last with PyTorch's NHWC bilinear kernel on
    an H100: 0.5% and 19.8%; with the hand kernel: 0.66% and 2.78%)."""
    graphed, _, h, w = card_sessions
    images, cams = _signatures(h, w)["u8-3v"]
    got = _device_seconds(graphed, images, cams, 10)
    busy = sum(got.values())
    shares = {cls: 100.0 * got.get(cls, 0.0) / busy for cls in ("layout transposes", "upsampling")}
    print(f"device seconds by class: {got}; shares {shares}")
    assert shares["layout transposes"] < 2.0, (shares, got)
    assert shares["upsampling"] < 5.0, (shares, got)


@pytest.mark.card
def test_every_replay_runs_the_upsampling_kernel_inside_the_graph(card_sessions):
    """Each three-view replay runs the 11 bilinear upsamplings as the hand
    kernel, counted by ``upsample_replayed`` (the host's launch counter does
    not move on a replay), the eager nets launch it 11 times a batch, and a
    traced replay's upsampling class holds that kernel and PyTorch's nearest
    x2 of the disparities: no ``upsample_bilinear2d`` kernel is left on the
    served path."""
    from benchmark.trace import kernel_class
    from cnmnet_tpu_torch.kernels import upsample as kups

    graphed, eager, h, w = card_sessions
    images, cams = _signatures(h, w)["u8-3v"]
    launches = kups.upsample2x_bilinear_kernel.launches
    replays, replayed = graphed.graph_replays, graphed.upsample_replayed
    for n in (1, 5, 8, 3):
        graphed.predict(images[:n], cams[:n])
    assert graphed.graph_replays - replays == 4
    assert graphed.upsample_replayed - replayed == 11 * 4
    assert kups.upsample2x_bilinear_kernel.launches == launches
    eager.predict(images, cams)
    assert kups.upsample2x_bilinear_kernel.launches - launches == 11
    seconds = {n: s for n, s in _kernel_seconds(graphed, images, cams, 2).items()
               if kernel_class(n) == "upsampling"}
    print(f"the upsampling class, device seconds by kernel: {seconds}")
    ours = [n for n in seconds if "cnm_upsample2x_bilinear_nhwc_kernel" in n]
    assert ours and all(n in ours or "nearest" in n for n in seconds), seconds
    assert not any("upsample_bilinear2d" in n for n in seconds), seconds
