"""The bilinear x2 upsampling kernel (``kernels/upsample.py``,
``csrc/upsample.cu``) and the rule that routes the nets' upsamplings to it
(``kernels/dispatch.upsample2x_bilinear``).

On the CPU: a stand-in for the launcher shows which calls reach it (a
channels-last map on the card where no gradient is needed, on the auto or
the ``"cuda"`` backend) and which keep ``F.interpolate`` (CPU, NCHW,
autograd, a row shard, nearest, a type or channel count the kernel does
not take, the ``"torch"`` backend, a model whose ``cv_backend`` is
``"torch"``); the wrapper refuses what the kernel cannot take before it
builds anything; ``dispatch.launch_counts`` lists its counter; a plain
model of the kernel's taps and weights (its 3 x 3 neighbourhood, the
border's clamps) equals ``F.interpolate``; ``served_shapes`` are the nets'
own bilinear calls. "On the card" is a tensor whose ``is_cuda`` answers
True here (``_on_card``).

On the card (marked ``card``, skipped without one; this file imports no
JAX: ``python -m pytest tests/test_torch_upsample.py --noconftest``): the
kernel against ``F.interpolate``, bit for bit, in bf16 and f32, at every
served shape of buckets 1, 4 and 8 at three and seven views, on maps whose
neighbours lie up to 2^24 apart (where contracting another product into a
sum would round differently), and at border-heavy shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from cnmnet_tpu_torch.data.pipeline import collate, quantize_images_u8  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch  # noqa: E402
from cnmnet_tpu_torch.kernels import upsample as kups  # noqa: E402
from cnmnet_tpu_torch.models import CNMModel  # noqa: E402
from cnmnet_tpu_torch.models import layers  # noqa: E402
from cnmnet_tpu_torch.ops.images import prepare_images  # noqa: E402

CL = torch.channels_last

# (channels, level) of each bilinear upsampling's input: the map is the
# image size over 2^level. DepthNet's upconv5..1 (over the pairs), then the
# RefineNet's upconv3..1 (over the frames, once per branch).
DEPTH_NET = ((512, 5), (512, 4), (512, 3), (256, 2), (128, 1))
REFINE_NET = ((512, 3), (256, 2), (128, 1))


def served_shapes(bucket: int, views: int, height: int, width: int):
    """``[(N, C, H, W), ...]`` of every bilinear upsampling input of one
    bucket batch, in the nets' order: DepthNet's over ``bucket * (views - 1)``
    pairs, then each of the two RefineNet branches' over ``bucket`` frames
    (no RefineNet at two views)."""
    shapes = [(bucket * (views - 1), c, height >> k, width >> k) for c, k in DEPTH_NET]
    if views >= 3:
        shapes += 2 * [(bucket, c, height >> k, width >> k) for c, k in REFINE_NET]
    return shapes


def bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values as integers of their width: equal bits, equal values."""
    return x.view({2: torch.int16, 4: torch.int32}[x.element_size()])


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the routing rule
    reads of a CUDA tensor, without one."""

    @property
    def is_cuda(self):
        return True


def _on_card(x: torch.Tensor) -> torch.Tensor:
    return x.as_subclass(_OnCard)


def _map(shape=(2, 16, 5, 7), dtype=torch.bfloat16, layout=CL, seed=0):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=torch.float32)
    return x.to(dtype).contiguous(memory_format=layout)


@pytest.fixture
def launched(monkeypatch):
    """Stands in for the launcher: records each map it is given and answers
    ``F.interpolate``'s upsampling of it."""
    calls = []

    def stand_in(x):
        calls.append(tuple(x.shape))
        return kups.upsample2x_bilinear_plain(x.as_subclass(torch.Tensor))

    monkeypatch.setattr(kups, "upsample2x_bilinear_kernel", stand_in)
    return calls


# -- the routing rule -------------------------------------------------------------


@pytest.mark.parametrize("backend", [None, "cuda"])
@pytest.mark.parametrize("grad_mode", ["inference_mode", "no_grad", "no_requires_grad"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_channels_last_on_the_card_without_gradient_reaches_the_kernel(launched, grad_mode, dtype,
                                                                       backend):
    x = _on_card(_map(dtype=dtype))
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad,
           "no_requires_grad": torch.enable_grad}[grad_mode]
    up = layers.Upsample2x()
    up.backend = backend
    with ctx():
        out = up(x)
    assert launched == [(2, 16, 5, 7)]
    assert torch.equal(out, kups.upsample2x_bilinear_plain(x.as_subclass(torch.Tensor)))


def _nchw_on_card():
    return _on_card(_map(layout=torch.contiguous_format))


def _grad_on_card():
    return _on_card(_map(dtype=torch.float32).requires_grad_())


KEEP = {
    "cpu": lambda: layers.upsample2x_bilinear(_map()),
    "nchw-on-card": lambda: layers.upsample2x_bilinear(_nchw_on_card()),
    "requires-grad-on-card": lambda: layers.upsample2x_bilinear(_grad_on_card()),
    "float64-on-card": lambda: layers.upsample2x_bilinear(_on_card(_map(dtype=torch.float64))),
    "float16-on-card": lambda: layers.upsample2x_bilinear(_on_card(_map(dtype=torch.float16))),
    "row-shard-on-card": lambda: layers.upsample_rows(_on_card(_map()), 1, (2, 9), "bilinear"),
    "nearest-on-card": lambda: layers.upsample2x_nearest(_on_card(_map())),
    "12-channels-on-card": lambda: layers.upsample2x_bilinear(_on_card(_map((1, 12, 3, 3)))),
    "torch-backend-on-card": lambda: layers.upsample2x_bilinear(_on_card(_map()), backend="torch"),
    "cuda-backend-nchw-on-card": lambda: dispatch.upsample2x_bilinear(_nchw_on_card(), "cuda"),
}


@pytest.mark.parametrize("case", sorted(KEEP))
def test_every_other_upsampling_keeps_interpolate(launched, case):
    """CPU maps, NCHW maps on the card (the trainer, evaluation, a mesh),
    autograd, the row path of a tile axis, nearest x2, types and channel
    counts the kernel does not take and the ``"torch"`` backend never reach
    the launcher, under ``inference_mode`` too."""
    with torch.inference_mode(case != "requires-grad-on-card"):
        KEEP[case]()
    assert launched == []


def test_the_nets_on_the_cpu_in_eval_and_in_training_never_reach_the_kernel(launched):
    """The nets on the CPU, in eval mode and in a train-mode forward and
    backward, call the launcher 0 times and upsample through
    ``F.interpolate``, 11 times a pass at three views."""
    seen = []
    plain = kups.upsample2x_bilinear_plain

    def counted(x):
        seen.append(tuple(x.shape))
        return plain(x)

    model = CNMModel(num_planes=8)
    layers.init_weights(model, torch.Generator().manual_seed(0))
    images, cams = _frames(2, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kups, "upsample2x_bilinear_plain", counted)
        with torch.inference_mode():
            model.eval()(images, cams)
        model.train()(images, cams).idepth_refined.sum().backward()
    assert launched == [] and len(seen) == 22


@pytest.mark.parametrize("backend", ["cuda", "jnp"])
def test_dispatch_refuses_a_backend_it_cannot_honour(launched, backend):
    with pytest.raises(ValueError, match="backend"):
        dispatch.upsample2x_bilinear(_map(), backend)
    assert launched == []


@pytest.mark.parametrize("when", ["built", "set-after"])
def test_a_plain_model_upsamples_plainly_on_the_card(launched, when):
    """``cv_backend="torch"`` reaches every ``Upsample2x``, at build and when
    set later, so a model of plain versions never launches the kernel; set
    back to auto, the same model does, 11 times a pass at three views."""
    model = CNMModel(num_planes=8, cv_backend="torch" if when == "built" else None)
    if when == "set-after":
        model.cv_backend = "torch"
    ups = [m for m in model.modules() if isinstance(m, layers.Upsample2x)]
    assert len(ups) == 11 and all(m.backend == "torch" for m in ups)
    layers.init_weights(model, torch.Generator().manual_seed(0))
    model = model.eval().to(memory_format=CL)
    ref, volume = model.front(*_frames(1, 3))
    ref, volume = (_on_card(t.contiguous(memory_format=CL)) for t in (ref, volume))
    with torch.inference_mode():
        model.nets(ref, volume, 3)
        assert launched == []
        model.cv_backend = None
        assert all(m.backend is None for m in ups)
        model.nets(ref, volume, 3)
    assert len(launched) == 11


# -- the wrapper ------------------------------------------------------------------


REFUSED = {
    "cpu": (lambda: _map(), "CUDA tensors"),
    "nchw": (lambda: _nchw_on_card(), "channels-last"),
    "channels-not-a-multiple-of-8": (lambda: _on_card(_map((1, 12, 3, 3))), "multiple of 8"),
    "float64": (lambda: _on_card(_map(dtype=torch.float64)), "unsupported dtype"),
    "three-dims": (lambda: _on_card(torch.zeros(16, 5, 7)), "channels-last"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_wrapper_refuses_what_the_kernel_cannot_take(monkeypatch, case):
    """Each refusal comes before the library is built or loaded."""
    monkeypatch.setattr(kups.build, "load", lambda name: pytest.fail("loaded the library"))
    make, message = REFUSED[case]
    before = kups.upsample2x_bilinear_kernel.launches
    with pytest.raises(ValueError, match=message):
        kups.upsample2x_bilinear_kernel(make())
    assert kups.upsample2x_bilinear_kernel.launches == before


def test_launch_counts_lists_the_upsampling_counter(monkeypatch):
    assert set(dispatch.launch_counts()) == {"cost_volume", "depth_to_normal", "upsample"}
    monkeypatch.setattr(kups.upsample2x_bilinear_kernel, "launches", 11)
    assert dispatch.launch_counts()["upsample"] == 11


def test_the_library_is_built_with_the_others():
    assert "upsample" in kups.build.SOURCES
    assert (kups.build.CSRC / "upsample.cu").exists()


# -- a plain model of the kernel's taps -------------------------------------------


def _taps(i: int, n: int):
    """The kernel's two taps and weights along one axis for outputs 2i and
    2i + 1 (``csrc/upsample.cu``): its neighbourhood (i - 1, i, i + 1)
    clamped to [0, n - 1], the even output's second tap the next row at i = 0
    (weight 0), else row i."""
    lo, mid, hi = max(i - 1, 0), i, min(i + 1, n - 1)
    w1 = 0.0 if i == 0 else 0.75
    even = (lo, hi if i == 0 else mid, 1.0 - w1, w1)
    odd = (mid, hi, 0.75, 0.25)
    return even, odd


def _kernel_model(x: torch.Tensor) -> torch.Tensor:
    """The kernel's quads in f64: ``h0 (w0 x00 + w1 x01) + h1 (w0 x10 + w1 x11)``."""
    N, C, H, W = x.shape
    out = x.new_zeros(N, C, 2 * H, 2 * W)
    for i in range(H):
        for a, (ra, rb, h0, h1) in enumerate(_taps(i, H)):
            for j in range(W):
                for b, (ca, cb, w0, w1) in enumerate(_taps(j, W)):
                    top = w0 * x[..., ra, ca] + w1 * x[..., ra, cb]
                    bottom = w0 * x[..., rb, ca] + w1 * x[..., rb, cb]
                    out[..., 2 * i + a, 2 * j + b] = h0 * top + h1 * bottom
    return out


@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (4, 1), (2, 2), (3, 4), (6, 8)])
def test_the_kernels_taps_and_weights_are_interpolates(hw):
    x = _map((2, 3) + hw, dtype=torch.float64, layout=torch.contiguous_format, seed=sum(hw))
    want = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    torch.testing.assert_close(_kernel_model(x), want, rtol=1e-14, atol=1e-14)


# -- the served shapes ------------------------------------------------------------


def _frames(n, views, h=32, w=64):
    ds = SyntheticScenes(num_samples=n, height=h, width=w, view_num=views, seed=3)
    batch = collate([ds[i] for i in range(n)])
    return (prepare_images(torch.from_numpy(quantize_images_u8(batch["images"]))),
            torch.from_numpy(batch["cams"].astype(np.float32)))


@pytest.mark.parametrize("views", [2, 3, 7])
def test_served_shapes_are_the_nets_bilinear_calls(monkeypatch, views):
    seen = []
    plain = kups.upsample2x_bilinear_plain
    monkeypatch.setattr(kups, "upsample2x_bilinear_plain",
                        lambda x: seen.append(tuple(x.shape)) or plain(x))
    model = CNMModel(num_planes=8).eval()
    with torch.inference_mode():
        model(*_frames(2, views))
    assert seen == served_shapes(2, views, 32, 64)
    assert len(seen) == (11 if views >= 3 else 5)


# -- on the card ------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _normal(shape, dtype, device, seed):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype).contiguous(memory_format=CL)


def _wide(shape, dtype, device, seed):
    """Random signs and magnitudes 2^-12 .. 2^12, and a tenth zeros:
    neighbours up to 2^24 apart."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    x *= torch.exp2(torch.randint(-12, 13, shape, generator=g, device=device).float())
    x[torch.rand(shape, generator=g, device=device) < 0.1] = 0.0
    return x.to(dtype).contiguous(memory_format=CL)


def _assert_bit_equal(x):
    got = kups.upsample2x_bilinear_kernel(x)
    want = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=CL)
    same = bits(got) == bits(want)
    assert bool(same.all()), f"{int((~same).sum())} of {same.numel()} differ at {tuple(x.shape)}"


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("views", [3, 7])
@pytest.mark.parametrize("bucket", [1, 4, 8])
def test_kernel_equals_interpolate_at_the_served_shapes(card, bucket, views, dtype):
    before = kups.upsample2x_bilinear_kernel.launches
    shapes = sorted(set(served_shapes(bucket, views, 192, 256)))
    for k, shape in enumerate(shapes):
        _assert_bit_equal(_normal(shape, dtype, card, seed=k))
        _assert_bit_equal(_wide(shape, dtype, card, seed=k))
    torch.cuda.synchronize()
    assert kups.upsample2x_bilinear_kernel.launches - before == 2 * len(shapes)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(3, 64, 6, 8), (2, 64, 1, 9), (2, 16, 5, 1), (1, 8, 1, 1),
                                   (5, 24, 2, 3)])
def test_kernel_equals_interpolate_at_the_borders(card, shape, dtype):
    """Maps where most pixels touch a border, one row or one column high."""
    _assert_bit_equal(_wide(shape, dtype, card, seed=1))
    _assert_bit_equal(_normal(shape, dtype, card, seed=1))
