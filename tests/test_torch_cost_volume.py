"""The port's plain cost volume and its dispatch, against the JAX package.

The same numpy inputs go through ``cnmnet_tpu.ops.cost_volume`` (the JAX
package's plain reference) and ``cnmnet_tpu_torch`` on the CPU.

Tolerance: 2e-4 absolute in f32 on white-noise images with costs of 2-5.
Both sides do the same math; only the FMA order of the homography terms
differs, which moves a sample by an ulp of its coordinate (1.5e-5 px at
x ~ 130) and the cost by that times the image's per-pixel gradient (up to
~8 on white noise, over three channels). bf16 writeback: within bf16 resolution
(2^-8 relative) of the f32 result. The CUDA kernel itself runs only on a
card and is held against the plain version there by ``chip_smoke.py``.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.geometry import Camera as JCamera  # noqa: E402
from cnmnet_tpu.kernels import dispatch as jdispatch  # noqa: E402
from cnmnet_tpu.ops import cost_volume as jcv  # noqa: E402
from cnmnet_tpu_torch.geometry import Camera as TCamera  # noqa: E402
from cnmnet_tpu_torch.kernels import build  # noqa: E402
from cnmnet_tpu_torch.kernels import cost_volume as kcv  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch as tdispatch  # noqa: E402
from cnmnet_tpu_torch.ops import cost_volume as tcv  # noqa: E402

TOL = 2e-4


def _E(theta=0.0, t=(0.08, 0.02, 0.01)):
    c, s = np.cos(theta), np.sin(theta)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    E[:3, 3] = t
    return E


def _inputs(rng, B, H, W, E2s=None):
    ref = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    src = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    K = np.asarray([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], np.float32)
    if E2s is None:
        E2s = [_E(0.02 * rng.standard_normal(), 0.05 * rng.standard_normal(3)) for _ in range(B)]
    ext1 = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    ext2 = np.stack(E2s).astype(np.float32)
    Ks = np.broadcast_to(K, (B, 3, 3)).copy()
    return ref, src, (ext1, Ks), (ext2, Ks)


def _jax(ref, src, c1, c2, P, **kw):
    j1, j2 = (JCamera(jnp.asarray(e), jnp.asarray(k)) for e, k in (c1, c2))
    return np.asarray(jdispatch.cost_volume(
        jnp.asarray(ref), jnp.asarray(src), j1, j2, 3.0, P, backend="jnp", **kw))


def _torch(ref, src, c1, c2, P, **kw):
    t1, t2 = (TCamera(torch.from_numpy(e), torch.from_numpy(k)) for e, k in (c1, c2))
    return tdispatch.cost_volume(torch.from_numpy(ref), torch.from_numpy(src), t1, t2, 3.0, P, **kw)


def test_idepth_hypotheses_match():
    """Same grid to 2 ulp (XLA may fuse jnp.linspace's formula into FMAs)."""
    for scale in (2.0, 3.0, 4.5):
        got = tcv.idepth_hypotheses(scale, 64).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(jcv.idepth_hypotheses(scale, 64)), rtol=2.4e-7)


@pytest.mark.parametrize(
    "E2", [_E(0.0, (0.08, 0.02, 0.0)), _E(0.02, (0.08, 0.02, 0.01))], ids=["translation", "rotation"]
)
def test_matches_jax(rng, E2):
    ref, src, c1, c2 = _inputs(rng, 1, 32, 64, [E2])
    want = _jax(ref, src, c1, c2, 8)
    got = _torch(ref, src, c1, c2, 8)
    assert tuple(got.shape) == want.shape == (1, 32, 64, 8)
    assert np.abs(got.numpy() - want).max() < TOL


def test_batched(rng):
    ref, src, c1, c2 = _inputs(rng, 3, 24, 40)
    want = _jax(ref, src, c1, c2, 8)
    got = _torch(ref, src, c1, c2, 8)
    assert np.abs(got.numpy() - want).max() < TOL


@pytest.mark.parametrize("shape", [(30, 100, 6), (40, 130, 9)])
def test_odd_shapes(rng, shape):
    H, W, P = shape
    ref, src, c1, c2 = _inputs(rng, 2, H, W)
    want = _jax(ref, src, c1, c2, P)
    got = _torch(ref, src, c1, c2, P)
    assert tuple(got.shape) == (2, H, W, P)
    assert np.abs(got.numpy() - want).max() < TOL


def test_torch_sampling_convention(rng):
    ref, src, c1, c2 = _inputs(rng, 2, 24, 40)
    want = _jax(ref, src, c1, c2, 8, sampling="torch")
    got = _torch(ref, src, c1, c2, 8, sampling="torch")
    assert np.abs(got.numpy() - want).max() < TOL
    exact = _torch(ref, src, c1, c2, 8)
    assert np.abs(exact.numpy() - got.numpy()).max() > 1e-3  # the prescale took effect


def test_bf16_writeback(rng):
    ref, src, c1, c2 = _inputs(rng, 2, 24, 40)
    f32 = _torch(ref, src, c1, c2, 8)
    bf16 = _torch(ref, src, c1, c2, 8, out_dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
    err = (bf16.float() - f32).abs()
    assert bool((err <= 2.0**-8 * f32.abs()).all()), err.max()


def test_plane_major_view(rng):
    """The public [B, H, W, P] result is a view of a [B, P, H, W] buffer."""
    ref, src, c1, c2 = _inputs(rng, 1, 8, 12)
    vol = _torch(ref, src, c1, c2, 4)
    assert vol.permute(0, 3, 1, 2).is_contiguous()
    assert not vol.requires_grad


def test_auto_on_cpu_takes_plain(rng):
    ref, src, c1, c2 = _inputs(rng, 1, 8, 12)
    before = kcv.cost_volume_kernel.launches
    auto = _torch(ref, src, c1, c2, 4)
    plain = _torch(ref, src, c1, c2, 4, backend="torch")
    assert kcv.cost_volume_kernel.launches == before
    np.testing.assert_array_equal(auto.numpy(), plain.numpy())


def test_cuda_backend_on_cpu_raises(rng):
    ref, src, c1, c2 = _inputs(rng, 1, 8, 12)
    with pytest.raises(ValueError, match="cuda"):
        _torch(ref, src, c1, c2, 4, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        _torch(ref, src, c1, c2, 4, backend="pallas")


def test_kernel_refuses_cpu_tensors(rng):
    ref, src, c1, c2 = _inputs(rng, 1, 8, 12)
    t1, t2 = (TCamera(torch.from_numpy(e), torch.from_numpy(k)) for e, k in (c1, c2))
    with pytest.raises(ValueError, match="CUDA"):
        kcv.cost_volume_kernel(torch.from_numpy(ref), torch.from_numpy(src),
                               kcv.pack_coefs(t1, t2), tcv.idepth_hypotheses(3.0, 4))


def test_pack_coefs_match_plain_terms(rng):
    """The kernel's 12 coefficients are the plain version's KRKi and KT."""
    _, _, c1, c2 = _inputs(rng, 2, 8, 12)
    t1, t2 = (TCamera(torch.from_numpy(e), torch.from_numpy(k)) for e, k in (c1, c2))
    coefs = kcv.pack_coefs(t1, t2)
    uv, kt = tcv.plane_sweep_terms(t1, t2, 8, 12)
    np.testing.assert_array_equal(coefs[:, 9:].numpy(), kt[..., 0].numpy())
    u, v = 5.0, 3.0
    k = coefs[:, :9].reshape(2, 3, 3)
    np.testing.assert_array_equal((k[..., 0] * u + k[..., 1] * v + k[..., 2]).numpy(),
                                  uv[:, :, 3 * 12 + 5].numpy())


def _bordered_sweep(ref, src, KRKiUV, KT, idepths):
    """The kernel's addressing in plain PyTorch: the packed source with its
    2-pixel zero border, the left/top tap clamped to x0 in [-2, W] and y0 in
    [-2, H], four unmasked taps, sums in the kernel's order."""
    B, H, W, _ = ref.shape
    P = idepths.shape[0]
    x, y = tcv._sweep_coords(KRKiUV, KT, idepths, H, W)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i = x0.to(torch.int64).clamp(-kcv.BORDER, W)
    y0i = y0.to(torch.int64).clamp(-kcv.BORDER, H)
    padded = kcv.bordered_source(src)
    Wp = padded.shape[2]
    flat = padded.reshape(B, -1, 4)

    def tap(dx, dy, w):
        idx = (y0i + dy + kcv.BORDER) * Wp + (x0i + dx + kcv.BORDER)
        vals = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, 4))
        return vals.reshape(B, P, H * W, 4)[..., :3] * w[..., None]

    warped = (tap(0, 0, (1.0 - fx) * (1.0 - fy)) + tap(1, 0, fx * (1.0 - fy))
              + tap(0, 1, (1.0 - fx) * fy) + tap(1, 1, fx * fy))
    diff = (warped - ref.reshape(B, 1, H * W, 3)).abs()
    return (diff[..., 0] + diff[..., 1] + diff[..., 2]).reshape(B, P, H, W)


def _edge_terms(rng, B, H, W):
    """Homography terms whose sample coordinates land at and beyond every
    edge: x0 in {-3, -2, -1, 0, W-1, W, W+1}, far outside, past the
    +-100 max(H, W) clip (Z = 0, so X / eps) and on the z-guard (Z = -eps)."""
    xs = np.asarray([-7.5, -2.5, -2.0, -1.5, -1.0, -0.25, 0.0, 0.5, W - 1.5, W - 1.0,
                     W - 0.5, W - 1e-3, W, W + 0.5, W + 1.0, W + 1.5, W + 3.25, 1e5, -1e5], np.float32)
    ys = np.asarray([-5.5, -2.0, -1.5, -1.0, -0.5, 0.0, 1.5, H - 1.5, H - 1.0, H - 0.5,
                     H, H + 0.5, H + 2.0, 1e5, -1e5], np.float32)
    x = np.stack([rng.permutation(np.resize(xs, H * W)) for _ in range(B)])
    y = np.stack([rng.permutation(np.resize(ys, H * W)) for _ in range(B)])
    z = rng.choice(np.asarray([1.0, 1.0, 1.0, 0.5, 2.0, 0.0, -1e-6], np.float32), (B, H * W))
    zs = np.where(z == 0, 1.0, z)
    terms = np.stack([x * zs, y * zs, z], 1).astype(np.float32)  # [B, 3, HW]
    KT = np.zeros((B, 3, 1), np.float32)
    KT[:, :2, 0] = rng.choice(np.asarray([0.0, 0.5, -1.0], np.float32), (B, 2))
    return torch.from_numpy(terms), torch.from_numpy(KT)


@pytest.mark.parametrize("shape", [(6, 7), (9, 12)])
def test_bordered_addressing_equals_plain_at_every_edge(rng, shape):
    """The kernel's bordered-source addressing gives the plain version's
    costs exactly, on coordinates at and beyond every edge of the source."""
    H, W = shape
    B = 2
    ref = torch.from_numpy(rng.standard_normal((B, H, W, 3)).astype(np.float32))
    src = torch.from_numpy(rng.standard_normal((B, H, W, 3)).astype(np.float32))
    terms, KT = _edge_terms(rng, B, H, W)
    idepths = torch.tensor([0.0, 0.5, 1.0, 3.0])
    want = tcv.plane_sweep_cost_volume(ref, src, terms, KT, idepths)
    got = _bordered_sweep(ref, src, terms, KT, idepths)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    x, _ = tcv._sweep_coords(terms, KT, idepths, H, W)
    x0 = torch.floor(x)
    for edge in (-3, -2, -1, 0, W - 1, W, W + 1):
        assert bool((x0 == edge).any()), edge
    assert bool((x.abs() == 100.0 * max(H, W)).any())  # the clip was reached


def test_bordered_addressing_under_cameras(rng):
    """The same model under cameras whose motion pushes samples off the
    source frame on every side."""
    E2s = [_E(0.3, (0.6, -0.4, 0.2)), _E(-0.25, (-0.7, 0.5, -0.3))]
    ref, src, c1, c2 = _inputs(rng, 2, 16, 24, E2s)
    t1, t2 = (TCamera(torch.from_numpy(e), torch.from_numpy(k)) for e, k in (c1, c2))
    terms, KT = tcv.plane_sweep_terms(t1, t2, 16, 24)
    idepths = tcv.idepth_hypotheses(3.0, 8)
    r, s = torch.from_numpy(ref), torch.from_numpy(src)
    want = tcv.plane_sweep_cost_volume(r, s, terms, KT, idepths)
    np.testing.assert_array_equal(_bordered_sweep(r, s, terms, KT, idepths).numpy(),
                                  want.numpy())


def test_bordered_source(rng):
    src = torch.from_numpy(rng.standard_normal((2, 5, 7, 3)).astype(np.float32))
    packed = kcv.bordered_source(src)
    assert tuple(packed.shape) == kcv.bordered_shape(2, 5, 7) == (2, 9, 11, 4)
    np.testing.assert_array_equal(packed[:, 2:-2, 2:-2, :3].numpy(), src.numpy())
    inner = torch.zeros_like(packed, dtype=torch.bool)
    inner[:, 2:-2, 2:-2, :3] = True
    assert bool((packed[~inner] == 0).all())


def test_kernel_refuses_sizes_past_32_bit_indexing():
    kcv.check_sizes(16, 192, 256, 64)  # the bucket-8 volume
    kcv.check_sizes(1, 480, 640, 64)
    with pytest.raises(ValueError, match="volume has"):
        kcv.check_sizes(64, 1024, 1024, 32)
    with pytest.raises(ValueError, match="packed source has"):
        kcv.check_sizes(1, 23170, 23170, 1)


def test_kernel_sizes_of_a_row_shard_against_the_whole_source():
    """A row shard's launch indexes its reference rows, its volume rows and
    the packed whole source (``Hs`` rows): each must stay below 2^31."""
    kcv.check_sizes(2, 120, 640, 64, Hs=480)  # a 480x640 shard of tile 4
    with pytest.raises(ValueError, match="packed source has"):
        kcv.check_sizes(1, 8, 23170, 1, Hs=23170)
    with pytest.raises(ValueError, match="reference has"):
        kcv.check_sizes(1, 27000, 27000, 1, Hs=8)


def test_kernel_module_imports_without_nvcc(monkeypatch, tmp_path):
    """This module imported the kernel modules on a host without nvcc (the
    build waits for the first launch); a build without nvcc raises with the
    reason and writes nothing."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "absent" / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        build.load("cost_volume")
    assert not (tmp_path / "build").exists()


def test_kernel_ablations_apply_to_the_sources():
    """Every ablation variant of ``kernels/ablate.py`` still finds, once,
    the text it replaces in the shipped CUDA sources."""
    from cnmnet_tpu_torch.kernels import ablate

    for source, variants in (("cost_volume", ablate.COST_VOLUME),
                             ("depth_to_normal", ablate.DEPTH_TO_NORMAL)):
        for name, subs in variants.items():
            body = ablate.variant_source(source, name, subs)
            assert all(new in body for _, new in subs), (source, name)


# -- launches past 2^31 elements ---------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that passes the wrappers' ``is_cuda`` check, so that
    their launch loop runs here against a stand-in library."""

    @property
    def is_cuda(self):
        return True


def _no_card_context(monkeypatch):
    """``torch.cuda.device`` and the current stream for the stand-in."""
    import contextlib
    import types

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


class _PlainCostVolumeLib:
    """Stands in for ``csrc/cost_volume.cu``'s library: each launch is
    located in the caller's tensors by its pointers, recorded, and computed
    by the plain version (the kernel's rounding of the homography terms from
    the coefficients, at the launch's ``row_offset``) into the memory at its
    output pointer."""

    def __init__(self, ref, src, coefs, idepths):
        self.ref, self.src, self.coefs, self.idepths = ref, src, coefs, idepths
        self.calls = []

    @property
    def cnm_cost_volume(self):
        return self

    def __call__(self, ref_p, src_p, scratch_p, coef_p, id_p, out_p, B, H, W, P, Hs, row_offset,
                 out_bf16, stream):
        b0 = (ref_p - self.ref.data_ptr()) // (H * W * 3 * 4)
        p0 = (id_p - self.idepths.data_ptr()) // 4
        assert src_p == self.src[b0].data_ptr() and coef_p == self.coefs[b0].data_ptr()
        kcv.check_sizes(B, H, W, P, Hs)
        self.calls.append((b0, b0 + B, p0, p0 + P, Hs, row_offset))
        vol = _plain_from_coefs(self.ref[b0:b0 + B], self.src[b0:b0 + B],
                                self.coefs[b0:b0 + B], self.idepths[p0:p0 + P], row_offset)
        vol = vol.to(torch.bfloat16 if out_bf16 else torch.float32).reshape(-1)
        cell = ctypes.c_uint16 if out_bf16 else ctypes.c_float
        torch.frombuffer((cell * vol.numel()).from_address(out_p), dtype=vol.dtype).copy_(vol)
        return 0


def _plain_from_coefs(ref, src, coefs, idepths, row_offset=0):
    """The plain volume ``[B, P, H, W]`` from the kernel's coefficients."""
    ref, src, coefs, idepths = (t.as_subclass(torch.Tensor) for t in (ref, src, coefs, idepths))
    B, H, W, _ = ref.shape
    v, u = torch.meshgrid(torch.arange(row_offset, row_offset + H, dtype=torch.float32),
                          torch.arange(W, dtype=torch.float32), indexing="ij")
    k = coefs[:, :9].reshape(B, 3, 3, 1)
    terms = k[:, :, 0] * u.reshape(-1) + k[:, :, 1] * v.reshape(-1) + k[:, :, 2]
    return tcv.plane_sweep_cost_volume(ref, src, terms, coefs[:, 9:, None], idepths)


def _covers(chunks, B, P):
    """Each (pair, plane) of ``[0, B) x [0, P)`` in exactly one chunk, the
    chunks in order."""
    seen = np.zeros((B, P), np.int64)
    for b0, b1, p0, p1 in chunks:
        seen[b0:b1, p0:p1] += 1
    assert (seen == 1).all(), seen
    assert chunks == sorted(chunks)


@pytest.mark.parametrize("B, H, W, P, Hs, limit", [
    (110, 480, 640, 64, 480, 2**31),  # 7-Scenes at full size: 2 launches of 55 pairs
    (114, 480, 640, 64, 480, 2**31),  # a 7-view flush of 19 frames
    (16, 192, 256, 64, 192, 2**31),  # the bucket-8 volume: one launch
    (7, 12, 20, 8, 12, 5000),  # lowered: volume 1920 a pair
    (9, 6, 20, 8, 24, 5000),  # a row shard: the packed source (2688 a pair) binds
])
def test_launch_chunks_cover_the_pairs_below_the_limit(monkeypatch, B, H, W, P, Hs, limit):
    monkeypatch.setattr(kcv, "INDEX_LIMIT", limit)
    chunks = kcv.launch_chunks(B, H, W, P, Hs)
    _covers(chunks, B, P)
    for b0, b1, p0, p1 in chunks:
        assert (p0, p1) == (0, P)  # whole pairs
        kcv.check_sizes(b1 - b0, H, W, p1 - p0, Hs)  # each launch below the limit
    if len(chunks) > 1:  # the fewest launches: one fewer would be over the limit
        with pytest.raises(ValueError, match="limit"):
            kcv.check_sizes(-(-B // (len(chunks) - 1)), H, W, P, Hs)
    assert max(b1 - b0 for b0, b1, _, _ in chunks) - min(b1 - b0 for b0, b1, _, _ in chunks) <= 1
    if limit == 2**31:
        assert len(chunks) == {110: 2, 114: 2, 16: 1}[B]


def test_launch_chunks_split_a_pair_over_the_limit_into_planes(monkeypatch):
    """A pair whose volume alone reaches the limit is covered plane by
    plane chunks; one whose reference or packed source reaches it raises,
    naming the limit."""
    monkeypatch.setattr(kcv, "INDEX_LIMIT", 1000)
    chunks = kcv.launch_chunks(3, 8, 12, 20)  # 1920 a pair, 96 a plane: 10 planes a launch
    _covers(chunks, 3, 20)
    assert [c[1] - c[0] for c in chunks] == [1] * 6 and {c[3] - c[2] for c in chunks} == {10}
    for b0, b1, p0, p1 in chunks:
        kcv.check_sizes(b1 - b0, 8, 12, p1 - p0)
    assert kcv.launch_chunks(0, 8, 12, 20) == []
    with pytest.raises(ValueError, match="reference has 1152 elements.*limit of 1000"):
        kcv.launch_chunks(1, 16, 24, 2)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_launches_chunks_into_one_volume(rng, monkeypatch, out_dtype):
    """``cost_volume_kernel`` under a lowered limit, its library stood in by
    the plain version: the launches cover the pairs (then one pair's planes)
    with the caller's ``row_offset`` and source rows ``Hs``, each chunk lands
    in its slice of the one output, the result equals one plain volume bit
    for bit, and the counter adds one a launch."""
    _no_card_context(monkeypatch)
    B, H, Hs, W, P, offset = 5, 6, 8, 12, 16, 2
    ref = torch.from_numpy(rng.standard_normal((B, H, W, 3)).astype(np.float32)).as_subclass(_OnCard)
    src = torch.from_numpy(rng.standard_normal((B, Hs, W, 3)).astype(np.float32)).as_subclass(_OnCard)
    coefs = np.tile(np.float32([1.02, 0.01, -0.4, -0.01, 0.99, 0.3, 0.0, 0.0, 1.0, 2.0, 0.5, 0.01]),
                    (B, 1)) + 0.01 * rng.standard_normal((B, 12)).astype(np.float32)
    coefs = torch.from_numpy(coefs.astype(np.float32)).as_subclass(_OnCard)
    idepths = tcv.idepth_hypotheses(3.0, P).clone().as_subclass(_OnCard)
    want = _plain_from_coefs(ref, src, coefs, idepths, offset).to(out_dtype)
    # 1152 costs a pair, its packed source 768: 2 pairs a launch, then 8 planes
    for limit, launches in ((3000, 3), (1000, 10)):
        monkeypatch.setattr(kcv, "INDEX_LIMIT", limit)
        lib = _PlainCostVolumeLib(ref, src, coefs, idepths)
        monkeypatch.setattr(build, "load", lambda name: lib)
        before = kcv.cost_volume_kernel.launches
        got = kcv.cost_volume_kernel(ref, src, coefs, idepths, out_dtype, row_offset=offset)
        assert kcv.cost_volume_kernel.launches - before == launches == len(lib.calls)
        assert [c[:4] for c in lib.calls] == kcv.launch_chunks(B, H, W, P, Hs)
        assert {c[4:] for c in lib.calls} == {(Hs, offset)}
        assert got.dtype == out_dtype and torch.equal(got.as_subclass(torch.Tensor), want)
