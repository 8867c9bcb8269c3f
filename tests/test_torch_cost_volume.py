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
