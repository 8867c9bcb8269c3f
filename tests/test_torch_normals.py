"""The port's plain depth->normal against an f64 oracle and the JAX package.

The uncentred f32 normal equations are ill-conditioned at realistic focal
lengths: both f32 implementations err by degrees at some pixels, in
different directions, so comparing f32 with f32 pixel by pixel is the wrong
test. Each is instead held against a float64 oracle with the same masking
and solve (re-implemented here), and the port must be no worse than the JAX
package's ``ops.normals.depth_to_normal`` by the rule its own kernel tests
use: mean angle < 2x JAX's + 0.05 deg, max angle < max(2x JAX's, 1 deg).
The points are plain products and agree to 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.geometry.camera import invert_intrinsics as j_invert_intrinsics  # noqa: E402
from cnmnet_tpu.ops import normals as jn  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch as tdispatch  # noqa: E402
from cnmnet_tpu_torch.kernels import normals as kn  # noqa: E402
from cnmnet_tpu_torch.ops import normals as tn  # noqa: E402


def oracle_f64(depth, K_inv, k_size, vmin=0.0, vmax=10.0):
    """f64 normals and determinants with the implementations' semantics."""
    depth = np.asarray(depth, np.float64)
    K_inv = np.asarray(K_inv, np.float64)
    B, H, W = depth.shape
    pad = k_size // 2
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.where((depth > vmin) & (depth < vmax), depth, 0.0)
    rays = [K_inv[:, i, 0, None, None] * u + K_inv[:, i, 1, None, None] * v
            + K_inv[:, i, 2, None, None] for i in range(3)]
    x, y, z = (r * d for r in rays)
    monos = np.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z], -1)
    padded = np.zeros((B, H + 2 * pad, W + 2 * pad, 9))
    padded[:, pad:pad + H, pad:pad + W] = monos
    c = np.zeros((B, H + 2 * pad + 1, W + 2 * pad + 1, 9))
    c[:, 1:, 1:] = padded.cumsum(1).cumsum(2)
    mom = (c[:, k_size:, k_size:] - c[:, :-k_size, k_size:]
           - c[:, k_size:, :-k_size] + c[:, :-k_size, :-k_size])
    a, b, cc, dd, e, f, rx, ry, rz = (mom[..., i] for i in range(9))
    det = a * (dd * f - e * e) - b * (b * f - cc * e) + cc * (b * e - cc * dd)
    nx = (dd * f - e * e) * rx + (cc * e - b * f) * ry + (b * e - cc * dd) * rz
    ny = (cc * e - b * f) * rx + (a * f - cc * cc) * ry + (b * cc - a * e) * rz
    nz = (b * e - cc * dd) * rx + (b * cc - a * e) * ry + (a * dd - b * b) * rz
    singular = ~np.isfinite(det) | (det < 1e-5)
    inv = 1.0 / np.where(singular, 1.0, det)
    n = np.stack([np.where(singular, rx, nx * inv), np.where(singular, ry, ny * inv),
                  np.where(singular, rz, nz * inv)], -1)
    return n / (np.sqrt((n ** 2).sum(-1, keepdims=True) + 1e-20) + 1e-5), det


def angles(got, truth, det):
    """Per-pixel angle (deg) to the f64 truth over well-posed pixels: not
    degenerate (truth norm > 0.5) and away from the singular threshold,
    where f32 branches tie-break on rounding noise."""
    got = np.asarray(got, np.float64)
    na, nb = np.linalg.norm(got, axis=-1), np.linalg.norm(truth, axis=-1)
    confident = (nb > 0.5) & (np.abs(det) > 1e-3)
    cos = (got * truth).sum(-1) / np.maximum(na * nb, 1e-12)
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))[confident]


def no_worse(got, ref, truth, det):
    a, r = angles(got, truth, det), angles(ref, truth, det)
    assert a.size > 0
    assert a.mean() < r.mean() * 2 + 0.05, (a.mean(), r.mean())
    assert a.max() < max(r.max() * 2, 1.0), (a.max(), r.max())


def _inputs(rng, B=2, H=16, W=64, focal=10.0):
    depth = (2.0 + 0.2 * rng.standard_normal((B, H, W))).astype(np.float32)
    depth[0, 5:7, 10:40] = 0.0  # invalid band exercises the masking
    if B > 1:
        depth[1, :3] = 11.0  # beyond valid_max
    K = np.asarray([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    K_inv = np.broadcast_to(np.asarray(j_invert_intrinsics(jnp.asarray(K))), (B, 3, 3)).copy()
    return depth, K_inv


@pytest.mark.parametrize("k_size", [5, 9])
def test_no_worse_than_jax_against_f64_oracle(rng, k_size):
    depth, K_inv = _inputs(rng)
    truth, det = oracle_f64(depth, K_inv, k_size)
    want_n, want_p = jn.depth_to_normal(jnp.asarray(depth), jnp.asarray(K_inv), k_size)
    got_n, got_p = tn.depth_to_normal(torch.from_numpy(depth), torch.from_numpy(K_inv), k_size)
    assert tuple(got_n.shape) == (2, 16, 64, 3)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    no_worse(got_n.numpy(), np.asarray(want_n), truth, det)


def test_realistic_focal_no_worse_than_jax(rng):
    """A serving-like focal (0.9 W) and odd H, W: the ill-conditioned regime."""
    depth, K_inv = _inputs(rng, B=1, H=23, W=37, focal=0.9 * 37)
    truth, det = oracle_f64(depth, K_inv, 9)
    want_n, _ = jn.depth_to_normal(jnp.asarray(depth), jnp.asarray(K_inv), 9)
    got_n, _ = tn.depth_to_normal(torch.from_numpy(depth), torch.from_numpy(K_inv), 9)
    no_worse(got_n.numpy(), np.asarray(want_n), truth, det)


def test_analytic_tilted_plane():
    """Depth of the plane n . p = 1 gives back n (unit) away from the border."""
    H, W, f = 24, 32, 30.0
    n = np.asarray([0.2, -0.3, 0.5])
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    K_inv = np.linalg.inv(K)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([K_inv[i, 0] * u + K_inv[i, 1] * v + K_inv[i, 2] for i in range(3)], -1)
    depth = (1.0 / (rays @ n))[None].astype(np.float32)  # rays . n * d = 1
    assert (depth > 0).all() and (depth < 10).all()
    got, _ = tn.depth_to_normal(torch.from_numpy(depth),
                                torch.from_numpy(K_inv[None].astype(np.float32)), 5)
    inner = got[0, 2:-2, 2:-2].numpy()
    np.testing.assert_allclose(inner, np.broadcast_to(n / np.linalg.norm(n), inner.shape),
                               atol=2e-3)


def test_box_filter_matches_jax(rng):
    x = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    for k in (3, 5):
        np.testing.assert_allclose(tn.box_filter(torch.from_numpy(x), k).numpy(),
                                   np.asarray(jn.box_filter(jnp.asarray(x), k)), atol=1e-5)


def test_solve_matches_jax_on_well_posed_systems(rng):
    A = rng.standard_normal((50, 6, 3))
    G = np.einsum("nki,nkj->nij", A, A)
    rhs = A.sum(1)
    moments = np.concatenate([G[:, 0, :], G[:, 1, 1:], G[:, 2, 2:], rhs], -1).astype(np.float32)
    moments[0] = 0.0  # singular -> A^T 1
    got = tn.solve_normal_equations(torch.from_numpy(moments)).numpy()
    want = np.asarray(jn.solve_normal_equations(jnp.asarray(moments)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1:], np.linalg.solve(G[1:], rhs[1:, :, None])[..., 0],
                               rtol=1e-3, atol=1e-4)


def test_dispatch_on_cpu(rng):
    depth, K_inv = _inputs(rng, B=1, H=8, W=12)
    d, k = torch.from_numpy(depth), torch.from_numpy(K_inv)
    before = kn.depth_to_normal_kernel.launches
    auto, _ = tdispatch.depth_to_normal(d, k, 5)
    plain, _ = tdispatch.depth_to_normal(d, k, 5, backend="torch")
    assert kn.depth_to_normal_kernel.launches == before
    np.testing.assert_array_equal(auto.numpy(), plain.numpy())
    with pytest.raises(ValueError, match="cuda"):
        tdispatch.depth_to_normal(d, k, 5, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kn.depth_to_normal_kernel(d, k, 5)
