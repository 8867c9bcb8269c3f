"""The port's camera algebra and backprojection against the JAX package.

Same numpy inputs through ``cnmnet_tpu.geometry`` and
``cnmnet_tpu_torch.geometry`` on the CPU. Tolerance: 7.6e-6 relative to
the largest magnitude of each result, the figure the JAX package itself
reached against the reference's camera code (both sides are f32 with the
same formulas; only the summation order of the small products differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu import geometry as jg  # noqa: E402
from cnmnet_tpu_torch import geometry as tg  # noqa: E402

TOL = 7.6e-6


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, err


def _rotation(rng):
    q = rng.standard_normal(4)
    a, b, c, d = q / np.linalg.norm(q)
    return np.asarray([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d],
    ])


def _cams(rng, B, H=24, W=40):
    """``[B, 2, 2, 4, 4]``: a ref and a src camera per sample, with skew."""
    cams = np.zeros((B, 2, 2, 4, 4), np.float32)
    for b in range(B):
        for v in range(2):
            E = np.eye(4)
            E[:3, :3] = _rotation(rng) if v else np.eye(3) + 0.01 * rng.standard_normal((3, 3))
            E[:3, 3] = 0.3 * rng.standard_normal(3)
            f = rng.uniform(40, 120)
            K = np.asarray([[f, rng.uniform(-1, 1), W / 2 + rng.uniform(-3, 3)],
                            [0, f * rng.uniform(0.9, 1.1), H / 2 + rng.uniform(-3, 3)],
                            [0, 0, 1]])
            cams[b, v, 0] = E
            cams[b, v, 1, :3, :3] = K
    return cams


@pytest.fixture
def cams(rng):
    return _cams(rng, 3)


def test_camera_from_array(cams):
    jc = jg.camera_from_array(jnp.asarray(cams))
    tc = tg.camera_from_array(torch.from_numpy(cams))
    np.testing.assert_array_equal(tc.extrinsic.numpy(), np.asarray(jc.extrinsic))
    np.testing.assert_array_equal(tc.intrinsic.numpy(), np.asarray(jc.intrinsic))
    assert tc.batch_shape == (3, 2)


def test_invert_intrinsics(cams):
    K = cams[:, :, 1, :3, :3]
    _close(tg.invert_intrinsics(torch.from_numpy(K)), jg.invert_intrinsics(jnp.asarray(K)))


def test_invert_se3(cams):
    E = cams[:, :, 0]
    _close(tg.invert_se3(torch.from_numpy(E)), jg.invert_se3(jnp.asarray(E)))


def test_relative_pose(cams):
    jr, js = (jg.camera_from_array(jnp.asarray(cams[:, v])) for v in (0, 1))
    tr, ts = (tg.camera_from_array(torch.from_numpy(cams[:, v])) for v in (0, 1))
    _close(tg.relative_pose(tr, ts), jg.relative_pose(jr, js))


def test_pixel_grid():
    np.testing.assert_array_equal(tg.pixel_grid(5, 7).numpy(), np.asarray(jg.pixel_grid(5, 7)))


@pytest.mark.parametrize("hw", [(24, 40), (7, 13)])
def test_plane_sweep_terms(rng, hw):
    H, W = hw
    cams = _cams(rng, 2, H, W)
    jr, js = (jg.camera_from_array(jnp.asarray(cams[:, v])) for v in (0, 1))
    tr, ts = (tg.camera_from_array(torch.from_numpy(cams[:, v])) for v in (0, 1))
    j_uv, j_kt = jg.plane_sweep_terms(jr, js, H, W)
    t_uv, t_kt = tg.plane_sweep_terms(tr, ts, H, W)
    _close(t_uv, j_uv)
    _close(t_kt, j_kt)


def test_pixel2cam_full_inverse(rng):
    """A K^-1 with a non-pinhole last row: the full matrix is used."""
    depth = rng.uniform(0.5, 5.0, (2, 9, 14)).astype(np.float32)
    K_inv = rng.standard_normal((2, 3, 3)).astype(np.float32)
    want = jg.pixel2cam(jnp.asarray(depth), jnp.asarray(K_inv))
    got = tg.pixel2cam(torch.from_numpy(depth), torch.from_numpy(K_inv))
    _close(got, want)


@pytest.mark.parametrize("scale", [(0.25, 0.2), (256 / 1296, 192 / 968)])
def test_scale_intrinsics(rng, scale):
    K = _cams(rng, 3, 48, 64)[:, 0, 1, :3, :3]
    want = jg.scale_intrinsics(jnp.asarray(K), *scale)
    got = tg.scale_intrinsics(torch.from_numpy(K), *scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_camera_to_array_round_trip(cams):
    for v in range(cams.shape[1]):
        jc = jg.camera_from_array(jnp.asarray(cams[:, v]))
        tc = tg.camera_from_array(torch.from_numpy(cams[:, v]))
        got = tg.camera_to_array(tc).numpy()
        np.testing.assert_array_equal(got, np.asarray(jg.camera_to_array(jc)))
        np.testing.assert_array_equal(got[..., 0, :, :], cams[:, v, 0])
