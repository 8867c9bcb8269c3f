"""The port's warping against ``cnmnet_tpu/geometry/warp.py`` on the CPU.

Inputs come from numpy with a seed; coordinates cover the inside of the
image, its edges and beyond on every side. Tolerances:

* ``bilinear_sample`` against JAX's gather form: 1e-6 absolute (the same
  products summed in the same order);
* against JAX's dense hat-matrix form: 1e-5 absolute (two matmuls at
  ``Precision.HIGH``);
* ``cam2pixel`` and ``inverse_warp``: 1e-6 relative to the largest value,
  values and input gradients (``jax.vjp`` against ``torch.autograd.grad``
  with the same cotangent); ``inverse_warp``'s gradients in f64 (its test
  says why).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.geometry import warp as jw  # noqa: E402
from cnmnet_tpu_torch.geometry import warp as tw  # noqa: E402

H, W, C = 7, 11, 3


def _rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _coords(rng, B=2, Q=(5, 9)):
    """Coordinates inside, on the edges, and up to 3 pixels beyond."""
    x = rng.uniform(-3.0, W + 2.0, (B,) + Q).astype(np.float32)
    y = rng.uniform(-3.0, H + 2.0, (B,) + Q).astype(np.float32)
    x[:, 0, :4] = [0.0, W - 1.0, -1.0, W]  # exact edges: taps at -1, 0, W-1, W
    y[:, 1, :4] = [0.0, H - 1.0, -1.0, H]
    x[:, 2, :3] = [-0.5, W - 0.5, 3.25]
    return x, y


def _jax_batched(fn, image, x, y):
    return np.stack([np.asarray(fn(jnp.asarray(image[b]), jnp.asarray(x[b]), jnp.asarray(y[b])))
                     for b in range(image.shape[0])])


def test_bilinear_sample_matches_gather_form(rng):
    image = rng.standard_normal((2, H, W, C)).astype(np.float32)
    x, y = _coords(rng)
    got = tw.bilinear_sample(torch.from_numpy(image), torch.from_numpy(x), torch.from_numpy(y))
    want = _jax_batched(jw.bilinear_sample, image, x, y)
    assert tuple(got.shape) == (2, 5, 9, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_bilinear_sample_matches_dense_form(rng):
    image = rng.standard_normal((2, H, W, C)).astype(np.float32)
    x, y = _coords(rng)
    got = tw.bilinear_sample(torch.from_numpy(image), torch.from_numpy(x), torch.from_numpy(y))
    want = _jax_batched(jw.bilinear_sample_dense, image, x, y)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_bilinear_sample_gradients_match(rng):
    """Image and coordinate gradients; ``floor`` contributes none."""
    image = rng.standard_normal((1, H, W, C)).astype(np.float32)
    x, y = _coords(rng, B=1)
    cot = rng.standard_normal((1, 5, 9, C)).astype(np.float32)
    _, vjp = jax.vjp(jw.bilinear_sample, jnp.asarray(image[0]), jnp.asarray(x[0]), jnp.asarray(y[0]))
    want = vjp(jnp.asarray(cot[0]))
    ti, tx, ty = (torch.from_numpy(a).requires_grad_() for a in (image, x, y))
    got = torch.autograd.grad(tw.bilinear_sample(ti, tx, ty), (ti, tx, ty), torch.from_numpy(cot))
    for g, w in zip(got, want):
        _rel(g[0].numpy(), w, 1e-6)


def _camera_inputs(rng, B=2):
    depth = rng.uniform(1.0, 4.0, (B, H, W)).astype(np.float32)
    depth[0, 2, 3] = 0.0
    f = 0.9 * W
    K = np.tile(np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32), (B, 1, 1))
    K_inv = np.linalg.inv(K).astype(np.float32)
    pose = np.zeros((B, 3, 4), np.float32)
    for b in range(B):
        a = 0.05 * rng.standard_normal()
        pose[b, :, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        pose[b, :, 3] = 0.3 * rng.standard_normal(3)
    pose[1, 2, 3] = -3.5  # pushes some points behind the source camera: the z clamp
    return depth, K, K_inv, pose


def test_cam2pixel_values_and_gradients(rng):
    depth, K, K_inv, pose = _camera_inputs(rng)
    points = np.asarray(jw.pixel2cam(jnp.asarray(depth), jnp.asarray(K_inv)))
    P = np.einsum("bij,bjk->bik", K, pose).astype(np.float32)
    R, t = P[:, :, :3].copy(), P[:, :, 3].copy()
    want, vjp = jax.vjp(jw.cam2pixel, jnp.asarray(points), jnp.asarray(R), jnp.asarray(t))
    assert (np.asarray(want[2]) < 1e-3).any()  # the clamp is exercised
    cots = [rng.standard_normal((2, H, W)).astype(np.float32) for _ in range(3)]
    want_g = vjp(tuple(jnp.asarray(c) for c in cots))
    tp, tR, tt = (torch.from_numpy(a.copy()).requires_grad_() for a in (points, R, t))
    got = tw.cam2pixel(tp, tR, tt)
    for g, w in zip(got, want):
        _rel(g.detach().numpy(), w, 1e-6)
    got_g = torch.autograd.grad(got, (tp, tR, tt), [torch.from_numpy(c) for c in cots])
    for g, w in zip(got_g, want_g):
        _rel(g.numpy(), w, 1e-6)


def test_inverse_warp_values_and_gradients(rng):
    """Values in f32. The gradients go through a chain of some ten rounded
    steps to the sampler's slope; in f32 the depth gradient differs by
    1.4e-6 of its largest value (the small products round in another
    order), so they are compared in f64 (JAX under a scoped x64)."""
    depth, K, K_inv, pose = _camera_inputs(rng)
    feat = rng.uniform(0.5, 3.0, (2, H, W, 1)).astype(np.float32)
    args = (feat, depth, pose, K, K_inv)
    want = jw.inverse_warp(*map(jnp.asarray, args))
    got = tw.inverse_warp(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        _rel(g.numpy(), w, 1e-6)

    args64 = [a.astype(np.float64) for a in args]
    cots = [rng.standard_normal(np.shape(w)) for w in want]
    with jax.enable_x64(True):
        _, vjp = jax.vjp(jw.inverse_warp, *map(jnp.asarray, args64))
        want_g = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cots))]
    t_args = [torch.from_numpy(a).requires_grad_() for a in args64]
    got_g = torch.autograd.grad(tw.inverse_warp(*t_args), t_args,
                                [torch.from_numpy(c) for c in cots])
    for g, w in zip(got_g, want_g):
        assert w.dtype == np.float64
        _rel(g.numpy(), w, 1e-6)
