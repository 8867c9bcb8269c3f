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

import ctypes

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


@pytest.mark.parametrize("k_size", [5, 9, 19])
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


def _kernel_order_normals(depth, K_inv, k_size, vmin=0.0, vmax=10.0):
    """The CUDA kernel's staging and sum order in plain PyTorch: the depth
    tile zero-filled outside the image (as cp.async fills it), every staged
    depth backprojected at its own pixel (u, v may lie outside the image)
    and masked, then each window sum taken from 0, taps first to last,
    vertical pass then horizontal."""
    B, H, W = depth.shape
    r = k_size // 2
    d = torch.nn.functional.pad(depth, (r, r, r, r))
    v, u = torch.meshgrid(torch.arange(-r, H + r, dtype=torch.float32),
                          torch.arange(-r, W + r, dtype=torch.float32), indexing="ij")
    k = K_inv[:, :, :, None, None]
    rays = k[:, :, 0] * u + k[:, :, 1] * v + k[:, :, 2]  # [B, 3, H + 2r, W + 2r]
    valid = ((d > vmin) & (d < vmax))[:, None]
    p = torch.where(valid, rays * d[:, None], torch.zeros(()))
    x, y, z = p.unbind(1)
    monos = torch.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z], -1)
    vert = torch.zeros(B, H, W + 2 * r, 9)
    for t in range(k_size):
        vert = vert + monos[:, t:t + H]
    moments = torch.zeros(B, H, W, 9)
    for t in range(k_size):
        moments = moments + vert[:, :, t:t + W]
    n = tn.solve_normal_equations(moments)
    nx, ny, nz = n.unbind(-1)
    return n / (torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-20)[..., None] + 1e-5)


@pytest.mark.parametrize("k_size", [1, 5, 9, 17, 19, 31])
def test_kernel_staging_order_equals_plain(rng, k_size):
    """Zero-filled staging and sums from 0 give the plain version's normals
    exactly (up to the sign of zero), at and inside every image edge, with
    invalid depths (0 and beyond valid_max) inside the image. k = 19 and 31
    take the kernel's k-generic instance, which keeps this order; 31 spans
    more than the image's 13 rows."""
    depth, K_inv = _inputs(rng, B=2, H=13, W=29, focal=0.9 * 29)
    d, k = torch.from_numpy(depth), torch.from_numpy(K_inv)
    want, _ = tn.depth_to_normal(d, k, k_size)
    np.testing.assert_array_equal(_kernel_order_normals(d, k, k_size).numpy(), want.numpy())


def test_kernel_shared_memory_and_largest_k():
    """The wrapper's count of a block's shared memory is the kernel
    header's (34,560 B at k = 9); the unrolled instances and the k-generic
    one (one piece's vertical sums, 36,864 B) stay under the 48 KB a launch
    takes without opting in, so there is no largest k."""
    assert kn.shared_bytes(9) == 34_560
    assert kn.shared_bytes(kn.UNROLLED_K) <= 48 * 1024
    assert kn.shared_bytes(kn.UNROLLED_K + 2) == 9 * kn.TILE_H * kn.PIECE_W * 4 == 36_864
    assert not hasattr(kn, "max_k") and not hasattr(kn, "largest_k")


def test_shared_memory_fits_an_h100_block_at_every_odd_k():
    """Every odd k up to 1025 (and far beyond) takes at most the 232,448 B
    a block may opt into on an H100; above ``UNROLLED_K`` the count no
    longer grows with k."""
    sizes = {k: kn.shared_bytes(k) for k in range(1, 1026, 2)}
    assert max(sizes.values()) <= 232_448
    assert {sizes[k] for k in sizes if k > kn.UNROLLED_K} == {kn.shared_bytes(100_001)}


SEG_ROWS = 4  # csrc/depth_to_normal.cu:kSegRows, output rows a vertical segment


def _generic_kernel_normals(depth, K_inv, k_size, vmin=0.0, vmax=10.0):
    """The k-generic CUDA instance's order in plain PyTorch: 64 x 8 output
    tiles whose 64 + k - 1 staged columns go in pieces of ``PIECE_W``. In a
    piece, each column's segment of ``SEG_ROWS`` output rows walks the
    column's rows top to bottom (depth 0 outside the image, each point
    backprojected at its own pixel and masked) and adds each row's
    monomials to the sum of every segment row whose window holds it; then
    each output adds the piece's columns inside its window, left to right,
    to running sums kept across the pieces. Every sum starts from 0."""
    B, H, W = depth.shape
    r = k_size // 2
    TW, TH, PW = kn.TILE_W, kn.TILE_H, kn.PIECE_W
    Ht, Wt, SW = -(-H // TH) * TH, -(-W // TW) * TW, TW + 2 * r
    d = torch.nn.functional.pad(depth, (r, Wt - W + r, r, Ht - H + r))
    v, u = torch.meshgrid(torch.arange(-r, Ht + r, dtype=torch.float32),
                          torch.arange(-r, Wt + r, dtype=torch.float32), indexing="ij")
    k = K_inv[:, :, :, None, None]
    rays = k[:, :, 0] * u + k[:, :, 1] * v + k[:, :, 2]
    p = torch.where(((d > vmin) & (d < vmax))[:, None], rays * d[:, None], torch.zeros(()))
    x, y, z = p.unbind(1)
    monos = torch.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z], -1)
    moments = torch.zeros(B, Ht, Wt, 9)
    outs = torch.arange(TW)
    for row0 in range(0, Ht, TH):
        for col0 in range(0, Wt, TW):
            s = torch.zeros(B, TH, TW, 9)
            for c0 in range(0, SW, PW):
                cols = monos[:, :, col0 + c0:col0 + min(c0 + PW, SW)]
                vsum = torch.zeros(B, TH, cols.shape[2], 9)
                for vr0 in range(0, TH, SEG_ROWS):
                    acc = torch.zeros(B, SEG_ROWS, cols.shape[2], 9)
                    for t in range(SEG_ROWS + k_size - 1):
                        m = cols[:, row0 + vr0 + t]
                        for q in range(SEG_ROWS):
                            if q <= t < q + k_size:
                                acc[:, q] = acc[:, q] + m
                    vsum[:, vr0:vr0 + SEG_ROWS] = acc
                for cc in range(c0, c0 + cols.shape[2]):
                    inside = ((outs <= cc) & (cc < outs + k_size))[None, None, :, None]
                    s = torch.where(inside, s + vsum[:, :, cc - c0, None], s)
            moments[:, row0:row0 + TH, col0:col0 + TW] = s
    n = tn.solve_normal_equations(moments[:, :H, :W])
    nx, ny, nz = n.unbind(-1)
    return n / (torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-20)[..., None] + 1e-5)


@pytest.mark.parametrize("k_size, H, W", [(19, 13, 29), (89, 13, 29), (129, 13, 29),
                                          (131, 64, 64)])
def test_generic_kernel_order_equals_plain(rng, k_size, H, W):
    """The k-generic instance's pieces, segments and tap order give the
    plain version's normals exactly (up to the sign of zero): at k = 19
    (one piece), 89 and 129 (two pieces; windows past every edge of the
    13 x 29 map) and at k = 131 on 64 x 64, a window wider than both sides
    and tiles whose halo lies outside the map."""
    depth, K_inv = _inputs(rng, B=2, H=H, W=W, focal=0.9 * W)
    d, k = torch.from_numpy(depth), torch.from_numpy(K_inv)
    want, _ = tn.depth_to_normal(d, k, k_size)
    np.testing.assert_array_equal(_generic_kernel_normals(d, k, k_size).numpy(), want.numpy())


def test_wide_k_no_worse_than_jax_against_f64_oracle(rng):
    """k = 89, a window larger than the 16 x 64 map: the port's
    depth->normal (the plain version on the CPU) against
    ``cnmnet_tpu.ops.normals.depth_to_normal`` by the f64-oracle rule. The
    JAX package's Pallas kernel takes k <= 17 only (its 8-row halo), so
    its jnp op is what it runs at this k."""
    depth, K_inv = _inputs(rng)
    truth, det = oracle_f64(depth, K_inv, 89)
    want_n, want_p = jn.depth_to_normal(jnp.asarray(depth), jnp.asarray(K_inv), 89)
    got_n, got_p = kn.depth_to_normal(torch.from_numpy(depth), torch.from_numpy(K_inv), 89)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    no_worse(got_n.numpy(), np.asarray(want_n), truth, det)


def test_batch_chunks_cover_the_batch(monkeypatch):
    assert kn.batch_chunks(8) == [(0, 8)]
    assert kn.batch_chunks(65_536) == [(0, 65_535), (65_535, 65_536)]
    monkeypatch.setattr(kn, "MAX_BATCH", 3)
    assert kn.batch_chunks(8) == [(0, 3), (3, 6), (6, 8)]
    assert kn.batch_chunks(3) == [(0, 3)] and kn.batch_chunks(0) == []


class _OnCard(torch.Tensor):
    """A CPU tensor that passes the wrapper's ``is_cuda`` check, so that its
    launch loop runs here against a stand-in library."""

    @property
    def is_cuda(self):
        return True


def test_kernel_launches_batch_chunks_into_one_output(rng, monkeypatch):
    """``depth_to_normal_kernel`` with the batch limit lowered to 3 and its
    library stood in by the plain version: 8 maps in launches of 3, 3 and
    2 maps, each at its slice of the depth, K^-1 and the one output, equal
    to the plain normals of the whole batch; the counter adds one a
    launch."""
    import contextlib
    import types

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kn, "MAX_BATCH", 3)
    depth, K_inv = _inputs(rng, B=8, H=9, W=12, focal=0.9 * 12)
    d = torch.from_numpy(depth).as_subclass(_OnCard)
    ki = torch.from_numpy(K_inv).as_subclass(_OnCard)
    plain_d, plain_ki = d.as_subclass(torch.Tensor), ki.as_subclass(torch.Tensor)
    calls = []

    def launch(d_p, k_p, out_p, B, H, W, k_size, row_offset, vmin, vmax, det_eps, norm_eps, stream):
        b0 = (d_p - d.data_ptr()) // (H * W * 4)
        assert k_p == ki[b0].data_ptr() and row_offset == 2
        calls.append((b0, b0 + B))
        n = tn.depth_to_normal(plain_d[b0:b0 + B], plain_ki[b0:b0 + B], k_size,
                               row_offset=row_offset)[0].reshape(-1)
        torch.frombuffer((ctypes.c_float * n.numel()).from_address(out_p),
                         dtype=torch.float32).copy_(n)
        return 0

    monkeypatch.setattr(kn.build, "load", lambda name: types.SimpleNamespace(cnm_depth_to_normal=launch))
    before = kn.depth_to_normal_kernel.launches
    got = kn.depth_to_normal_kernel(d, ki, 5, row_offset=2)
    assert calls == [(0, 3), (3, 6), (6, 8)] and kn.depth_to_normal_kernel.launches - before == 3
    want, _ = tn.depth_to_normal(plain_d, plain_ki, 5, row_offset=2)
    assert torch.equal(got.as_subclass(torch.Tensor), want)


# -- gradients -----------------------------------------------------------------


def test_box_filter_gradient_is_the_slice_sums_gradient(rng):
    """The Function's self-adjoint backward equals autograd through the
    shifted-slice sum, and the forward is that sum exactly."""
    x = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    cot = rng.standard_normal((2, 9, 13, 4)).astype(np.float32)
    for k in (3, 5, 9):
        a = torch.from_numpy(x).requires_grad_()
        b = torch.from_numpy(x).requires_grad_()
        fa, fb = tn.box_filter(a, k), tn.box_sum(b, k)
        assert torch.equal(fa, fb)
        (ga,) = torch.autograd.grad(fa, a, torch.from_numpy(cot))
        (gb,) = torch.autograd.grad(fb, b, torch.from_numpy(cot))
        err = (ga - gb).abs().max() / gb.abs().max()
        assert err <= 1e-6, (k, float(err))


def _plain_kernel(depth, intrinsics_inv, k_size=9, row_offset=0):
    """Stands in for the CUDA kernel on the CPU: the plain normals."""
    return tn.depth_to_normal(depth, intrinsics_inv, k_size, row_offset=row_offset)[0]


@pytest.mark.parametrize("with_kinv", [False, True])
def test_depth_to_normal_function_gradient_equals_plain(rng, monkeypatch, with_kinv):
    """With the kernel stood in by the plain version, the Function's
    forward and its gradients equal plain autograd's exactly: its backward
    is that autograd, recomputed from the saved inputs."""
    monkeypatch.setattr(kn, "depth_to_normal_kernel", _plain_kernel)
    depth, K_inv = _inputs(rng, B=2, H=12, W=20, focal=0.9 * 20)
    cot = torch.from_numpy(rng.standard_normal((2, 12, 20, 3)).astype(np.float32))
    d1, d2 = (torch.from_numpy(depth).requires_grad_() for _ in range(2))
    k1, k2 = (torch.from_numpy(K_inv).requires_grad_(with_kinv) for _ in range(2))
    n1 = kn.DepthToNormal.apply(d1, k1, 9)
    n2, _ = tn.depth_to_normal(d2, k2, 9)
    assert torch.equal(n1, n2)
    wrt1, wrt2 = ((d1, k1), (d2, k2)) if with_kinv else ((d1,), (d2,))
    for a, b in zip(torch.autograd.grad(n1, wrt1, cot), torch.autograd.grad(n2, wrt2, cot)):
        assert torch.equal(a, b)


def test_depth_to_normal_gradient_matches_jax_in_f64(rng):
    """The plain version's depth and K^-1 gradients in f64 against
    ``jax.vjp`` of ``cnmnet_tpu.ops.normals.depth_to_normal`` under a
    scoped x64: 1e-9 relative to each gradient's largest value."""
    import jax

    depth, K_inv = _inputs(rng, B=2, H=12, W=20)
    depth, K_inv = depth.astype(np.float64), K_inv.astype(np.float64)
    cot = rng.standard_normal((2, 12, 20, 3))
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda d, k: jn.depth_to_normal(d, k, 5)[0],
                         jnp.asarray(depth), jnp.asarray(K_inv))
        want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    d, k = (torch.from_numpy(a).requires_grad_() for a in (depth, K_inv))
    got = torch.autograd.grad(tn.depth_to_normal(d, k, 5)[0], (d, k), torch.from_numpy(cot))
    for g, w in zip(got, want):
        assert w.dtype == np.float64
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-9, err


def test_depth_to_normal_function_gradcheck(rng, monkeypatch):
    """``torch.autograd.gradcheck`` of the Function in f64 at 2x9x11, k = 5
    (the kernel stood in by the plain version)."""
    monkeypatch.setattr(kn, "depth_to_normal_kernel", _plain_kernel)
    depth, K_inv = _inputs(rng, B=2, H=9, W=11)
    depth[0, 5:7] = -1.0  # invalid, and away from the mask's edge at 0, where
    # a finite difference would step across it
    d = torch.from_numpy(depth.astype(np.float64)).requires_grad_()
    k = torch.from_numpy(K_inv.astype(np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: kn.DepthToNormal.apply(a, b, 5), (d, k))


@pytest.mark.parametrize("all_invalid", [False, True])
def test_normal_mean_angle_deg_matches_jax(rng, all_invalid):
    pred = rng.standard_normal((2, 12, 16, 3)).astype(np.float32)
    gt = rng.standard_normal((2, 12, 16, 3)).astype(np.float32)
    gt[0, :2] = 0.0  # zero normals: the 1e-8 guard
    valid = rng.random((2, 12, 16)) > (1.0 if all_invalid else 0.3)
    want = jn.normal_mean_angle_deg(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid))
    got = tn.normal_mean_angle_deg(torch.from_numpy(pred), torch.from_numpy(gt),
                                   torch.from_numpy(valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)
    if all_invalid:
        assert got.item() == 0.0
