"""The tile axis through the conv stack, every shard in one process.

The port splits an image's rows over the tile ranks of a mesh by a
``parallel/mesh.RowPlan`` and has every windowed layer fetch the rows it
reads. Here each shard runs in turn through the pure per-shard functions
(``sharding.rows_from_shards`` for the fetch, ``layers.conv_rows``,
``upsample_rows``, ``batch_norm_*``, ``group_norm_*``,
``tiled_ops.depth_to_normal_shard``), and the shards together are held to
the unsharded layer in f64 within 1e-12, forward and gradient:

* the plan against brute force at heights 64, 128, 160 and 480 and tiles
  2 and 4: each level's split balanced and contiguous, each stage's input
  rows the union of its output rows' taps, and the plan refusing exactly
  where brute force finds an empty shard or a tap beyond a neighbour;
* the port's ``tile_partition_safe`` equal to the JAX function over a grid
  of heights and tiles;
* a stride-1 and a stride-2 conv, both x2 upsamplings (the bilinear one
  edge-clamped at the image border), BatchNorm (its backward's two sums
  over the shards) and GroupNorm (per-sample sums over the shards), at an
  even split and at an uneven one (1/32 of 160 rows over tile 2);
* depth->normal's gradient across the halo, which the fetch returns to the
  rows' owners.

The collectives themselves run over gloo processes in
``tests/test_torch_tiled_mesh.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cnmnet_tpu.parallel.sharding import tile_partition_safe as j_safe  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch  # noqa: E402
from cnmnet_tpu_torch.models import layers  # noqa: E402
from cnmnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from cnmnet_tpu_torch.parallel import sharding, tiled_ops  # noqa: E402

TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = got.detach(), want.detach()
    err = float((got - want).abs().max() / max(float(want.abs().max()), 1e-300))
    assert err <= tol, err


# -- the plan ---------------------------------------------------------------------


def _taps(kind, j, k, stride, extent_in):
    """The input rows output row ``j`` reads, by the operators' own rules."""
    if kind == "conv":
        pad = (k - 1) // 2
        return [stride * j - pad + d for d in range(k)]
    if kind == "nearest":
        return [j // 2]
    src = max((j + 0.5) / 2 - 0.5, 0.0)  # PyTorch's half-pixel rule, edge-clamped
    i0 = int(np.floor(src))
    return [i0, min(i0 + 1, extent_in - 1)]


def _brute_force(height, tile):
    """(problem or None, per-stage per-tile tap sets): the first reason the
    layout cannot hold, found by enumerating every row."""
    extents = [height >> lvl for lvl in range(6)]
    owner = []
    for n in extents:
        if n < tile:
            return "empty shard", None
        owner.append([min(i for i in range(tile) if r < (i + 1) * n // tile) for r in range(n)])
    taps = {}
    for name, kind, lvl, k, stride in tmesh.CNM_STAGES:
        out = lvl + (stride == 2) if kind == "conv" else lvl - 1
        for i in range(tile):
            rows = [j for j in range(extents[out]) if owner[out][j] == i]
            t = {r for j in rows for r in _taps(kind, j, k, stride, extents[lvl])}
            taps[name, i] = t
            inside = [r for r in t if 0 <= r < extents[lvl]]
            if any(abs(owner[lvl][r] - i) > 1 for r in inside):
                return "beyond a neighbour", taps
    return None, taps


@pytest.mark.parametrize("height", [64, 128, 160, 480])
@pytest.mark.parametrize("tile", [2, 4])
def test_row_plan_against_brute_force(height, tile):
    problem, taps = _brute_force(height, tile)
    if problem is not None:
        with pytest.raises(ValueError, match="fewer than tile" if problem == "empty shard"
                           else "beyond its neighbours"):
            tmesh.RowPlan(height, tile)
        return
    plan = tmesh.RowPlan(height, tile)
    for lvl, n in enumerate(plan.extents):
        assert n == height >> lvl
        sizes = [b - a for a, b in plan.ranges[lvl]]
        assert plan.ranges[lvl][0][0] == 0 and plan.ranges[lvl][-1][1] == n
        assert all(plan.ranges[lvl][i][1] == plan.ranges[lvl][i + 1][0] for i in range(tile - 1))
        assert max(sizes) - min(sizes) <= 1
    for stage in tmesh.CNM_STAGES:
        name = stage[0]
        for i in range(tile):
            t = taps[name, i]
            assert plan.stage_rows(stage, i) == (min(t), max(t) + 1), (name, i)


def test_row_plan_at_native_resolution_splits_the_coarsest_level_unevenly():
    plan = tmesh.RowPlan(480, 2)
    assert plan.ranges[5] == [(0, 7), (7, 15)]
    assert plan.ranges[4] == [(0, 15), (15, 30)]
    # upsampling 1/32's rank-0 rows [0, 7) does not give 1/16's [0, 15):
    # rank 0 reads 1/32 rows [0, 8), one of them rank 1's
    assert tmesh.upsample_input_rows(plan.rows(4, 1), 15, "bilinear") == (7, 15)
    assert tmesh.upsample_input_rows(plan.rows(4, 0), 15, "bilinear") == (0, 8)
    with pytest.raises(ValueError, match="divisible by 32"):
        tmesh.RowPlan(100, 1)


def test_tile_partition_safe_is_the_jax_function():
    for height in list(range(32, 1025, 32)) + [100, 127, 161, 481]:
        for tile in range(1, 9):
            assert sharding.tile_partition_safe(height, tile) == j_safe(height, tile), (height,
                                                                                         tile)


def test_fetch_table_sends_only_what_others_read():
    ranges = ((0, 7), (7, 15))
    needs = ((-1, 8), (6, 16))
    send, table, m = sharding.fetch_table(ranges, needs, 1)
    assert send == ((6,), (0,)) and m == 1
    # rank 1: row 6 from rank 0's send block, its own 8 rows, one zero row
    assert table == (8,) + tuple(range(8)) + (8 + 2,)


# -- layers, shard by shard -----------------------------------------------------------


def _shards(x, ranges):
    return [x[:, :, a:b].clone().requires_grad_(True) for a, b in ranges]


def _grads(outs, shards, params, r):
    loss = sum((o * ri).sum() for o, ri in zip(outs, r))
    return torch.autograd.grad(loss, shards + params)


LAYER_PLANS = [(128, 2, 3), (128, 4, 2), (160, 2, 4)]  # (height, tile, level of the input)


@pytest.mark.parametrize("height,tile,level", LAYER_PLANS)
@pytest.mark.parametrize("k,stride", [(3, 1), (7, 1), (3, 2), (5, 2)])
def test_conv_shards_are_the_conv(height, tile, level, k, stride):
    g = torch.Generator().manual_seed(k + stride)
    plan = tmesh.RowPlan(height, tile)
    conv = layers.Conv2d(3, 4, k, stride, padding=(k - 1) // 2, bias=True).double()
    with torch.no_grad():
        conv.weight.normal_(generator=g)
        conv.bias.normal_(generator=g)
    n, w = plan.extents[level], 16
    x = torch.randn(2, 3, n, w, generator=g, dtype=torch.float64)
    out_level = level + (stride == 2)
    want = conv(x)
    ranges = plan.ranges[level]
    shards = _shards(x, ranges)
    outs = [layers.conv_rows(conv, sharding.rows_from_shards(
        shards, ranges, tmesh.conv_input_rows(plan.rows(out_level, i), k, stride), 2))
        for i in range(tile)]
    _close(torch.cat(outs, 2), want)
    r = torch.randn(want.shape, generator=g, dtype=torch.float64)
    got = _grads(outs, shards, [conv.weight, conv.bias],
                 [r[:, :, a:b] for a, b in plan.ranges[out_level]])
    xr = x.clone().requires_grad_(True)
    ref = torch.autograd.grad((conv(xr) * r).sum(), [xr, conv.weight, conv.bias])
    _close(torch.cat(got[:tile], 2), ref[0])
    for a, b in zip(got[tile:], ref[1:]):
        _close(a, b)


@pytest.mark.parametrize("height,tile,level", LAYER_PLANS)
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_upsample_shards_are_the_upsampling(height, tile, level, mode):
    g = torch.Generator().manual_seed(7)
    plan = tmesh.RowPlan(height, tile)
    x = torch.randn(2, 3, plan.extents[level], 8, generator=g, dtype=torch.float64)
    up = layers.upsample2x_bilinear if mode == "bilinear" else layers.upsample2x_nearest
    want = up(x)
    ranges = plan.ranges[level]
    shards = _shards(x, ranges)
    outs = []
    for i in range(tile):
        need = tmesh.upsample_input_rows(plan.rows(level - 1, i), plan.extents[level], mode)
        rows = sharding.rows_from_shards(shards, ranges, need, 2)
        outs.append(layers.upsample_rows(rows, need[0], plan.rows(level - 1, i), mode))
    assert torch.equal(torch.cat(outs, 2), want)  # the same arithmetic on the same values
    r = torch.randn(want.shape, generator=g, dtype=torch.float64)
    got = _grads(outs, shards, [], [r[:, :, a:b] for a, b in plan.ranges[level - 1]])
    xr = x.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad((up(xr) * r).sum(), [xr])
    _close(torch.cat(got, 2), ref)


@pytest.mark.parametrize("height,tile,level", LAYER_PLANS)
def test_batch_norm_shards_are_the_batch_norm(height, tile, level):
    """Forward through the summed partials, backward through the summed
    gradient partials: the two sums the layer takes over the mesh."""
    g = torch.Generator().manual_seed(3)
    plan = tmesh.RowPlan(height, tile)
    C, eps = 5, 1e-5
    x = 1.5 + torch.randn(2, C, plan.extents[level], 8, generator=g, dtype=torch.float64)
    weight = torch.randn(C, generator=g, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(C, generator=g, dtype=torch.float64, requires_grad=True)
    ranges = plan.ranges[level]
    shards = [x[:, :, a:b] for a, b in ranges]
    sums = sum(layers.batch_norm_partials(s) for s in shards)
    mean, var, raw, count = layers.batch_norm_stats(sums)
    outs = [layers.batch_norm_apply(s, mean, var, weight, bias, eps) for s in shards]
    xr = x.clone().requires_grad_(True)
    want = torch.nn.functional.batch_norm(xr, None, None, weight, bias, True, 0.0, eps)
    _close(torch.cat(outs, 2), want)
    assert float(count) == x.numel() // C
    r = torch.randn(want.shape, generator=g, dtype=torch.float64)
    rs = [r[:, :, a:b] for a, b in ranges]
    gsums = sum(layers.batch_norm_grad_partials(ri, s, mean) for ri, s in zip(rs, shards))
    gx = [layers.batch_norm_grad(ri, s, mean, var, raw, weight, gsums, count, eps)
          for ri, s in zip(rs, shards)]
    ref = torch.autograd.grad((want * r).sum(), [xr, weight, bias])
    _close(torch.cat(gx, 2), ref[0])
    inv = torch.rsqrt(var + eps)
    _close(gsums[C:] * inv, ref[1])  # the sum of the shards' weight gradients
    _close(gsums[:C], ref[2])


@pytest.mark.parametrize("height,tile,level", LAYER_PLANS)
def test_group_norm_shards_are_the_group_norm(height, tile, level):
    g = torch.Generator().manual_seed(4)
    plan = tmesh.RowPlan(height, tile)
    norm = layers.GroupNormF32(4, 8, eps=1e-5).double()
    with torch.no_grad():
        norm.weight.normal_(generator=g)
        norm.bias.normal_(generator=g)
    x = 0.5 + torch.randn(2, 8, plan.extents[level], 8, generator=g, dtype=torch.float64)
    want = norm(x)
    ranges = plan.ranges[level]
    shards = _shards(x, ranges)
    sums = sum(layers.group_norm_partials(s, 4) for s in shards)
    outs = [layers.group_norm_apply(s, sums, norm.weight, norm.bias, norm.eps) for s in shards]
    _close(torch.cat(outs, 2), want)
    r = torch.randn(want.shape, generator=g, dtype=torch.float64)
    got = _grads(outs, shards, [norm.weight, norm.bias], [r[:, :, a:b] for a, b in ranges])
    xr = x.clone().requires_grad_(True)
    ref = torch.autograd.grad((norm(xr) * r).sum(), [xr, norm.weight, norm.bias])
    _close(torch.cat(got[:tile], 2), ref[0])
    for a, b in zip(got[tile:], ref[1:]):
        _close(a, b)


@pytest.mark.parametrize("tile", [2, 4])
@pytest.mark.parametrize("k_size", [5, 9])
def test_depth_to_normal_gradient_crosses_the_halo(tile, k_size):
    """Each shard's normals from its depth rows with ``k // 2`` rows of each
    neighbour: the gradient of every depth row, summed over the shards that
    read it, is the untiled op's (f64, the plain version)."""
    rng = np.random.default_rng(k_size + tile)
    B, H, W, halo = 2, 64, 12, k_size // 2
    depth = torch.from_numpy(2.0 + 0.3 * rng.standard_normal((B, H, W)))
    depth[:, 14:17] = 0.0  # an invalid band across the tile-4 boundary
    K = torch.tensor([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], dtype=torch.float64)
    kinv = torch.linalg.inv(K).expand(B, 3, 3).contiguous()
    ranges = tmesh.split_rows(H, tile)
    shards = [depth[:, a:b].clone().requires_grad_(True) for a, b in ranges]
    outs = [tiled_ops.depth_to_normal_shard(
        sharding.rows_from_shards(shards, ranges, (a - halo, b + halo), 1), kinv, a, halo, k_size)
        for a, b in ranges]
    dr = depth.clone().requires_grad_(True)
    want, _ = dispatch.depth_to_normal(dr, kinv, k_size)
    _close(torch.cat(outs, 1), want)
    r = torch.from_numpy(rng.standard_normal(want.shape))
    got = torch.autograd.grad(sum((o * r[:, a:b]).sum() for o, (a, b) in zip(outs, ranges)),
                              shards)
    (ref,) = torch.autograd.grad((want * r).sum(), [dr])
    _close(torch.cat(got, 1), ref)
    # the rows next to each boundary take gradient from both sides
    a = ranges[1][0]
    assert float(ref[:, a - halo:a + halo].abs().max()) > 0
