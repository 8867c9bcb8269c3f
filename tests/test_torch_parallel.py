"""The port's ``parallel/`` against ``cnmnet_tpu.parallel`` on the virtual
CPU mesh, every shard run in this one process.

* ``mesh``: the port's rank layout is the JAX mesh's device layout
  (``np.asarray(devices).reshape(data, tile)``) for 8 ranks; with no
  process group, ``make_mesh`` is the 1x1 mesh and keeps the JAX asserts.
* ``sharding``: the per-shard row fetch of a halo at tile 2 and 4 gives
  each shard exactly what JAX ``halo_exchange_rows`` gives it under
  ``shard_map`` (atol 0); ``batch_shard`` slices dim 0.
* ``tiled_ops``: the per-shard computations at tile 2 and 4, concatenated,
  are bit-equal to the port's untiled op, and match the JAX tiled op
  within the port's A/B tolerances: for normals the rule of
  ``tests/test_torch_normals.py`` (no worse than JAX against an f64
  oracle), for the cost volume 2e-4 absolute on white-noise images
  (``tests/test_torch_cost_volume.py``).

The collectives themselves run over two gloo processes in
``tests/test_torch_ranks.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from cnmnet_tpu.geometry.camera import Camera as JCamera  # noqa: E402
from cnmnet_tpu.geometry.camera import invert_intrinsics as j_invert_intrinsics  # noqa: E402
from cnmnet_tpu.geometry.camera import plane_sweep_terms as j_terms  # noqa: E402
from cnmnet_tpu.ops.cost_volume import idepth_hypotheses as j_idepths  # noqa: E402
from cnmnet_tpu.parallel import mesh as jmesh  # noqa: E402
from cnmnet_tpu.parallel.sharding import halo_exchange_rows as j_halo  # noqa: E402
from cnmnet_tpu.parallel.tiled_ops import cost_volume_tiled as j_cv_tiled  # noqa: E402
from cnmnet_tpu.parallel.tiled_ops import depth_to_normal_tiled as j_dn_tiled  # noqa: E402
from cnmnet_tpu_torch.geometry.camera import Camera  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch  # noqa: E402
from cnmnet_tpu_torch.parallel import collectives  # noqa: E402
from cnmnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from cnmnet_tpu_torch.parallel import sharding, tiled_ops  # noqa: E402
from test_torch_normals import no_worse, oracle_f64  # noqa: E402

CV_TOL = 2e-4


def _jax_mesh(tile, data=1):
    return jmesh.make_mesh(data=data, tile=tile, devices=jax.devices()[:data * tile])


# -- mesh ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,tile", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_rank_layout_is_the_jax_device_layout(data, tile):
    jm = jmesh.make_mesh(data=data, tile=tile, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        m = tmesh.Mesh(data, tile, list(range(8)), r)
        assert m.shape == dict(jm.shape)
        assert ids[m.data_index, m.tile_index] == r
        same_tile = [q for q in range(8) if tmesh.Mesh(data, tile, list(range(8)), q).tile_index
                     == m.tile_index]
        same_data = [q for q in range(8) if tmesh.Mesh(data, tile, list(range(8)), q).data_index
                     == m.data_index]
        assert same_tile == list(ids[:, m.tile_index])
        assert same_data == list(ids[m.data_index])


def test_make_mesh_without_a_process_group():
    m = tmesh.make_mesh()
    assert (m.shape, m.data_index, m.tile_index) == ({"data": 1, "tile": 1}, 0, 0)
    assert m.data_group is None and m.tile_group is None
    assert tmesh.make_mesh(data=1, tile=1).size == 1
    with pytest.raises(AssertionError):
        tmesh.make_mesh(tile=2)
    with pytest.raises(AssertionError):
        tmesh.make_mesh(data=2)
    assert tmesh.local_batch_size(8, m) == 8
    with pytest.raises(AssertionError):
        jmesh.make_mesh(data=3, tile=2, devices=jax.devices()[:4])


def test_batch_shards():
    batch = {"a": np.arange(12).reshape(6, 2), "b": torch.arange(6)}
    for i in range(3):
        part = sharding.batch_shard(batch, i, 3)
        np.testing.assert_array_equal(part["a"], batch["a"][2 * i:2 * i + 2])
        assert part["b"].tolist() == [2 * i, 2 * i + 1]
    second = sharding.shard_batch(tmesh.Mesh(2, 1, [0, 1], 1), batch)
    assert second["b"].tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="does not split"):
        sharding.batch_shard(batch, 0, 4)


# -- halo exchange ------------------------------------------------------------------


def _port_halos(shards, halo, dim):
    """Every shard's rows with its neighbours' edges, as the row fetch
    assembles them on each rank (its per-shard form)."""
    ranges, a = [], 0
    for s in shards:
        ranges.append((a, a + s.shape[dim]))
        a += s.shape[dim]
    return [sharding.rows_from_shards(shards, ranges, (a - halo, b + halo), dim)
            for a, b in ranges]


@pytest.mark.parametrize("tile", [2, 4])
def test_halo_rows_match_jax(rng, tile):
    H, W, C, halo = 16, 8, 3, 2
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    fn = shard_map(lambda xs: j_halo(xs, halo, "tile"), mesh=_jax_mesh(tile),
                   in_specs=(P(None, "tile", None, None),), out_specs=P(None, "tile", None, None))
    want = np.asarray(fn(jnp.asarray(x)))
    h = H // tile
    got = _port_halos(list(torch.from_numpy(x).split(h, 1)), halo, -3)
    for s in range(tile):
        np.testing.assert_array_equal(got[s].numpy(),
                                      want[:, s * (h + 2 * halo):(s + 1) * (h + 2 * halo)])
    # the depth form: rows on axis -2, zero rows at the image border
    depth = torch.from_numpy(x[..., 0])
    got = _port_halos(list(depth.split(h, 1)), halo, -2)
    padded = torch.nn.functional.pad(depth, (0, 0, halo, halo))
    for s in range(tile):
        assert torch.equal(got[s], padded[:, s * h:s * h + h + 2 * halo])


def test_halo_needs_at_most_the_shard():
    """A halo that reaches past the neighbouring shard is refused, naming
    the stage: the fetch takes rows from neighbours only."""
    plan = tmesh.RowPlan(128, 4)
    a, b = plan.rows(0, 2)
    plan.check("halo", 0, (a - 32, b + 32), 2)
    with pytest.raises(ValueError, match="halo: tile 2 of 4 .* beyond its neighbours"):
        plan.check("halo", 0, (a - 33, b), 2)


# -- tiled ops ----------------------------------------------------------------------


def _depth(rng, B=2, H=32, W=16, focal=20.0):
    depth = (2.0 + 0.2 * rng.standard_normal((B, H, W))).astype(np.float32)
    depth[:, 7:9] = 0.0  # an invalid band across the first boundary at tile 4
    depth[0, 15:17, 3:9] = 11.0  # beyond valid_max, across the tile-2 boundary
    K = np.asarray([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    K_inv = np.broadcast_to(np.asarray(j_invert_intrinsics(jnp.asarray(K))), (B, 3, 3)).copy()
    return depth, K_inv


@pytest.mark.parametrize("tile", [2, 4])
@pytest.mark.parametrize("k_size", [5, 9])
def test_tiled_normals_are_the_untiled_normals(rng, tile, k_size):
    depth, K_inv = _depth(rng)
    H = depth.shape[1]
    h, halo = H // tile, k_size // 2
    d, ki = torch.from_numpy(depth), torch.from_numpy(K_inv)
    shards = _port_halos(list(d.split(h, 1)), halo, -2)
    got = torch.cat([tiled_ops.depth_to_normal_shard(s, ki, i * h, halo, k_size)
                     for i, s in enumerate(shards)], 1)
    untiled, _ = dispatch.depth_to_normal(d, ki, k_size)
    assert torch.equal(got, untiled)
    want = np.asarray(j_dn_tiled(jnp.asarray(depth), jnp.asarray(K_inv), _jax_mesh(tile),
                                 k_size=k_size))
    truth, det = oracle_f64(depth, K_inv, k_size)
    no_worse(got.numpy(), want, truth, det)


def _pairs(rng, B=2, H=16, W=24):
    ref = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    src = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    K = np.asarray([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    E1 = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    E2 = E1.copy()
    E2[:, :3, 3] = [0.1, 0.05, 0.02]
    E2[1, 0, 1], E2[1, 1, 0] = -0.02, 0.02
    Ks = np.broadcast_to(K, (B, 3, 3)).copy()
    return ref, src, (E1, Ks), (E2, Ks)


@pytest.mark.parametrize("tile", [2, 4])
def test_tiled_cost_volume_is_the_untiled_volume(rng, tile):
    ref, src, c1, c2 = _pairs(rng)
    B, H, W, _ = ref.shape
    h, planes = H // tile, 8
    t1, t2 = (Camera(torch.from_numpy(e), torch.from_numpy(k)) for e, k in (c1, c2))
    r, s = torch.from_numpy(ref), torch.from_numpy(src)
    got = torch.cat([tiled_ops.cost_volume_shard(r[:, i * h:(i + 1) * h], s, t1, t2, i * h,
                                                 num_planes=planes) for i in range(tile)], 1)
    untiled = dispatch.cost_volume(r, s, t1, t2, num_planes=planes)
    assert torch.equal(got, untiled)
    j1, j2 = (JCamera(jnp.asarray(e), jnp.asarray(k)) for e, k in (c1, c2))
    KRKiUV, KT = j_terms(j1, j2, H, W)
    want = j_cv_tiled(jnp.asarray(ref), jnp.asarray(src), KRKiUV, KT, j_idepths(3.0, planes),
                      _jax_mesh(tile))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=CV_TOL)


@pytest.mark.parametrize("sampling", ["exact", "torch"])
def test_tiled_ops_on_a_one_rank_mesh_are_the_untiled_ops(rng, sampling):
    """With no process group the tile axis is 1: the entry points run the
    whole image through the same shard code (and ``sampling="torch"``
    scales by the source's size, not a shard's)."""
    mesh = tmesh.make_mesh()
    depth, K_inv = _depth(rng)
    d, ki = torch.from_numpy(depth), torch.from_numpy(K_inv)
    spatial = sharding.Spatial(mesh, *depth.shape[1:])
    assert torch.equal(tiled_ops.depth_to_normal_tiled(d, ki, spatial, 9),
                       dispatch.depth_to_normal(d, ki, 9)[0])
    ref, src, c1, c2 = _pairs(rng, H=32)  # a height the row plan takes
    t1, t2 = (Camera(torch.from_numpy(e), torch.from_numpy(k)) for e, k in (c1, c2))
    r, s = torch.from_numpy(ref), torch.from_numpy(src)
    spatial = sharding.Spatial(mesh, *ref.shape[1:3])
    got = tiled_ops.cost_volume_tiled(r, s, t1, t2, spatial, num_planes=8, sampling=sampling)
    assert torch.equal(got, dispatch.cost_volume(r, s, t1, t2, num_planes=8, sampling=sampling))
    h = ref.shape[1] // 2
    lower = tiled_ops.cost_volume_shard(r[:, h:], s, t1, t2, h, num_planes=8, sampling=sampling)
    assert torch.equal(lower, got[:, h:])


def test_data_sum_without_a_group_is_the_identity():
    x = torch.arange(3.0, requires_grad=True)
    assert collectives.group_sum(x, None) is x
    assert torch.equal(collectives.group_count(x, None), x.detach())
