"""The port's benchmark, its synthetic inputs and the roofline's counts, on
the CPU.

* ``tools/_batch.tiny_batch`` equals ``__graft_entry__._tiny_batch``
  exactly (both build from the same seeded ``SyntheticScenes``).
* ``bench.make_forward`` (idepth, prob, normals) equals the forward that
  the JAX ``bench.py:53-59`` times (jitted, as there) on the same weights: the
  port's seeded weights, with perturbed BatchNorm statistics, carried to a
  flax tree through ``models/transplant.key_map``. Tolerance 7.2e-4, the
  3-view pipeline's A/B figure (ROADMAP), for idepth and prob; the normals
  by the f64-oracle rule of the serving tests (see the test). JAX's
  depth->normal runs through its ``kernels/dispatch`` on the CPU, as the
  JAX tests run it.
* ``bench.main`` on ``cuda`` without a card raises.
* The roofline's convolution FLOPs equal a hand count over the model's
  ``Conv2d`` shapes exactly; the kernel counts and bounds equal the ones
  ``chip_smoke.py`` used before they moved (55 operations a cost, 230 a
  normal at k = 9; 5.16 and 41.32 µs for the cost volume at 2 and 16
  pairs, 0.23 µs for one 192x256 depth map); a reading above 100% raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _tiny_batch  # noqa: E402
from cnmnet_tpu.geometry.camera import invert_intrinsics as j_invert_intrinsics  # noqa: E402
from cnmnet_tpu.kernels import dispatch as j_dispatch  # noqa: E402
from cnmnet_tpu.models import CNMModel as JCNMModel  # noqa: E402
from cnmnet_tpu_torch import bench  # noqa: E402
from cnmnet_tpu_torch.models.cnm import CNMModel  # noqa: E402
from cnmnet_tpu_torch.models.layers import DispHead, init_weights  # noqa: E402
from cnmnet_tpu_torch.models.transplant import key_map  # noqa: E402
from cnmnet_tpu_torch.tools import roofline  # noqa: E402
from cnmnet_tpu_torch.tools._batch import tiny_batch  # noqa: E402
from cnmnet_tpu_torch.train.import_checkpoint import unflatten  # noqa: E402
from cnmnet_tpu_torch.kernels import dispatch as t_dispatch  # noqa: E402
from tests.test_torch_normals import no_worse, oracle_f64  # noqa: E402

H, W, P, K = 32, 64, 8, 5
TOL = 7.2e-4


@pytest.mark.parametrize("batch_size,views", [(1, 3), (2, 5)])
def test_tiny_batch_equals_jax(batch_size, views):
    want = _tiny_batch(batch_size, height=H, width=W, views=views)
    got = tiny_batch(batch_size, H, W, views, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _flax_tree(model):
    """The flax variables of ``model``'s weights (``key_map`` read
    backwards: OIHW kernels to HWIO)."""
    sd = model.state_dict()
    flat = {}
    for fkey, (tkey, _) in key_map(model).items():
        value = sd[tkey].numpy()
        flat[fkey] = np.transpose(value, (2, 3, 1, 0)) if value.ndim == 4 else value
    return unflatten(flat)


@pytest.fixture(scope="module")
def weights():
    """A seeded port model in eval mode with perturbed BatchNorm statistics
    and its disparity heads' kernels scaled by 0.05, as the CPU A/B tests
    scale them (the sigmoids then sit unsaturated and depth in range, so the
    normals are defined), and the same weights as flax variables."""
    model = CNMModel(num_planes=P)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DispHead):
                m[0].weight.mul_(0.05)
    rng = np.random.default_rng(3)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.from_numpy((0.1 * rng.standard_normal(buf.shape)).astype(np.float32)))
        elif name.endswith("running_var"):
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return model.eval(), _flax_tree(model)


def test_bench_forward_matches_jax(weights):
    """idepth and prob within 7.2e-4. The normals: bench's are the port's
    depth->normal of bench's own depth, exactly, and on the JAX forward's
    depth the port's op is no worse than JAX's against the f64 oracle
    (``tests/test_torch_normals.no_worse``, the rule the serving tests use;
    the oracle runs on depth over its median, which turns no normal and puts
    the determinant in the units of that rule's threshold). The two f32 ops
    are not held to 7.2e-4 of each other: on this random net's depth at k =
    5 they differ by up to 1.6e-2 on the same input (measured)."""
    model, variables = weights
    batch = _tiny_batch(1, height=H, width=W)
    jmodel = JCNMModel(num_planes=P)

    @jax.jit
    def forward(images, cams):  # bench.py:53-59
        out = jmodel.apply(variables, images, cams, train=False)
        depth = 1.0 / (out.idepth_refined[..., 0] + 1e-8)
        K_inv = j_invert_intrinsics(cams[:, 0, 1, :3, :3])
        normals, _ = j_dispatch.depth_to_normal(depth, K_inv, K)
        return out.idepth_refined, out.prob_map, normals, depth, K_inv

    *want, depth, K_inv = forward(jnp.asarray(batch["images"]), jnp.asarray(batch["cams"]))
    got = bench.make_forward(model, K)(torch.from_numpy(batch["images"]),
                                       torch.from_numpy(batch["cams"]))
    for name, g, w in zip(("idepth", "prob", "normals"), got, want):
        assert tuple(g.shape) == w.shape, name
    for name, g, w in zip(("idepth", "prob"), got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL, name
    depth, K_inv = np.array(depth), np.array(K_inv)
    assert ((depth > 0) & (depth < 10)).all()  # every normal is defined

    own, _ = t_dispatch.depth_to_normal(1.0 / (got[0][..., 0] + 1e-8), torch.from_numpy(K_inv), K)
    np.testing.assert_array_equal(got[2].numpy(), own.numpy())
    on_jax_depth, _ = t_dispatch.depth_to_normal(torch.from_numpy(depth),
                                                 torch.from_numpy(K_inv), K)
    truth, det = oracle_f64(depth / np.median(depth), K_inv, K)
    no_worse(on_jax_depth.numpy(), np.asarray(want[2]), truth, det)


def test_bench_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(H, W, device="cuda")


def test_roofline_convolution_count_equals_the_hand_count(weights):
    model, _ = weights
    batch = tiny_batch(1, H, W, device="cpu")
    hand = []

    def hook(mod, inp, out):
        n, cout, ho, wo = out.shape
        hand.append(2 * n * cout * ho * wo * mod.weight[0].numel())

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        counted = roofline.count(lambda: bench.make_forward(model, K)(batch["images"],
                                                                      batch["cams"]))
    finally:
        for h in hooks:
            h.remove()
    assert counted["flops_by_op"]["aten.convolution"] == sum(hand)
    assert counted["model_flops"] == sum(counted["flops_by_op"].values())
    assert counted["kernels"] == [] and counted["kernel_flops"] == 0  # plain versions on the CPU
    assert counted["bytes"] > 0


def test_kernel_counts_are_the_smoke_scripts():
    assert roofline.CV_FLOPS == 55
    assert [roofline.normals_flops(k) for k in (5, 9)] == [158, 230]
    pairs, h, w, p = 2, 192, 256, 64
    flops, nbytes = roofline.kernel_cost("cost_volume", (pairs, h, w, p), out_bytes=2)
    assert flops == pairs * p * h * w * 55
    assert nbytes == pairs * h * w * 3 * 4 * 2 + pairs * 12 * 4 + p * 4 + pairs * p * h * w * 2
    assert roofline.kernel_cost("depth_to_normal", (1, h, w, 9)) == (h * w * 230,
                                                                      h * w * 16 + 36)
    ms, by = roofline.bound(nbytes, flops)
    assert (round(ms * 1e3, 2), by) == (5.16, "operations")
    flops, nbytes = roofline.kernel_cost("cost_volume", (16, h, w, p), out_bytes=2)
    assert round(roofline.bound(nbytes, flops)[0] * 1e3, 2) == 41.32
    flops, nbytes = roofline.kernel_cost("depth_to_normal", (1, h, w, 9))
    assert (round(roofline.bound(nbytes, flops)[0] * 1e3, 2),
            roofline.bound(nbytes, flops)[1]) == (0.23, "bytes")


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e6), (1e6, 4e9)])
def test_a_share_above_100_percent_raises(flops, nbytes):
    peak = roofline.PEAK_FLOPS["bfloat16"]
    with pytest.raises(ValueError, match="above 100%"):
        roofline.shares(flops, nbytes, 1e-3, peak)  # 1 ms: 1000 TFLOP/s or 4 TB/s
    tflops, mfu, gbs, hbm = roofline.shares(flops / 10, nbytes / 10, 1e-3, peak)
    assert 0 < mfu <= 100 and 0 < hbm <= 100
    assert mfu == pytest.approx(100 * tflops * 1e12 / peak)
    assert hbm == pytest.approx(100 * gbs * 1e9 / roofline.PEAK_BYTES)
