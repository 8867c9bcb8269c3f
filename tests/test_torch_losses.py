"""The port's losses and plane ops against the JAX package on the CPU.

Every input is drawn from a seeded numpy generator and goes through the
JAX function and the port's counterpart; values and input gradients
(``jax.vjp`` against ``torch.autograd.grad`` with the same cotangent) must
agree to 1e-6 relative (to the largest value of each compared array).
The inputs include empty masks, predictions <= 0, inf and NaN ground
truth, and warped coordinates at and past the image edges. Where a
gradient must stay finite (NaN ground truth, an empty sample), both
packages are also held to that.

``compute_losses`` is compared for every metric key, for both recipes,
with the refiner on and off, at epochs on both sides of the curriculum
gate, in f64 (JAX under a scoped x64): its normal terms pass random depth
maps through the uncentred normal equations, whose f32 solutions differ
between two correct implementations by far more than 1e-6. The f32
metrics are held to 1e-4 relative, the tolerance of the train-step test.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.data.pipeline import collate, normalize_images  # noqa: E402
from cnmnet_tpu.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu.models.cnm import CNMOutputs as JOutputs  # noqa: E402
from cnmnet_tpu.ops import losses as jl  # noqa: E402
from cnmnet_tpu.ops import planes as jp  # noqa: E402
from cnmnet_tpu.train import losses as jtl  # noqa: E402
from cnmnet_tpu_torch.models.cnm import CNMOutputs as TOutputs  # noqa: E402
from cnmnet_tpu_torch.ops import losses as tl  # noqa: E402
from cnmnet_tpu_torch.ops import planes as tp  # noqa: E402
from cnmnet_tpu_torch.train import losses as ttl  # noqa: E402

TOL = 1e-6
B, H, W = 2, 8, 16


def _rel(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    if not ok.any():
        return
    err = np.abs(got[ok] - want[ok]).max() / max(np.abs(want[ok]).max(), 1e-30)
    assert err <= tol, (what, err)


def compare(jfn, tfn, args, diff=(0,), n_out=1, tol=TOL, finite_grads=False, seed=0):
    """Values of the first ``n_out`` outputs, and the gradients of the first
    output with respect to ``args[i]`` for ``i`` in ``diff``."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.array(a)) for a in args]
    for i in diff:
        targs[i].requires_grad_()

    def first(*a):
        out = jfn(*a)
        return out[0] if isinstance(out, tuple) else out

    want_all = jfn(*jargs)
    got_all = tfn(*targs)
    if not isinstance(want_all, tuple):
        want_all, got_all = (want_all,), (got_all,)
    for k in range(n_out):
        _rel(got_all[k].detach().numpy(), want_all[k], tol, f"value {k}")

    want, vjp = jax.vjp(first, *jargs)
    cot = np.random.default_rng(seed).standard_normal(np.shape(want)).astype(np.asarray(want).dtype)
    want_g = vjp(jnp.asarray(cot))
    got = got_all[0]
    got_g = torch.autograd.grad(got, [targs[i] for i in diff], torch.from_numpy(cot))
    for i, g in zip(diff, got_g):
        w = np.asarray(want_g[i])
        if finite_grads:
            assert np.isfinite(w).all() and bool(torch.isfinite(g).all()), f"grad {i}"
        _rel(g.numpy(), w, tol, f"grad {i}")


def _pred_gt(rng, shape=(B, H, W, 1)):
    pred = rng.uniform(0.05, 3.0, shape).astype(np.float32)
    gt = rng.uniform(0.05, 3.0, shape).astype(np.float32)
    pred.flat[:3] = [-0.5, 0.0, np.inf]
    gt.flat[3:7] = [0.0, -1.0, np.inf, np.nan]
    return pred, gt


def test_valid_pair_mask(rng):
    pred, gt = _pred_gt(rng)
    want = np.asarray(jl.valid_pair_mask(jnp.asarray(pred), jnp.asarray(gt)))
    got = tl.valid_pair_mask(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)


@pytest.mark.parametrize("log", [False, True])
def test_masked_l1(rng, log):
    pred, gt = _pred_gt(rng)
    pred[np.isinf(pred)] = 1.0  # an infinite prediction has no finite gradient in either
    compare(lambda p, g: jl.masked_l1(p, g, log), lambda p, g: tl.masked_l1(p, g, log),
            (pred, gt), finite_grads=True)


def test_masked_l1_empty_mask_is_zero():
    z = np.zeros((1, 2, 2, 1), np.float32)
    compare(jl.masked_l1, tl.masked_l1, (z, z), finite_grads=True)
    assert float(tl.masked_l1(torch.from_numpy(z), torch.from_numpy(z))) == 0.0


def test_multiscale_idepth_loss(rng):
    gt = rng.uniform(0.0, 3.0, (B, H, W, 1)).astype(np.float32)
    preds = [rng.uniform(0.0, 3.0, (B, H >> s, W >> s, 1)).astype(np.float32) for s in range(4)]
    compare(lambda *p: jl.multiscale_idepth_loss(list(p[:4]), p[4]),
            lambda *p: tl.multiscale_idepth_loss(list(p[:4]), p[4]),
            (*preds, gt), diff=(1, 2, 3))  # preds[0] is not part of this loss


@pytest.mark.parametrize("log", [False, True])
def test_prob_weighted_l1(rng, log):
    pred, gt = _pred_gt(rng)
    pred[np.isinf(pred)] = 1.0
    prob = rng.uniform(0.0, 1.0, pred.shape).astype(np.float32)
    # The weight's gradient is NaN in both where the GT is inf (the masked
    # product's partial is |pred - inf|); the NaN pattern is compared too.
    compare(lambda p, g, q: jl.prob_weighted_l1(p, g, q, log),
            lambda p, g, q: tl.prob_weighted_l1(p, g, q, log),
            (pred, gt, prob), diff=(0, 2))


def test_prob_supervision_loss(rng):
    pred, gt = _pred_gt(rng)
    pred[np.isinf(pred)] = 1.0
    gt[np.isinf(gt) | np.isnan(gt)] = 0.0  # the disparity target is finite
    prob = rng.uniform(0.0, 1.0, pred.shape).astype(np.float32)
    compare(lambda q, p, g: jl.prob_supervision_loss(q, p, g, 20.0),
            lambda q, p, g: tl.prob_supervision_loss(q, p, g, 20.0),
            (prob, pred, gt), diff=(0, 1), n_out=2, finite_grads=True)


def _normals(rng, n=B):
    v = rng.standard_normal((n, H, W, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.mark.parametrize("weighted", [False, True])
def test_surface_normal_loss(rng, weighted):
    """NaN and inf in the GT normals, a zero GT vector and a zero
    prediction: the loss drops them and every gradient stays finite."""
    pred, gt = _normals(rng), _normals(rng)
    gt[0, 0, :3] = [np.nan, 0.0, 1.0]
    gt[1, 2, 4:6] = [np.inf, -np.inf, 0.0]
    gt[1, 3, 0] = 0.0
    pred[0, 4, 4] = 0.0
    valid = rng.random((B, H, W)) > 0.2
    args = [pred, gt, valid]
    if weighted:
        args.append(rng.uniform(0.0, 1.0, (B, H, W)).astype(np.float32))
    compare(jl.surface_normal_loss, tl.surface_normal_loss, tuple(args), n_out=2,
            finite_grads=True)


def test_surface_normal_loss_empty_sample_is_nan(rng):
    """A sample with no valid pixel: loss and angle are NaN in both, through
    a constant branch, so the gradient is finite (zero)."""
    pred, gt = _normals(rng), _normals(rng)
    valid = np.ones((B, H, W), bool)
    valid[1] = False
    compare(jl.surface_normal_loss, tl.surface_normal_loss, (pred, gt, valid), n_out=2,
            finite_grads=True)
    loss, angle = tl.surface_normal_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                                         torch.from_numpy(valid))
    assert np.isnan(float(loss)) and np.isnan(float(angle))


def _warp_inputs(rng):
    ds = SyntheticScenes(num_samples=B, height=H, width=W, view_num=2, seed=3)
    batch = collate([ds[i] for i in range(B)])
    K = batch["cams"][:, 0, 1, :3, :3].astype(np.float32)
    E_src = batch["cams"][:, 1, 0].astype(np.float32)
    pose = E_src[:, :3].copy()  # the reference extrinsic is the identity
    pose[0, :, 3] += [0.6, 0.1, 0.0]  # warps some points past the source's edges
    depth = (batch["depths"][:, 0] * rng.uniform(0.9, 1.1, (B, H, W))).astype(np.float32)
    depth[0, :2] = 0.0  # invalid reference depth
    depth[1, 3, 3] = 12.0  # beyond max_depth
    gt_src = batch["depths"][:, 1].astype(np.float32)
    return depth, gt_src, pose, K, np.linalg.inv(K).astype(np.float32)


def test_warped_depth_loss(rng):
    args = _warp_inputs(rng)
    compare(jl.warped_depth_loss, tl.warped_depth_loss, args, diff=(0,), finite_grads=True)


def _planes(rng, normals):
    labels = rng.integers(-1, 4, (B, H, W))
    segs = np.stack([(labels == s) for s in range(6)], 1).astype(np.uint8)  # [B, 6, H, W]
    planes_num = np.asarray([4, 2], np.int32)  # slots 2-3 of sample 1 are gated off
    return normals, segs, planes_num


def test_plane_average_normals(rng):
    args = _planes(rng, _normals(rng))
    compare(jp.plane_average_normals, tp.plane_average_normals, args, n_out=3)


@pytest.mark.parametrize("nonfinite", [False, True])
def test_normal_by_planes(rng, nonfinite):
    """With NaN and inf in the GT normals the means of every slot go NaN in
    both (a masked sum still multiplies 0 by NaN), and the NaN pattern
    must agree."""
    normals = _normals(rng)
    if nonfinite:
        normals[0, 1, 1] = [np.nan, 0.0, 0.0]
        normals[1, 5, 7] = [np.inf, 1.0, 0.0]
    compare(jp.normal_by_planes, tp.normal_by_planes, _planes(rng, normals))


def test_plane_consistency_loss(rng):
    compare(jp.plane_consistency_loss, tp.plane_consistency_loss, _planes(rng, _normals(rng)))


# -- compute_losses -----------------------------------------------------------

CH, CW, K_SIZE = 16, 32, 5


@pytest.fixture(scope="module")
def loss_batch():
    ds = SyntheticScenes(num_samples=B, height=CH, width=CW, view_num=3, seed=9)
    batch = collate([ds[i] for i in range(B)])
    batch["images"] = normalize_images(batch["images"])
    batch.pop("index")
    return batch


def _outputs(rng, refiner, S=2):
    """CNMOutputs-shaped arrays: disparities around the scene's (some under
    the 0.01 floor of the depth conversion), probabilities in (0, 1)."""
    disps = [rng.uniform(0.0, 1.0, (B, S, CH >> s, CW >> s, 1)) for s in range(4)]
    disps[0][0, 0, 0, :3, 0] = [0.0, 0.005, 0.01]
    out = {"disps": disps, "iconv": np.zeros((B, S, 1, 1, 1)), "idepth_g1": None,
           "idepth_g2": None, "idepth_refined": None, "prob_map": None}
    if refiner:
        out["idepth_refined"] = rng.uniform(0.05, 1.0, (B, CH, CW, 1))
        out["prob_map"] = rng.uniform(0.0, 1.0, (B, CH, CW, 1))
    return out


def _diff_leaves(out):
    keys = [("disps", i) for i in range(4)]
    if out["idepth_refined"] is not None:
        keys += [("idepth_refined", None), ("prob_map", None)]
    return keys


def _get(out, key):
    name, i = key
    return out[name][i] if i is not None else out[name]


CASES = [(normal, refiner, epoch, False) for normal in (True, False)
         for refiner in (True, False) for epoch in (0, 6)]
CASES.append((True, True, 0, True))  # a sample without a valid depth


@pytest.mark.parametrize("normal,refiner,epoch,empty", CASES)
def test_compute_losses_matches_jax(rng, loss_batch, normal, refiner, epoch, empty):
    """With ``empty``, sample 1 has no valid reference depth: its normal
    terms are NaN in both packages, the NaN guard drops them from the
    loss, and every gradient stays finite in both."""
    if empty:
        loss_batch = dict(loss_batch, depths=loss_batch["depths"].copy())
        loss_batch["depths"][1, 0] = 0.0
    w_j = jtl.LossWeights(use_normal_loss=normal, curriculum_epochs=5, k_size=K_SIZE)
    w_t = ttl.LossWeights(use_normal_loss=normal, curriculum_epochs=5, k_size=K_SIZE)
    assert set(f.name for f in dataclasses.fields(w_j)) <= set(f.name for f in dataclasses.fields(w_t))
    out = _outputs(rng, refiner)
    keys = _diff_leaves(out)

    # f64: every metric and the gradient of the loss with respect to every output
    with jax.enable_x64(True):
        jb = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
              for k, v in loss_batch.items()}

        def jloss(*leaves):
            o = dict(out)
            o["disps"] = list(leaves[:4])
            if refiner:
                o["idepth_refined"], o["prob_map"] = leaves[4], leaves[5]
            return jtl.compute_losses(JOutputs(**o), jb, jnp.asarray(epoch), w_j)

        _, vjp, jm = jax.vjp(jloss, *[jnp.asarray(_get(out, k)) for k in keys], has_aux=True)
        want_g = [np.asarray(g) for g in vjp(jnp.asarray(1.0, jnp.float64))]
        jm = {k: np.asarray(v) for k, v in jm.items()}

    tb = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v)
          for k, v in loss_batch.items()}
    leaves = [torch.from_numpy(_get(out, k)).requires_grad_() for k in keys]
    o = dict(out, iconv=torch.zeros(1))
    o["disps"] = leaves[:4]
    if refiner:
        o["idepth_refined"], o["prob_map"] = leaves[4], leaves[5]
    loss, tm = ttl.compute_losses(TOutputs(**o), tb, epoch, w_t)
    assert set(tm) == set(jm)
    assert ("loss_normal_depth" in tm) == normal and ("prob_map_loss" in tm) == refiner
    for k in jm:
        _rel(tm[k].numpy(), jm[k], TOL, k)
    assert np.isnan(jm.get("loss_normal_depth", 0.0)) == empty and np.isfinite(jm["loss"])
    got_g = torch.autograd.grad(loss, leaves, allow_unused=True)  # the full recipe logs
    for key, g, w in zip(keys, got_g, want_g):  # loss_idepth_234 but leaves it out
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.isfinite(w).all()
        _rel(g, w, TOL, f"grad {key}")

    # f32: the same metrics to the train-step test's tolerance
    jm32 = jtl.compute_losses(
        JOutputs(**{**out, "disps": [jnp.asarray(d, jnp.float32) for d in out["disps"]],
                    **({"idepth_refined": jnp.asarray(out["idepth_refined"], jnp.float32),
                        "prob_map": jnp.asarray(out["prob_map"], jnp.float32)} if refiner else {})}),
        {k: jnp.asarray(v) for k, v in loss_batch.items()}, jnp.asarray(epoch), w_j)[1]
    o32 = {**o, "disps": [torch.from_numpy(d.astype(np.float32)) for d in out["disps"]]}
    if refiner:
        o32["idepth_refined"] = torch.from_numpy(out["idepth_refined"].astype(np.float32))
        o32["prob_map"] = torch.from_numpy(out["prob_map"].astype(np.float32))
    _, tm32 = ttl.compute_losses(TOutputs(**o32), {k: torch.from_numpy(v) for k, v in loss_batch.items()},
                                 epoch, w_t)
    for k in jm32:
        _rel(tm32[k].numpy(), np.asarray(jm32[k]), 1e-4, f"f32 {k}")


def test_curriculum_gate(rng, loss_batch):
    """train_wo_normal: before the gate the loss is the disparity terms
    alone; after it the depth and probability terms join."""
    out = _outputs(rng, True)
    o = {**out, "iconv": torch.zeros(1), "disps": [torch.from_numpy(d) for d in out["disps"]],
         "idepth_refined": torch.from_numpy(out["idepth_refined"]),
         "prob_map": torch.from_numpy(out["prob_map"])}
    tb = {k: torch.from_numpy(v.astype(np.float64) if v.dtype == np.float32 else v)
          for k, v in loss_batch.items()}
    w = ttl.LossWeights(use_normal_loss=False, curriculum_epochs=5, k_size=K_SIZE)
    l4, m4 = ttl.compute_losses(TOutputs(**o), tb, 4, w)
    l5, m5 = ttl.compute_losses(TOutputs(**o), tb, 5, w)
    primary = m4["loss_idepth"] + m4["loss_idepth_234"] + m4["loss_idepth_refined"]
    secondary = m4["loss_depth"] + m4["loss_depth_refined"] + m4["prob_loss"]
    assert float(l4) == pytest.approx(float(primary), rel=1e-12)
    assert float(l5) == pytest.approx(float(primary + secondary), rel=1e-12)
