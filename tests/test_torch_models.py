"""The port's layers and CNMModel against flax, with carried-over weights.

The JAX package's initial weights go through ``load_flax_variables`` into
the port, the BatchNorm statistics perturbed away from 0 and 1 first so
that a swapped mean/var cannot pass. Both run in f32 on the CPU at 32x64
with 8 planes, on the same numpy inputs (``SyntheticScenes`` geometry).

Tolerances: the inverse depths and probabilities agree to 2e-4 absolute
(values up to 3): the same convolutions summed in another order, through
about 30 layers. Single layers agree to 1e-4 relative to their largest
output. Under bf16 compute one block agrees to 2 bf16 ulps (its test says
why).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cnmnet_tpu.data.pipeline import collate, normalize_images  # noqa: E402
from cnmnet_tpu.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu.models import CNMModel as JCNMModel  # noqa: E402
from cnmnet_tpu.models import layers as jl  # noqa: E402
from cnmnet_tpu_torch.models import CNMModel, cast_for_compute, load_flax_variables  # noqa: E402
from cnmnet_tpu_torch.models import layers as tl  # noqa: E402
from cnmnet_tpu_torch.models.layers import init_weights  # noqa: E402
from cnmnet_tpu_torch.models import transplant  # noqa: E402

H, W, P = 32, 64, 8
TOL = 2e-4


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= tol, err


def _perturb_stats(stats, rng):
    """mean ~ N(0, 0.1), var ~ U(0.5, 1.5): a mean/var swap cannot pass."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _perturb_stats(v, rng)
        elif k == "mean":
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map(lambda x: x, dict(tree)))


def _batch(V, B=2):
    ds = SyntheticScenes(num_samples=B, height=H, width=W, view_num=V, seed=7)
    batch = collate([ds[i] for i in range(B)])
    return normalize_images(batch["images"]), batch["cams"].astype(np.float32)


def _flax_variables(jmodel, rng, V_init=3):
    images, cams = _batch(max(V_init, 3))
    variables = jmodel.init(jax.random.PRNGKey(0), images, cams, train=False)
    params = _numpy_tree(variables["params"])
    if "batch_stats" not in variables:
        return {"params": params}
    return {"params": params, "batch_stats": _perturb_stats(_numpy_tree(variables["batch_stats"]), rng)}


class TestLayers:
    @pytest.mark.parametrize("stride", [1, 2])
    @pytest.mark.parametrize("train", [False, True])
    def test_conv_norm_act(self, rng, stride, train):
        x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
        jm = jl.ConvNormAct(16, 3, stride)
        v = jm.init(jax.random.PRNGKey(1), x, train=False)
        stats = _perturb_stats(_numpy_tree(v["batch_stats"]), rng)
        params = _numpy_tree(v["params"])
        params["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
        params["BatchNorm_0"]["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)
        want = jm.apply({"params": params, "batch_stats": stats}, x, train=train,
                        mutable=["batch_stats"] if train else False)
        want = want[0] if train else want

        tm = tl.ConvNormAct(5, 16, 3, stride)
        tm[0].weight.data = torch.from_numpy(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy())
        tm[1].weight.data = torch.from_numpy(params["BatchNorm_0"]["scale"])
        tm[1].bias.data = torch.from_numpy(params["BatchNorm_0"]["bias"])
        tm[1].running_mean.copy_(torch.from_numpy(stats["BatchNorm_0"]["mean"]))
        tm[1].running_var.copy_(torch.from_numpy(stats["BatchNorm_0"]["var"]))
        tm.train(train)
        with torch.no_grad():
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        _rel_close(got, want, 1e-4)

    def test_disp_head(self, rng):
        x = rng.standard_normal((2, 6, 10, 8)).astype(np.float32)
        jm = jl.DispHead(3.0)
        v = _numpy_tree(jm.init(jax.random.PRNGKey(2), x)["params"])
        v["Conv_0"]["bias"] = np.asarray([0.3], np.float32)
        want = jm.apply({"params": v}, x)
        tm = tl.DispHead(8, 3.0)
        tm[0].weight.data = torch.from_numpy(v["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy())
        tm[0].bias.data = torch.from_numpy(v["Conv_0"]["bias"])
        with torch.no_grad():
            got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.dtype == torch.float32
        _rel_close(got, want, 1e-5)

    def test_bf16_conv_norm_act_keeps_f32_statistics(self, rng):
        """Under bf16 compute the port's block equals flax's (f32 params and
        batch_stats, bf16 conv) to 2 bf16 ulps of max(|out|, 1/16): the
        inputs (2 or 3) and weights (0.5 or 1) make the bf16 conv exact on
        both sides, so only the norm's arithmetic is compared. The running
        means sit 0.45 bf16 ulp off the bf16 grid and ~28 standard
        deviations from 0, so statistics rounded to bf16 fall far outside."""
        cin, feats = 4, 32
        x = rng.integers(2, 4, (2, 10, 12, cin)).astype(np.float32)
        jm = jl.ConvNormAct(feats, 3, 1, dtype=jnp.bfloat16)
        params = _numpy_tree(jm.init(jax.random.PRNGKey(1), x, train=False)["params"])
        kernel = rng.choice([0.5, 1.0], (3, 3, cin, feats)).astype(np.float32)
        params["Conv_0"]["kernel"] = kernel
        params["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, feats).astype(np.float32)
        params["BatchNorm_0"]["bias"] = (0.1 * rng.standard_normal(feats)).astype(np.float32)
        w = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
        conv = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, padding=1)
        inner = conv[:, :, 1:-1, 1:-1].double()
        mu, sd = inner.mean((0, 2, 3)).numpy(), inner.std((0, 2, 3)).numpy()
        ulp = 2.0 ** (np.floor(np.log2(mu)) - 7)
        mean = (np.round(mu / ulp) * ulp + 0.45 * ulp).astype(np.float32)
        var = (sd**2).astype(np.float32)
        assert (mu / sd).min() > 20
        stats = {"BatchNorm_0": {"mean": mean, "var": var}}
        want = np.asarray(jm.apply({"params": params, "batch_stats": stats}, x, train=False),
                          np.float32)

        def port(bf16_statistics):
            tm = tl.ConvNormAct(cin, feats, 3, 1)
            tm[0].weight.data = w.clone()
            tm[1].weight.data = torch.from_numpy(params["BatchNorm_0"]["scale"])
            tm[1].bias.data = torch.from_numpy(params["BatchNorm_0"]["bias"])
            tm[1].running_mean.copy_(torch.from_numpy(mean))
            tm[1].running_var.copy_(torch.from_numpy(var))
            if bf16_statistics:  # what the port did before: the whole block in bf16
                tm.to(torch.bfloat16)
            else:
                cast_for_compute(tm, torch.bfloat16)
            with torch.no_grad():
                out = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
            assert out.dtype == torch.bfloat16
            return out.permute(0, 2, 3, 1).float().numpy()

        ulps = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-4))) - 7)
        assert (np.abs(port(False) - want) / ulps).max() <= 2
        assert (np.abs(port(True) - want) / ulps).max() > 20

    def test_upsampling(self, rng):
        x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        _rel_close(tl.upsample2x_bilinear(t).permute(0, 2, 3, 1),
                   jl.upsample2x_bilinear(jnp.asarray(x)), 1e-6)
        np.testing.assert_array_equal(tl.upsample2x_nearest(t).permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jl.upsample2x_nearest(jnp.asarray(x))))


CASES = {
    "3view": dict(V=3),
    "5view": dict(V=5),
    "7view": dict(V=7),
    "2view": dict(V=2),
    "no_refiner": dict(V=3, use_refiner=False),
    "group_norm": dict(V=3, norm="group"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cnm_model_matches_flax(rng, case):
    kw = dict(CASES[case])
    V = kw.pop("V")
    jmodel = JCNMModel(num_planes=P, **kw)
    variables = _flax_variables(jmodel, rng)
    images, cams = _batch(V)
    want = jmodel.apply(variables, images, cams, train=False)

    model = CNMModel(num_planes=P, **kw)
    load_flax_variables(model, variables)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(cams))

    S = V - 1
    assert len(got.disps) == 4
    for g, w in zip(got.disps, want.disps):
        assert tuple(g.shape) == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() < TOL
    assert tuple(got.iconv.shape) == (2, S, H, W, 64)
    _rel_close(got.iconv, want.iconv, 1e-4)
    refined = S > 1 and kw.get("use_refiner", True)
    for name in ("idepth_g1", "idepth_g2", "idepth_refined", "prob_map"):
        g, w = getattr(got, name), getattr(want, name)
        if not refined:
            assert g is None and w is None
            continue
        assert tuple(g.shape) == w.shape == (2, H, W, 1)
        assert np.abs(g.numpy() - np.asarray(w)).max() < TOL, name


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_cast_for_compute_keeps_norms_f32(norm):
    """Every conv weight and bias becomes bf16; every norm layer's weight,
    bias and running statistics stay f32 with their values untouched."""
    model = CNMModel(num_planes=P, norm=norm)
    init_weights(model, torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(3.0, 0.1)
            m.running_var.uniform_(0.5, 1.5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert cast_for_compute(model, torch.bfloat16) is model
    norms = convs = 0
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm)):
            norms += 1
            tensors = list(m.parameters(recurse=False)) + list(m.buffers(recurse=False))
            assert all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())
        elif isinstance(m, torch.nn.Conv2d):
            convs += 1
            assert all(t.dtype == torch.bfloat16 for t in m.parameters())
    assert norms > 20 and convs > 20
    for k, v in model.state_dict().items():
        if v.dtype == torch.float32 or not v.is_floating_point():
            assert torch.equal(v, before[k]), k
    images, cams = _batch(3, B=1)
    with torch.no_grad():  # the bf16 forward runs with f32 norm layers
        out = model.eval()(torch.from_numpy(images), torch.from_numpy(cams))
    assert out.iconv.dtype == torch.bfloat16 and out.idepth_refined.dtype == torch.float32
    assert bool(torch.isfinite(out.idepth_refined).all())


def _default_flax_shapes():
    """Leaf shapes of a default CNMModel tree (64 planes), without computing."""
    images, cams = _batch(3, B=1)
    shapes = jax.eval_shape(
        lambda: JCNMModel().init(jax.random.PRNGKey(0), images, cams, train=False)
    )
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}/{k}"
            if hasattr(v, "items"):
                walk(v, path)
            else:
                flat[path] = tuple(v.shape)

    for col in ("params", "batch_stats"):
        walk(shapes[col], col)
    return flat


def test_transplant_covers_default_tree():
    """Every flax leaf maps to exactly one port tensor of the right shape,
    and every port parameter and buffer is filled, except the BatchNorm
    ``num_batches_tracked`` counters (flax keeps no such counter)."""
    flax_shapes = _default_flax_shapes()
    model = CNMModel()
    mapping = transplant.key_map(model)
    assert set(mapping) == set(flax_shapes)
    port_keys = [tkey for tkey, _ in mapping.values()]
    assert len(port_keys) == len(set(port_keys))
    sd = model.state_dict()
    unfilled = set(sd) - set(port_keys)
    assert unfilled and all(k.endswith("num_batches_tracked") for k in unfilled)
    for fkey, (tkey, transform) in mapping.items():
        assert transform(np.zeros(flax_shapes[fkey])).shape == tuple(sd[tkey].shape), fkey


def test_transplant_refuses_mismatched_trees(rng):
    jmodel = JCNMModel(num_planes=P)
    variables = _flax_variables(jmodel, rng)
    model = CNMModel(num_planes=P)

    missing = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    missing["params"]["depth_net"] = dict(missing["params"]["depth_net"])
    del missing["params"]["depth_net"]["DispHead_0"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(model, missing)

    extra = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    extra["params"]["stray"] = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_flax_variables(model, extra)

    with pytest.raises(KeyError, match="unused"):  # a refiner tree into a DepthNet-only model
        load_flax_variables(CNMModel(num_planes=P, use_refiner=False), variables)
