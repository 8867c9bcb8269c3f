"""One port train step against ``cnmnet_tpu.train.loop.make_train_step``.

Size of the JAX package's own train tests (``tests/test_train.py``): 32x64,
8 planes, k = 5, batch 2, 3 views, f32 on the CPU. The JAX state's weights
go into the port through ``load_flax_variables``; the disparity heads'
kernels are scaled by 0.05 in both, so that their sigmoids start
unsaturated (at He-normal scale many pre-activations pass 15, where the
f32 ``1 - sigmoid`` that the head's gradient takes is a few ulps, and a
one-ulp difference in the input changes that gradient by half).

What the step is held to, with the worst case measured on this host:

* every loss metric of the step within 1e-4 relative of JAX's (measured
  4.6e-5, the normal terms; 1e-6 elsewhere), ``grad_norm`` within 1e-3
  (9.8e-5);
* every BatchNorm running variance after the step within 1e-5 relative
  (per element), every running mean within 1e-5 of its channel's running
  standard deviation;
* the gradient of the same loss, per tensor relative to the tensor's
  largest element, within 1e-3 (measured 9.0e-4) with BatchNorm on its
  running statistics. In train mode the gradient of this randomly
  initialised net at this size is not a well-posed comparison: its own f32
  and f64 gradients differ by 1.8e-2 in relative L2 (6e-7 with running
  statistics), and a 1e-7 relative change of the weights moves its f64
  gradient by 1.3e-2. So the train-mode BatchNorm's backward is compared
  at the layer (``test_train_mode_conv_norm_act_gradients``, 1e-4), and
  the whole train-mode gradient through ``grad_norm``.

The model options: the port's ``build_model`` refuses exactly the configs
the JAX one refuses (``remat_stages`` outside -1 and 1-5 with remat on,
an unknown ``stride2``) and builds ``s2d``/``psg`` as the strided conv. A
bf16 step is held to the JAX bf16 step (one more JAX train-step compile),
the bf16 gradient with running statistics to JAX's, and a bf16
ConvNormAct to flax's in train mode (tolerances, and the f32 readings
each one refuses, in their docstrings); a remat step to the plain step,
bit for bit.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from cnmnet_tpu.config import Config as JConfig  # noqa: E402
from cnmnet_tpu.data.pipeline import collate, normalize_images  # noqa: E402
from cnmnet_tpu.data.synthetic import SyntheticScenes  # noqa: E402
from cnmnet_tpu.models import layers as jlayers  # noqa: E402
from cnmnet_tpu.ops.images import prepare_images as jprepare  # noqa: E402
from cnmnet_tpu.train import loop as jloop  # noqa: E402
from cnmnet_tpu.train import state as jstate  # noqa: E402
from cnmnet_tpu.train.losses import compute_losses as jcompute_losses  # noqa: E402
from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.models import layers as tlayers  # noqa: E402
from cnmnet_tpu_torch.models.transplant import flatten, key_map  # noqa: E402
from cnmnet_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from cnmnet_tpu_torch.train import state as tstate  # noqa: E402
from cnmnet_tpu_torch.train.loop import batch_to_device, loss_and_grads  # noqa: E402
from cnmnet_tpu_torch.train.loop import loss_weights_from_config  # noqa: E402

H, W = 32, 64


def _tiny(cls):
    cfg = cls()
    cfg.model.num_planes = 8
    cfg.model.k_size = 5
    cfg.dataset.batch_size = 2
    return cfg


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), dict(tree))


@pytest.fixture(scope="module")
def ref():
    """The JAX side, built once: weights, the step's metrics and new
    state, and the gradients of the same loss with running statistics."""
    jcfg = _tiny(JConfig)
    ds = SyntheticScenes(num_samples=2, height=H, width=W, view_num=3)
    batch = collate([ds[0], ds[1]])
    batch["images"] = normalize_images(batch["images"])
    batch.pop("index")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = jstate.build_model(jcfg)
    variables = jax.jit(lambda r: model.init(r, jprepare(jb["images"]), jb["cams"],
                                             train=False))(jax.random.PRNGKey(0))
    params, stats = _np_tree(variables["params"]), _np_tree(variables["batch_stats"])
    for path, leaf in flatten({"params": params}).items():
        if "DispHead" in path and path.endswith("kernel"):
            node = params
            for part in path.split("/")[1:-1]:
                node = node[part]
            node["kernel"] = (leaf * np.float32(0.05)).astype(np.float32)
    state = jstate.CNMTrainState.create(
        apply_fn=model.apply, params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        epoch=jnp.zeros((), jnp.int32), tx=jstate.make_optimizer(jcfg))
    new_state, metrics = jloop.make_train_step(jcfg)(state, jb)
    metrics = {k: float(v) for k, v in metrics.items() if k != "viz"}
    new_stats = _np_tree(new_state.batch_stats)

    variables = {"params": params, "batch_stats": stats}
    return {"batch": batch, "variables": variables, "metrics": metrics, "new_stats": new_stats,
            "grads": _jax_eval_grads(jcfg, variables, jb)}


def _jax_eval_grads(jcfg, variables, jb):
    """The gradient of the full CNM loss with BatchNorm on its running
    statistics, for the JAX model that ``jcfg`` builds."""
    model = jstate.build_model(jcfg)
    w = jloop.loss_weights_from_config(jcfg)

    def eval_loss(p):
        out = model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                          jprepare(jb["images"]), jb["cams"], train=False)
        return jcompute_losses(out, jb, jnp.asarray(0), w)[0]

    grads = jax.jit(jax.grad(eval_loss))(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    return _np_tree(grads)


def _port_state(ref):
    return create_train_state(_tiny(Config), 0, "cpu", flax_variables=ref["variables"])


@pytest.fixture(scope="module")
def port_step(ref):
    state, metrics = make_train_step(_tiny(Config))(_port_state(ref), ref["batch"])
    return state, {k: float(v) for k, v in metrics.items() if k != "viz"}


def test_one_step_metrics_match_jax(ref, port_step):
    _, got = port_step
    want = ref["metrics"]
    assert set(got) == set(want)
    for k, v in want.items():
        tol = 1e-3 if k == "grad_norm" else 1e-4
        assert abs(got[k] - v) <= tol * abs(v), (k, got[k], v)


def test_optimizer_state_holds_no_autograd_graph(port_step):
    """The weight decay reads the parameters; the moments it feeds must not
    carry their graph (and the saved gradients) from one step to the next."""
    state, _ = port_step
    moments = [t for m in ("mu", "nu") for t in state.opt_state[m].values()]
    assert _tiny(Config).solver.weight_decay and moments
    assert not any(t.requires_grad or t.grad_fn is not None for t in moments)
    assert not any(p.grad_fn is not None for p in state.model.parameters())


def test_one_step_batch_norm_statistics_match_jax(ref, port_step):
    state, _ = port_step
    sd = state.model.state_dict()
    want = flatten({"batch_stats": ref["new_stats"]})
    n = 0
    for fkey, (tkey, transform) in key_map(state.model).items():
        if not tkey.endswith("running_var"):
            continue
        var, want_var = sd[tkey].numpy(), transform(want[fkey])
        assert np.abs(var / want_var - 1).max() <= 1e-5, tkey
        mkey = tkey.replace("running_var", "running_mean")
        want_mean = transform(want[fkey.replace("/var", "/mean")])
        assert (np.abs(sd[mkey].numpy() - want_mean) <= 1e-5 * np.sqrt(want_var)).all(), mkey
        n += 1
    assert n == sum(isinstance(m, torch.nn.BatchNorm2d) for m in state.model.modules())


def _port_eval_grads(cfg, ref):
    """The port's counterpart of ``_jax_eval_grads``: (model, {name: grad})."""
    model = create_train_state(cfg, 0, "cpu", flax_variables=ref["variables"]).model.eval()
    b = batch_to_device(ref["batch"], "cpu")
    g, _, _ = loss_and_grads(model, b, 0, loss_weights_from_config(cfg))
    return model, dict(zip([n for n, _ in model.named_parameters()], g))


def test_gradients_match_jax(ref):
    """The full CNM loss's gradient for every parameter, per tensor
    relative to its largest element (BatchNorm on running statistics; see
    the module docstring)."""
    model, grads = _port_eval_grads(_tiny(Config), ref)
    want = flatten({"params": ref["grads"]})
    worst = 0.0
    for fkey, (tkey, transform) in key_map(model).items():
        if fkey.startswith("params/"):
            w = transform(want[fkey])
            worst = max(worst, float(np.abs(grads[tkey].numpy() - w).max() / np.abs(w).max()))
    assert worst <= 1e-3, worst


@pytest.mark.parametrize("stride", [1, 2])
def test_train_mode_conv_norm_act_gradients(rng, stride):
    """Train-mode ConvNormAct (batch statistics) against flax: output and
    the gradients of the input, kernel, scale and bias, within 1e-4 of
    each one's largest element."""
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    cot = rng.standard_normal((2, 8 // stride, 12 // stride, 16)).astype(np.float32)
    jm = jlayers.ConvNormAct(16, 3, stride)
    v = _np_tree(jm.init(jax.random.PRNGKey(1), x, train=False))
    v["params"]["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    v["params"]["BatchNorm_0"]["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)

    def f(p, xx):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, train=True,
                        mutable=["batch_stats"])[0]

    want, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, v["params"]), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    tm = tlayers.ConvNormAct(5, 16, 3, stride).train()
    conv, bn = tm[0], tm[1]
    conv.weight.data = torch.from_numpy(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy())
    bn.weight.data = torch.from_numpy(v["params"]["BatchNorm_0"]["scale"])
    bn.bias.data = torch.from_numpy(v["params"]["BatchNorm_0"]["bias"])
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm(tx)
    grads = torch.autograd.grad(got, (tx, conv.weight, bn.weight, bn.bias),
                                torch.from_numpy(cot).permute(0, 3, 1, 2))
    pairs = [
        (got.detach().permute(0, 2, 3, 1), want),
        (grads[0].permute(0, 2, 3, 1), gx),
        (grads[1].permute(2, 3, 1, 0), gp["Conv_0"]["kernel"]),
        (grads[2], gp["BatchNorm_0"]["scale"]),
        (grads[3], gp["BatchNorm_0"]["bias"]),
    ]
    for g, w in pairs:
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_batch_norm_running_variance_is_flax_biased_variance(rng):
    """One train-mode forward of a [2, 4, 3, 5] input (30 values a channel):
    ``nn.BatchNorm2d`` moves its running variance by the unbiased batch
    variance, 30/29 of flax's; the port's ``BatchNorm2d`` matches flax's
    running mean and variance to 1e-6 and normalises as
    ``nn.BatchNorm2d`` does."""
    import flax.linen as fnn

    x = (1.5 + 2.0 * rng.standard_normal((2, 4, 3, 5))).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    v = jbn.init(jax.random.PRNGKey(0), xj)
    _, mutated = jbn.apply(v, xj, mutable=["batch_stats"])
    want_mean = np.asarray(mutated["batch_stats"]["mean"])
    want_var = np.asarray(mutated["batch_stats"]["var"])

    stock = torch.nn.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    port = tlayers.BatchNorm2d(4, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        out_stock = stock(torch.from_numpy(x))
        out_port = port(torch.from_numpy(x))
    np.testing.assert_allclose(out_port.numpy(), out_stock.numpy(), rtol=0, atol=1e-6)
    fault = np.abs(stock.running_var.numpy() - want_var) / want_var
    batch_var = (want_var - 0.9) / 0.1
    np.testing.assert_allclose(stock.running_var.numpy(), 0.9 + 0.1 * batch_var * 30 / 29,
                               rtol=1e-5)
    assert fault.max() > 1e-3
    np.testing.assert_allclose(port.running_var.numpy(), want_var, rtol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(), want_mean, rtol=1e-6, atol=1e-7)
    assert int(port.num_batches_tracked) == 1


# -- the optimizer against optax on identical gradients --------------------------

SOLVERS = {
    "adam": {},
    "adam_no_decay": {"weight_decay": 0.0},
    "adam_clip_warmup": {"grad_clip_norm": 1.0, "warmup_steps": 3},
    "sgd": {"method": "sgd", "lr": 1e-2},
    "rmsprop": {"method": "rmsprop"},
    "adadelta": {"method": "adadelta", "lr": 1.0},
}


@pytest.mark.parametrize("case", list(SOLVERS))
def test_optimizer_matches_optax(rng, case):
    """Four steps of the same gradient trees, with a tensor whose gradient
    is zero at every step (no decay; its moments decay) and one whose
    gradient is missing on the port's side (a zero on optax's): updates and
    parameters within 1e-6 of each array's largest value; the step count
    and every moment too."""
    jcfg, cfg = JConfig(), Config()
    for k, v in SOLVERS[case].items():
        setattr(jcfg.solver, k, v)
        setattr(cfg.solver, k, v)
    shapes = {"a": (3, 4), "b": (5,), "frozen": (2, 3), "unused": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tx = jstate.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = tx.init(jp)
    opt = tstate.make_optimizer(cfg)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init(tp)
    for step in range(4):
        g = {k: (3.0 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
        g["frozen"] = np.zeros(shapes["frozen"], np.float32)
        g["unused"] = np.zeros(shapes["unused"], np.float32)
        ju, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, ju)
        tg = {k: torch.from_numpy(v) for k, v in g.items() if k != "unused"}
        tu, st = opt.update(tg, st, tp)
        opt.apply(tp, tu)
        for k in shapes:
            for got, want in ((tu[k], ju[k]), (tp[k], jp[k])):
                want = np.asarray(want)
                scale = max(np.abs(want).max(), 1e-30)
                assert np.abs(got.numpy() - want).max() <= 1e-6 * scale, (case, step, k)
        assert st["count"] == step + 1
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])
    for m in tstate.MOMENTS[opt.method]:
        want = _optax_moment(jst, m)
        for k in shapes:
            scale = max(np.abs(want[k]).max(), 1e-30)
            assert np.abs(st[m][k].numpy() - want[k]).max() <= 1e-6 * scale, (case, m, k)


def _optax_moment(opt_state, name):
    """``{param: array}`` of the one optax state in the chain with field ``name``."""
    (found,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, name))
                if hasattr(s, name)]
    return {k: np.asarray(v) for k, v in getattr(found, name).items()}


def test_active_decay_masks_zero_gradient_tensors():
    """As ``tests/test_train.py::TestActiveDecay``: the decay reaches a
    tensor with a nonzero gradient element and leaves an all-zero one."""
    params = [torch.ones(3), torch.full((3,), 2.0)]
    grads = [torch.tensor([0.5, 0.0, -0.5]), torch.zeros(3)]
    a, b = tstate.add_decayed_weights_active(grads, params, 0.1)
    np.testing.assert_allclose(a.numpy(), [0.6, 0.1, -0.4], atol=1e-7)
    np.testing.assert_array_equal(b.numpy(), np.zeros(3))


def test_unknown_solver_method_raises():
    cfg = Config()
    cfg.solver.method = "lamb"
    with pytest.raises(ValueError, match="lamb"):
        tstate.make_optimizer(cfg)


# -- model options, bf16 and remat ---------------------------------------------------

_REFUSED = [("remat_stages", 0), ("remat_stages", 6), ("remat_stages", 7),
            ("remat_stages", -2), ("stride2", "foo")]


@pytest.mark.parametrize("key,value", _REFUSED)
def test_port_refuses_what_jax_refuses(key, value):
    """``model.remat=true`` with ``remat_stages`` outside -1 and 1-5 raises
    ``ValueError`` in both packages' ``build_model``; an unknown
    ``model.stride2`` raises ``KeyError`` (JAX: when its layers build the
    first stride-2 conv, traced here by ``jax.eval_shape``)."""
    jcfg, cfg = _tiny(JConfig), _tiny(Config)
    for c in (jcfg, cfg):
        c.model.remat = key == "remat_stages"
        setattr(c.model, key, value)
    error = KeyError if key == "stride2" else ValueError
    images = jnp.zeros((1, 3, H, W, 3), jnp.float32)
    cams = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (1, 3, 2, 4, 4))
    with pytest.raises(error):
        model = jstate.build_model(jcfg)
        jax.eval_shape(lambda r: model.init(r, images, cams, train=False), jax.random.PRNGKey(0))
    with pytest.raises(error, match=str(value)):
        tstate.build_model(cfg)


@pytest.mark.parametrize("stride2", ["s2d", "psg"])
def test_port_builds_the_tpu_stride2_lowerings_as_the_strided_conv(ref, stride2):
    """``s2d`` and ``psg`` have the strided conv's parameters and outputs
    (RESULTS.md): the port builds that conv, the same ``state_dict``."""
    cfg = _tiny(Config)
    cfg.model.stride2 = stride2
    model = create_train_state(cfg, 0, "cpu", flax_variables=ref["variables"]).model
    base = _port_state(ref).model
    assert model.state_dict().keys() == base.state_dict().keys()
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 base.state_dict().values()))


def _bf16(cls):
    cfg = _tiny(cls)
    cfg.model.compute_dtype = "bfloat16"
    return cfg


@pytest.fixture(scope="module")
def bf16_ref(ref):
    """The JAX bf16 step (the one more train-step compile of this file) from
    the carried-over weights."""
    jcfg = _bf16(JConfig)
    jb = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    model = jstate.build_model(jcfg)
    state = jstate.CNMTrainState.create(
        apply_fn=model.apply,
        params=jax.tree_util.tree_map(jnp.asarray, ref["variables"]["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, ref["variables"]["batch_stats"]),
        epoch=jnp.zeros((), jnp.int32), tx=jstate.make_optimizer(jcfg))
    new_state, metrics = jloop.make_train_step(jcfg)(state, jb)
    return ({k: float(v) for k, v in metrics.items() if k != "viz"},
            _np_tree(new_state.params), _np_tree(new_state.batch_stats))


BF16_RTOL = 2e-2
BF16_NORMALS_RTOL = 5e-2
BF16_GRAD_NORM_RTOL = 0.1
BF16_GRAD_RTOL = 0.06
BF16_LAYER_RTOL = 1e-2


def test_bf16_step_matches_jax_bf16_step(ref, bf16_ref):
    """One bf16 step against the JAX bf16 step from the same f32 weights.
    The two frameworks round to bf16 at other places (XLA's upsampling is
    two rounded passes, PyTorch's one), so the loss terms agree within
    bf16 resolution, rtol 2e-2 (measured 4.7e-3), except the three normal
    terms, whose uncentred f32 solve amplifies the rounding of the depth
    it is given (``tests/test_torch_normals.py``): rtol 5e-2 (measured
    1.7e-2). ``grad_norm`` agrees within 0.1 relative (measured 7.5e-2;
    conv weights that take no gradient through their bf16 cast give 0.97).
    The BatchNorm running statistics agree within 2e-2 (each variance
    relative, each mean of its running standard deviation), and the
    updated parameters within 2e-2 relative plus 2 lr: Adam's first update
    is ``lr g / |g|``, so a gradient element near 0 may take the other
    sign. Parameters, moments and statistics stay f32, and the convs
    compute in bf16.

    The train-mode gradient itself (and Adam's first moment after the
    step, ``(1 - b1) g``) is not compared here: at this size it is chaotic
    (module docstring), and JAX's own bf16 and f32 steps give first
    moments 0.95 apart in relative L2 (the port's bf16 step is 1.11 from
    JAX's, its f32 step 0.95). The bf16 gradient is held to JAX's where it
    is well-posed, with BatchNorm on running statistics
    (``test_bf16_gradients_match_jax``), and at the layer in train mode
    (``test_bf16_conv_norm_act_matches_flax``)."""
    want, want_params, want_stats = bf16_ref
    state = create_train_state(_bf16(Config), 0, "cpu", flax_variables=ref["variables"])
    conv = state.model.depth_net.conv1[0]
    assert conv(torch.zeros(1, conv.in_channels, 8, 8)).dtype == torch.bfloat16
    state, got = make_train_step(_bf16(Config))(state, ref["batch"])
    got = {k: float(v) for k, v in got.items() if k != "viz"}
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "grad_norm":
            tol = BF16_GRAD_NORM_RTOL
        else:
            tol = BF16_NORMALS_RTOL if "normal" in k else BF16_RTOL
        assert abs(got[k] - v) <= tol * abs(v), (k, got[k], v)
    sd = state.model.state_dict()
    floats = [t for t in list(sd.values()) + list(state.opt_state["mu"].values())
              + list(state.opt_state["nu"].values()) if t.is_floating_point()]
    assert all(t.dtype == torch.float32 for t in floats)
    want_flat = flatten({"params": want_params, "batch_stats": want_stats})
    lr = _tiny(Config).solver.lr
    for fkey, (tkey, transform) in key_map(state.model).items():
        w = transform(want_flat[fkey])
        if fkey.startswith("params/"):
            np.testing.assert_allclose(sd[tkey].numpy(), w, rtol=BF16_RTOL, atol=2 * lr,
                                       err_msg=tkey)
        elif tkey.endswith("running_var"):
            np.testing.assert_allclose(sd[tkey].numpy(), w, rtol=BF16_RTOL, err_msg=tkey)
        else:
            var = transform(want_flat[fkey.replace("/mean", "/var")])
            assert (np.abs(sd[tkey].numpy() - w) <= BF16_RTOL * np.sqrt(var)).all(), tkey


def test_bf16_gradients_match_jax(ref):
    """The bf16 model's gradient of the full CNM loss (BatchNorm on running
    statistics, as ``test_gradients_match_jax``) against the JAX bf16
    model's, in relative L2 over every parameter: within 0.06 (measured
    0.054). The limit sits below the port's f32 gradient, which is 0.065
    from JAX's bf16 one and so fails it, and far below conv weights that
    take no gradient through their bf16 cast (1.0). The two frameworks
    round the upsampling differently (two bf16 passes in XLA, one in
    PyTorch): rounding it as XLA does would bring the port to 0.039."""
    jb = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    want = flatten({"params": _jax_eval_grads(_bf16(JConfig), ref["variables"], jb)})
    model, grads = _port_eval_grads(_bf16(Config), ref)
    num = den = 0.0
    for fkey, (tkey, transform) in key_map(model).items():
        if fkey.startswith("params/"):
            w = transform(want[fkey]).astype(np.float64)
            assert grads[tkey].dtype == torch.float32, tkey
            num += float(((grads[tkey].numpy().astype(np.float64) - w) ** 2).sum())
            den += float((w ** 2).sum())
    assert np.sqrt(num / den) <= BF16_GRAD_RTOL, np.sqrt(num / den)


@pytest.mark.parametrize("stride", [1, 2])
def test_bf16_conv_norm_act_matches_flax(rng, stride):
    """A train-mode ConvNormAct computing in bf16 (``set_compute_dtype``)
    against flax's with ``dtype=bfloat16``: a bf16 output equal to flax's
    (measured 0), and the f32 gradients of the input, kernel, scale and
    bias within 1e-2 of each one's largest element (measured 6.4e-3). The
    same layer in f32 misses the input, kernel and bias gradients by
    5.9e-2 to 1.6e-1."""
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    cot = rng.standard_normal((2, 8 // stride, 12 // stride, 16)).astype(np.float32)
    jm = jlayers.ConvNormAct(16, 3, stride, dtype=jnp.bfloat16)
    v = _np_tree(jm.init(jax.random.PRNGKey(1), x, train=False))
    v["params"]["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    v["params"]["BatchNorm_0"]["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)

    def f(p, xx):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]}, xx, train=True,
                        mutable=["batch_stats"])[0]

    want, vjp = jax.vjp(f, jax.tree_util.tree_map(jnp.asarray, v["params"]), jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot, jnp.bfloat16))
    tm = tlayers.set_compute_dtype(tlayers.ConvNormAct(5, 16, 3, stride).train(), torch.bfloat16)
    conv, bn = tm[0], tm[1]
    conv.weight.data = torch.from_numpy(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy())
    bn.weight.data = torch.from_numpy(v["params"]["BatchNorm_0"]["scale"])
    bn.bias.data = torch.from_numpy(v["params"]["BatchNorm_0"]["bias"])
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm(tx)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    grads = torch.autograd.grad(got, (tx, conv.weight, bn.weight, bn.bias),
                                torch.from_numpy(cot).permute(0, 3, 1, 2).to(torch.bfloat16))
    np.testing.assert_array_equal(got.detach().float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want, np.float32))
    pairs = [
        (grads[0].permute(0, 2, 3, 1), gx),
        (grads[1].permute(2, 3, 1, 0), gp["Conv_0"]["kernel"]),
        (grads[2], gp["BatchNorm_0"]["scale"]),
        (grads[3], gp["BatchNorm_0"]["bias"]),
    ]
    for g, w in pairs:
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32
        assert np.abs(g.numpy() - w).max() <= BF16_LAYER_RTOL * np.abs(w).max()


@contextlib.contextmanager
def _recorded_grads():
    """The gradients each optimizer update is handed, in call order."""
    seen = []
    update = tstate.Optimizer.update

    def recording(self, grads, state, params):
        seen.append({k: v.clone() for k, v in grads.items()})
        return update(self, grads, state, params)

    tstate.Optimizer.update = recording
    try:
        yield seen
    finally:
        tstate.Optimizer.update = update


def _remat_step(ref, remat_stages=None, remat_refiner=False):
    """One step with ``model.remat`` set when ``remat_stages`` is given:
    the ``state_dict`` keys before it, the ``state_dict``, metrics and
    gradients after it."""
    cfg = _tiny(Config)
    cfg.model.remat = remat_stages is not None
    cfg.model.remat_stages = -1 if remat_stages is None else remat_stages
    cfg.model.remat_refiner = remat_refiner
    state = create_train_state(cfg, 0, "cpu", flax_variables=ref["variables"])
    keys = list(state.model.state_dict())
    with _recorded_grads() as seen:
        state, metrics = make_train_step(cfg)(state, ref["batch"])
    return keys, state.model.state_dict(), metrics, seen[0]


@pytest.fixture(scope="module")
def plain_step(ref):
    return _remat_step(ref)


@pytest.mark.parametrize("stages,refiner", [(-1, False), (1, False), (2, False), (3, False),
                                            (4, False), (5, False), (None, True), (2, True)])
def test_remat_step_equals_the_plain_step(ref, plain_step, stages, refiner):
    """Recomputing encoder stages (and the RefineNet) in the backward
    changes nothing on the CPU: the same gradients, loss terms, parameters
    and running statistics, bit for bit; ``num_batches_tracked`` moves by
    one (the recompute's statistics are thrown away); the ``state_dict``
    keys, and so the flax transplant, are the same."""
    keys0, sd0, metrics0, grads0 = plain_step
    keys, sd, metrics, grads = _remat_step(ref, stages, refiner)
    assert keys == keys0
    assert all(torch.equal(grads[k], grads0[k]) for k in grads0)
    assert all(torch.equal(metrics[k], metrics0[k]) for k in metrics0 if k != "viz")
    assert all(torch.equal(sd[k], sd0[k]) for k in sd0)
    tracked = [v for k, v in sd.items() if k.endswith("num_batches_tracked")]
    assert tracked and all(int(t) == 1 for t in tracked)
