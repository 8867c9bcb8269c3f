"""Trained weights into the port: a JAX (orbax) checkpoint through
``tools/orbax_to_npz.py`` and ``cnmnet_tpu_torch.train.import_checkpoint
--npz``, and the reference's state dict through ``--torch-ckpt``.

Size of ``tests/test_torch_train.py``: 32x64, 8 planes, k = 5, batch 2,
f32 on the CPU, the disparity heads' kernels scaled by 0.05 (see there).
One JAX train step is compiled and run twice: the step that the saved
checkpoint holds, and the step resumed from it.

* The converted file holds the JAX state exactly (weights, statistics,
  Adam's moments, counters), from a manager root, a step directory or a
  step of a root; the imported port checkpoint holds them exactly too.
* The port session on the imported checkpoint against the JAX session on
  the orbax one: idepth and prob within the full 3-view pipeline's 7.2e-4
  (ROADMAP tolerances), depth within 7.2e-4 relative; the normals by
  ``tests/test_torch_serve.py``'s rule (near-singular pixels turn an f32
  normal by degrees under an ulp of depth, so the two maps are not
  compared with each other: the port's normals op on the JAX depth is no
  worse than the JAX op against an f64 oracle, and the port's map is that
  op on its own depth).
* The step resumed from the import (``train.resume_dir``) against the JAX
  step resumed from the orbax checkpoint, at ``test_torch_train.py``'s
  one-step tolerances: loss metrics 1e-4 relative, ``grad_norm`` 1e-3,
  BatchNorm running variances 1e-5 relative and means 1e-5 of the running
  standard deviation; the optimizer's count and step advance together.
* The reference's state dict: the port's flax-layout tree equals the JAX
  importer's, and the imported checkpoint serves the same outputs as a
  session on that tree (max abs 0).
* A tree that does not match the model raises.
"""

import os
import shutil
import sys

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
from cnmnet_tpu.ops.images import prepare_images as jprepare  # noqa: E402
from cnmnet_tpu.serve import InferenceSession as JSession  # noqa: E402
from cnmnet_tpu.train import loop as jloop  # noqa: E402
from cnmnet_tpu.train import state as jstate  # noqa: E402
from cnmnet_tpu.train.checkpoint import CheckpointManager as JManager  # noqa: E402
from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import quantize_images_u8  # noqa: E402
from cnmnet_tpu_torch.models.transplant import flatten, key_map, load_flax_variables  # noqa: E402
from cnmnet_tpu_torch.serve import InferenceSession  # noqa: E402
from cnmnet_tpu_torch.train import import_checkpoint as imp  # noqa: E402
from cnmnet_tpu_torch.train import make_train_step  # noqa: E402
from cnmnet_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from cnmnet_tpu_torch.train.state import TrainState, build_model  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests.test_torch_serve import _normals_no_worse as normals_no_worse  # noqa: E402
from tools import orbax_to_npz  # noqa: E402
from tools.import_torch_checkpoint import (  # noqa: E402
    DEPTHNET_DISP_HEADS,
    REFINENET_DISP_HEADS,
    _depthnet_layout,
    _refinenet_layout,
)
from tools.import_torch_checkpoint import import_checkpoint as jimport_reference  # noqa: E402

H, W = 32, 64
TINY = ["dataset.image_height=32", "dataset.image_width=64", "model.num_planes=8",
        "model.k_size=5", "dataset.batch_size=2"]
PIPELINE_TOL = 7.2e-4


def _tiny(cls):
    cfg = cls()
    cfg.dataset.image_height, cfg.dataset.image_width = H, W
    cfg.model.num_planes = 8
    cfg.model.k_size = 5
    cfg.dataset.batch_size = 2
    return cfg


def _batch(seed):
    ds = SyntheticScenes(num_samples=2, height=H, width=W, view_num=3, seed=seed)
    batch = collate([ds[0], ds[1]])
    batch["images"] = normalize_images(batch["images"])
    batch.pop("index")
    return batch


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """One JAX step saved by the JAX manager at step 1, converted to .npz,
    and the JAX step resumed from that checkpoint. The model has its full
    widths (44 M parameters): the checkpoints, the .npz and the port's
    import are half a GB each, removed at the end of the module."""
    root = tmp_path_factory.mktemp("ckpt_import")
    try:
        yield _jax_run(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _jax_run(root):
    jcfg = _tiny(JConfig)
    b1, b2 = _batch(0), _batch(1)
    state = jstate.create_train_state(jcfg, jax.random.PRNGKey(0), b1)
    params = _np(state.params)
    for path in list(flatten({"params": params})):
        if "DispHead" in path and path.endswith("kernel"):
            node = params
            for part in path.split("/")[1:-1]:
                node = node[part]
            node["kernel"] = (node["kernel"] * np.float32(0.05)).astype(np.float32)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    step = jloop.make_train_step(jcfg)
    state, _ = step(state, {k: jnp.asarray(v) for k, v in b1.items()})
    mgr = JManager(str(root / "orbax"))
    mgr.save(state)
    mgr.wait()
    template = jstate.create_train_state(jcfg, jax.random.PRNGKey(1), b1)
    restored = mgr.restore("latest", template)
    # fresh host-made arrays: the restored ones are committed, and the step
    # would compile again for them
    restored = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), restored)
    resumed, metrics = step(restored, {k: jnp.asarray(v) for k, v in b2.items()})
    npz = str(root / "state.npz")
    assert orbax_to_npz.main(["--checkpoint", str(root / "orbax"), "--out", npz] + TINY) == 0
    return {"root": root, "state": state, "npz": npz, "b2": b2,
            "resumed": resumed, "metrics": {k: float(v) for k, v in metrics.items() if k != "viz"}}


def _jax_arrays(state):
    moments = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    return {**flatten({"params": _np(state.params), "batch_stats": _np(state.batch_stats)}),
            **flatten({"opt_state": {"mu": _np(moments.mu), "nu": _np(moments.nu)}}),
            "step": np.asarray(int(state.step)), "epoch": np.asarray(int(state.epoch))}


def _assert_arrays_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_converter_writes_the_jax_state(jax_run):
    with np.load(jax_run["npz"]) as z:
        got = {k: z[k] for k in z.files}
    _assert_arrays_equal(got, _jax_arrays(jax_run["state"]))
    assert int(got["step"]) == 1


@pytest.mark.parametrize("form", ["step_dir", "step_of_root"])
def test_converter_takes_every_checkpoint_form(jax_run, form):
    root = str(jax_run["root"] / "orbax")
    path, step = {"step_dir": (os.path.join(root, "1"), None), "step_of_root": (root, 1)}[form]
    template = orbax_to_npz.template_state(_tiny(JConfig))
    got = orbax_to_npz.state_to_arrays(orbax_to_npz.restore(path, template, step))
    _assert_arrays_equal(got, _jax_arrays(jax_run["state"]))


@pytest.mark.parametrize("method", ["adam", "sgd", "rmsprop", "adadelta"])
@pytest.mark.parametrize("chain", ["plain", "clip_decay_warmup"])
def test_moments_are_found_by_type(method, chain):
    cfg = JConfig()
    cfg.solver.method = method
    cfg.solver.grad_clip_norm = 1.0 if chain != "plain" else None
    cfg.solver.weight_decay = 1e-4 if chain != "plain" else 0.0
    cfg.solver.warmup_steps = 10 if chain != "plain" else 0
    params = {"a": jnp.ones(3), "b": {"c": jnp.zeros((2, 2))}}
    found = orbax_to_npz.find_moments(jstate.make_optimizer(cfg).init(params))
    want = {"adam": ("mu", "nu"), "sgd": ("trace",), "rmsprop": ("nu",),
            "adadelta": ("e_g", "e_x")}[method]
    assert tuple(found) == want
    for tree in found.values():
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)


@pytest.fixture(scope="module")
def imported(jax_run):
    out = str(jax_run["root"] / "port")
    assert imp.main(["--npz", jax_run["npz"], "--out", out] + TINY) == 0
    return out


def test_import_holds_the_converted_state(jax_run, imported):
    ckpt = torch.load(os.path.join(imported, "1", "state.pt"), weights_only=True)
    assert ckpt["step"] == 1 and ckpt["epoch"] == 0 and ckpt["opt_state"]["count"] == 1
    model = build_model(_config())
    with np.load(jax_run["npz"]) as z:
        for fkey, (tkey, transform) in key_map(model).items():
            np.testing.assert_array_equal(ckpt["model"][tkey].numpy(), transform(z[fkey]))
            if fkey.startswith("params/"):
                for m in ("mu", "nu"):
                    np.testing.assert_array_equal(
                        ckpt["opt_state"][m][tkey].numpy(),
                        transform(z[f"opt_state/{m}/{fkey[len('params/'):]}"]))
    assert set(ckpt["opt_state"]["mu"]) == {n for n, _ in model.named_parameters()}


def _config(checkpoint_dir=None):
    """The port config of ``TINY``; a session that restores opens a manager
    at ``train.checkpoint_dir``, so give it a temporary one."""
    from cnmnet_tpu_torch.config import apply_overrides

    cfg = apply_overrides(Config(), list(TINY))
    cfg.train.checkpoint_dir = str(checkpoint_dir) if checkpoint_dir else cfg.train.checkpoint_dir
    return cfg


def test_imported_checkpoint_serves_as_the_jax_session(jax_run, imported, tmp_path):
    ds = SyntheticScenes(num_samples=2, height=H, width=W, view_num=3, seed=7)
    batch = collate([ds[0], ds[1]])
    images, cams = quantize_images_u8(batch["images"]), batch["cams"].astype(np.float32)
    jcfg = _tiny(JConfig)
    jcfg.train.checkpoint_dir = str(tmp_path / "jax")
    js = JSession(jcfg, checkpoint=os.path.join(str(jax_run["root"] / "orbax"), "1"),
                  batch_buckets=(2,))
    want = js.predict(images, cams)
    ts = InferenceSession(_config(tmp_path / "port"), checkpoint=imported, batch_buckets=(2,),
                          device="cpu")
    got = ts.predict(images, cams)
    assert set(got) == set(want)
    for name in ("idepth", "prob"):
        assert np.abs(got[name] - want[name]).max() <= PIPELINE_TOL, name
    rel = np.abs(got["depth"] - want["depth"]) / np.maximum(np.abs(want["depth"]), 1.0)
    assert rel.max() <= PIPELINE_TOL
    normals_no_worse(got, want, cams)


def test_resumed_step_matches_the_resumed_jax_step(jax_run, imported, tmp_path):
    from cnmnet_tpu_torch.train.state import create_train_state

    cfg = _config()
    cfg.train.resume_dir = imported
    template = create_train_state(cfg, 3, "cpu")
    state = CheckpointManager(str(tmp_path), device="cpu").restore(cfg.train.resume_dir, template)
    assert state.step == 1 and state.opt_state["count"] == 1
    state, metrics = make_train_step(cfg)(state, jax_run["b2"])
    want = jax_run["metrics"]
    assert set(metrics) - {"viz"} == set(want)
    for k, v in want.items():
        tol = 1e-3 if k == "grad_norm" else 1e-4
        assert abs(float(metrics[k]) - v) <= tol * abs(v), (k, float(metrics[k]), v)
    assert state.opt_state["count"] == 2 and int(jax_run["resumed"].step) == 2
    sd = state.model.state_dict()
    stats = flatten({"batch_stats": _np(jax_run["resumed"].batch_stats)})
    for fkey, (tkey, transform) in key_map(state.model).items():
        if tkey.endswith("running_var"):
            var = transform(stats[fkey])
            assert np.abs(sd[tkey].numpy() / var - 1).max() <= 1e-5, tkey
            mean = transform(stats[fkey.replace("/var", "/mean")])
            mkey = tkey.replace("running_var", "running_mean")
            assert (np.abs(sd[mkey].numpy() - mean) <= 1e-5 * np.sqrt(var)).all(), mkey


def _reference_state_dict(jax_run):
    """A reference-format state dict with the shapes of the JAX tree, as
    ``tests/test_torch_import.py`` builds one (random values, BatchNorm
    counters, DataParallel's prefix on the DepthNet)."""
    params = _np(jax_run["state"].params)
    rng = np.random.default_rng(3)
    out = {}
    for net, layout, heads in (("depth_net", _depthnet_layout(), DEPTHNET_DISP_HEADS),
                               ("refine_net", _refinenet_layout(), REFINENET_DISP_HEADS)):
        sd = {}
        for prefix, ci, bi, fpath in layout:
            node = params[net]
            for part in fpath.split("/"):
                node = node[part]
            k = node["Conv_0"]["kernel"]
            c = k.shape[3]
            sd[f"{prefix}.{ci}.weight"] = torch.from_numpy(
                rng.standard_normal((c, k.shape[2], k.shape[0], k.shape[1])).astype(np.float32))
            for name in ("weight", "bias", "running_mean"):
                sd[f"{prefix}.{bi}.{name}"] = torch.from_numpy(
                    rng.standard_normal(c).astype(np.float32))
            sd[f"{prefix}.{bi}.running_var"] = torch.from_numpy(
                np.abs(rng.standard_normal(c)).astype(np.float32) + 0.5)
            sd[f"{prefix}.{bi}.num_batches_tracked"] = torch.tensor(100)
        for prefix, fpath in heads:
            node = params[net]
            for part in fpath.split("/"):
                node = node[part]
            k = node["Conv_0"]["kernel"]
            sd[f"{prefix}.0.weight"] = torch.from_numpy(
                (0.05 * rng.standard_normal((k.shape[3], k.shape[2], k.shape[0], k.shape[1])))
                .astype(np.float32))
            sd[f"{prefix}.0.bias"] = torch.from_numpy(rng.standard_normal(k.shape[3])
                                                      .astype(np.float32))
        out[f"{'depth' if net == 'depth_net' else 'depth_refine'}_network_state_dict"] = sd
    out["depth_network_state_dict"] = {"module." + k: v
                                       for k, v in out["depth_network_state_dict"].items()}
    out["global_step"] = 1234
    return out


def test_reference_import_equals_the_jax_importer(jax_run, tmp_path):
    ckpt = _reference_state_dict(jax_run)
    jparams, jstats = jimport_reference(
        {k: {kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict) else v
         for k, v in ckpt.items()}, _tiny(JConfig))
    want = flatten({"params": _np(jparams), "batch_stats": _np(jstats)})
    _assert_arrays_equal(imp.reference_to_flax(ckpt), want)

    torch.save(ckpt, tmp_path / "reference.pt")
    out = str(tmp_path / "port")
    try:
        assert imp.main(["--torch-ckpt", str(tmp_path / "reference.pt"), "--out", out] + TINY) == 0
        assert CheckpointManager(out, device="cpu").latest_step() == 1234
        session = InferenceSession(_config(tmp_path), checkpoint=out, batch_buckets=(1,),
                                   device="cpu")
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    ds = SyntheticScenes(num_samples=1, height=H, width=W, view_num=3, seed=9)
    images = quantize_images_u8(ds[0]["images"])[None]
    cams = ds[0]["cams"].astype(np.float32)[None]
    got = session.predict(images, cams)
    direct = InferenceSession(_config(), flax_variables={"params": _np(jparams),
                                                         "batch_stats": _np(jstats)},
                              batch_buckets=(1,), device="cpu").predict(images, cams)
    for k in direct:
        np.testing.assert_array_equal(got[k], direct[k], err_msg=k)


def test_mismatched_trees_raise(jax_run, tmp_path):
    cfg = _config()
    flat = _jax_arrays(jax_run["state"])
    key = next(k for k in flat if k.startswith("params/") and k.endswith("kernel"))
    with pytest.raises(KeyError, match="does not match the model"):
        imp.state_from_arrays(cfg, {k: v for k, v in flat.items() if k != key})
    bad = dict(flat)
    bad[key] = bad[key][..., :1]
    with pytest.raises(ValueError, match="shape"):
        imp.state_from_arrays(cfg, bad)
    bad = {k: v for k, v in flat.items() if k != "opt_state/mu/" + key[len("params/"):]}
    with pytest.raises(KeyError, match="moment 'mu'"):
        imp.state_from_arrays(cfg, bad)
    sgd = _config()
    sgd.solver.method = "sgd"
    with pytest.raises(KeyError, match="takes \\['trace'\\]"):
        imp.state_from_arrays(sgd, flat)
    no_refiner = _config()
    no_refiner.model.use_refiner = False
    with pytest.raises(KeyError, match="does not match the model"):
        imp.state_from_arrays(no_refiner, flat)

    ckpt = _reference_state_dict(jax_run)
    ckpt["depth_refine_network_state_dict"]["extra.weight"] = torch.zeros(1)
    with pytest.raises(KeyError, match="no layer takes"):
        imp.reference_to_flax(ckpt)
    ckpt = _reference_state_dict(jax_run)
    del ckpt["depth_network_state_dict"]["module.conv2.4.running_var"]
    with pytest.raises(KeyError, match="missing"):
        imp.reference_to_flax(ckpt)
    group_cfg = _config()
    group_cfg.model.norm = "group"
    with pytest.raises(KeyError, match="does not match the model"):
        load_flax_variables(build_model(group_cfg),
                            imp.unflatten(imp.reference_to_flax(_reference_state_dict(jax_run))))


def test_import_writes_a_step_that_resume_dir_reads(imported, tmp_path):
    """``train.resume_dir`` and ``--checkpoint`` take the manager root that
    the import wrote, as they take a training run's."""
    cfg = _config(tmp_path)
    state = CheckpointManager(cfg.train.checkpoint_dir, device="cpu").restore(
        imported, TrainState(model=build_model(cfg), opt_state={}))
    assert state.step == 1 and state.opt_state["count"] == 1
