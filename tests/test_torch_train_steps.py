"""Properties of the port's train step, on the port alone (CPU, 32x64, 8
planes, k = 5, batch 2): the counterparts of ``tests/test_train.py``'s
step tests, the frozen refiner, gradient accumulation and the watchdog."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.data.pipeline import collate, normalize_images  # noqa: E402
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes, train_data_fn  # noqa: E402
from cnmnet_tpu_torch.train import loop as loop_mod  # noqa: E402
from cnmnet_tpu_torch.train import CheckpointManager, create_train_state  # noqa: E402
from cnmnet_tpu_torch.train import make_optimizer, make_train_step  # noqa: E402
from cnmnet_tpu_torch.train.state import global_norm  # noqa: E402

H, W = 32, 64


def _cfg(**train):
    cfg = Config()
    cfg.model.num_planes = 8
    cfg.model.k_size = 5
    cfg.dataset.batch_size = 2
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def _batch(views=3, seed=123):
    ds = SyntheticScenes(num_samples=2, height=H, width=W, view_num=views, seed=seed)
    batch = collate([ds[0], ds[1]])
    batch["images"] = normalize_images(batch["images"])
    batch.pop("index")
    return batch


@pytest.fixture(scope="module")
def batch():
    return _batch()


def test_loss_decreases_and_finite(batch):
    cfg = _cfg()
    state = create_train_state(cfg, 0, "cpu")
    step = make_train_step(cfg)
    losses = []
    for _ in range(6):
        state, metrics = step(state, batch)
        viz = metrics.pop("viz")
        losses.append(float(metrics["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(metrics["grad_norm"]))
        assert all(m.dim() == 0 and not m.requires_grad for m in metrics.values())
        assert set(viz) == {"pred_idepth_01", "pred_idepth_refined", "prob_map"}
        assert all(v.shape == (2, H, W, 1) and not v.requires_grad for v in viz.values())
    assert losses[-1] < losses[0], losses
    assert state.step == 6 and state.opt_state["count"] == 6


def test_wo_normal_recipe_curriculum(batch):
    cfg = _cfg(use_normal_loss=False, curriculum_epochs=5)
    s0 = create_train_state(cfg, 0, "cpu")
    s6 = copy.deepcopy(s0)
    s6.epoch = 6
    _, m0 = make_train_step(cfg)(s0, batch)
    _, m6 = make_train_step(cfg)(s6, batch)
    assert float(m6["loss"]) > float(m0["loss"])
    assert "loss_normal_depth" not in m0


def test_frozen_refiner_is_bit_identical():
    """2-view batches skip the refiner: its parameters get no gradient, no
    decay, and stay bit-identical (the moments of a zero gradient stay 0),
    while DepthNet trains."""
    cfg = _cfg()
    state = create_train_state(cfg, 0, "cpu")
    assert state.model.refine_net is not None
    before = copy.deepcopy(state.model.state_dict())
    step = make_train_step(cfg)
    batch2 = _batch(views=2)
    for _ in range(3):
        state, metrics = step(state, batch2)
        assert np.isfinite(float(metrics["loss"]))
    after = state.model.state_dict()
    refiner = [k for k in after if k.startswith("refine_net.")]
    assert refiner
    for k in refiner:
        assert torch.equal(after[k], before[k]), k
    assert not torch.equal(after["depth_net.conv1.0.weight"], before["depth_net.conv1.0.weight"])


def test_accum_matches_sequential_reference(batch):
    """grad_accum = 2 is the sequential reference: microbatches of one
    sample each, BatchNorm statistics chained, gradients and metrics
    averaged, one update."""
    cfg = _cfg(grad_accum=2)
    state = create_train_state(cfg, 0, "cpu")
    ref = copy.deepcopy(state)
    state, metrics = make_train_step(cfg)(state, batch)

    w = loop_mod.loss_weights_from_config(cfg)
    model = ref.model.train()
    names = [n for n, _ in model.named_parameters()]
    total, losses = None, []
    for i in range(2):  # a Python loop over one-sample microbatches
        mb = loop_mod.batch_to_device({k: v[i:i + 1] for k, v in batch.items()}, "cpu")
        g, m, _ = loop_mod.loss_and_grads(model, mb, 0, w)
        total = g if total is None else [a + b for a, b in zip(total, g)]
        losses.append(float(m["loss"]))
    grads = [x * 0.5 for x in total]
    opt = make_optimizer(cfg)
    params = dict(model.named_parameters())
    updates, _ = opt.update(dict(zip(names, grads)), ref.opt_state, params)
    opt.apply(params, updates)

    assert float(metrics["loss"]) == pytest.approx(np.mean(losses), rel=1e-6)
    assert float(metrics["grad_norm"]) == pytest.approx(float(global_norm(grads)), rel=1e-6)
    got, want = state.model.state_dict(), model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_accum_requires_divisible_batch(batch):
    cfg = _cfg(grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(cfg)(create_train_state(cfg, 0, "cpu"), batch)


def test_no_valid_depth_drops_normal_terms_with_finite_gradients(batch):
    """One sample without a valid depth: the normal losses go NaN, the NaN
    guard drops them from the loss, and every gradient stays finite."""
    b = {k: v.copy() for k, v in batch.items()}
    b["depths"][1, 0] = 0.0
    cfg = _cfg()
    state = create_train_state(cfg, 0, "cpu")
    tb = loop_mod.batch_to_device(b, "cpu")
    grads, metrics, _ = loop_mod.loss_and_grads(state.model.train(), tb, 0,
                                             loop_mod.loss_weights_from_config(cfg))
    assert np.isnan(float(metrics["loss_normal_depth"]))
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_watchdog_halts_and_leaves_a_checkpoint(batch, monkeypatch):
    calls = {"n": 0}

    def fake_make_train_step(cfg, mesh=None):
        def fake_step(state, b):
            calls["n"] += 1
            state.step += 1
            return state, {"loss": torch.tensor(np.nan if calls["n"] > 2 else 1.0)}

        return fake_step

    monkeypatch.setattr(loop_mod, "make_train_step", fake_make_train_step)

    def data():
        while True:
            yield batch

    class Recorder:  # a CNMModel checkpoint is some 500 MB: record the saves
        saved = []

        def save(self, state, step=None):
            self.saved.append(step)

        def wait(self):
            pass

    cfg = _cfg(num_epochs=1, steps_per_epoch=50)
    rec = Recorder()
    with pytest.raises(FloatingPointError, match="non-finite"):
        loop_mod.train_loop(cfg, data, checkpointer=rec, device="cpu")
    assert calls["n"] == 6  # NaN at steps 3, 4, 5, read one step late
    assert rec.saved == [6]


def test_bf16_training_is_not_ported():
    """bf16 training is ported (``tests/test_torch_train.py`` holds a step to
    JAX's): the state keeps f32 parameters, BatchNorm statistics and
    moments, and its convs compute in bf16. A compute dtype the JAX
    package's bf16/f32 pair does not cover raises."""
    cfg = _cfg()
    cfg.model.compute_dtype = "bfloat16"
    state = create_train_state(cfg, 0, "cpu")
    assert state.model.compute_dtype == torch.bfloat16
    tensors = list(state.model.state_dict().values()) + list(state.opt_state["mu"].values())
    assert all(t.dtype == torch.float32 for t in tensors if t.is_floating_point())
    cfg.model.compute_dtype = "float16"
    with pytest.raises(ValueError, match="float16"):
        create_train_state(cfg, 0, "cpu")


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card, the default device raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="cuda"):
        create_train_state(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        CheckpointManager(str(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="cuda"):
        loop_mod.train_loop(cfg, lambda: iter([]))


def test_train_loop_on_synthetic_scenes_logs_scalars():
    """``train_loop`` end to end on the CPU with ``train_data_fn``, as a
    user runs it: two real steps, logged through ``log_scalars``."""
    cfg = _cfg(num_epochs=1, print_interval=1)
    cfg.dataset.image_height, cfg.dataset.image_width = H, W
    cfg.dataset.synthetic_size = 4
    logged = []

    class Logger:
        def log_scalars(self, step, scalars, prefix=""):
            logged.append((step, prefix, scalars))

    state = loop_mod.train_loop(cfg, train_data_fn(cfg), logger=Logger(), max_steps=2,
                                device="cpu")
    assert state.step == 2
    assert [s for s, _, _ in logged] == [1]  # step 2 ends the run before its log line
    step, prefix, scalars = logged[0]
    assert prefix == "epoch 0" and np.isfinite(scalars["loss"]) and "grad_norm" in scalars


class _SummaryLogger:
    """Records every scalar, image and histogram call."""

    def __init__(self, fail_images=False):
        self.scalars, self.images, self.histograms = [], [], []
        self.fail_images = fail_images

    def log_scalars(self, step, scalars, prefix=""):
        self.scalars.append(step)

    def log_image(self, step, tag, image):
        if self.fail_images:
            raise OSError("disk full")
        assert image.ndim == 3 and image.shape[-1] == 3
        self.images.append((step, tag))

    def log_histogram(self, step, tag, values):
        self.histograms.append((step, tag, np.asarray(values).shape))


def test_image_summaries_at_the_jax_cadence(batch, monkeypatch):
    """Scalars every ``print_interval`` iterations, the image summaries at
    ``it % (print_interval * 10) == 0`` (``cnmnet_tpu/train/loop.py:401``),
    of the first sample only; ``viz`` leaves the logged metrics."""
    def fake_make_train_step(cfg, mesh=None):
        def fake_step(state, b):
            state.step += 1
            maps = torch.rand(2, H, W, 1)
            return state, {"loss": torch.tensor(1.0),
                           "viz": {"pred_idepth_01": maps, "pred_idepth_refined": maps,
                                   "prob_map": maps}}
        return fake_step

    monkeypatch.setattr(loop_mod, "make_train_step", fake_make_train_step)
    cfg = _cfg(num_epochs=1, steps_per_epoch=45, print_interval=2)
    log = _SummaryLogger()
    loop_mod.train_loop(cfg, lambda: iter([batch] * 45), logger=log, device="cpu")
    assert log.scalars == list(range(1, 46, 2))
    tags = ["rgb", "gt_idepth", "gt_normal", "pred_idepth_01", "pred_idepth_refined", "prob_map"]
    assert log.images == [(s, t) for s in (1, 21, 41) for t in tags]
    assert log.histograms == [(s, t, (1, H, W, 1)) for s in (1, 21, 41)
                              for t in ("prob_map", "pred_idepth_01")]


def test_image_summaries_from_a_real_step_and_failures(batch, capsys):
    cfg = _cfg()
    state = create_train_state(cfg, 0, "cpu")
    _, metrics = make_train_step(cfg)(state, batch)
    log = _SummaryLogger()
    loop_mod._log_images(log, 1, batch, metrics["viz"])
    assert len(log.images) == 6 and len(log.histograms) == 2
    # a failure of the logging itself is printed and the run goes on
    loop_mod._log_images(_SummaryLogger(fail_images=True), 1, batch, metrics["viz"])
    assert "image logging failed" in capsys.readouterr().out

    class Lost:  # a map whose copy to the host fails, as a lost device would
        def __getitem__(self, index):
            raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        loop_mod._log_images(log, 1, batch, {"pred_idepth_01": Lost()})


def test_grad_accum_summaries_come_from_microbatch_0(batch):
    cfg = _cfg(grad_accum=2)
    state = create_train_state(cfg, 0, "cpu")
    ref = copy.deepcopy(state)
    _, metrics = make_train_step(cfg)(state, batch)
    mb0 = loop_mod.batch_to_device({k: v[:1] for k, v in batch.items()}, "cpu")
    _, _, want = loop_mod.loss_and_grads(ref.model.train(), mb0, 0,
                                          loop_mod.loss_weights_from_config(cfg))
    assert set(metrics["viz"]) == set(want)
    for k, v in want.items():
        assert torch.equal(metrics["viz"][k], v), k
