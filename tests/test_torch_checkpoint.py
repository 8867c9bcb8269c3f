"""The port's ``CheckpointManager`` and the checkpoint cadence of
``train_loop`` (the counterparts of ``tests/test_train.py``'s checkpoint
tests), on the CPU. The states here are made without a forward pass: the
moments, statistics and counters are filled from a seeded generator."""

import copy
import os
import signal

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from cnmnet_tpu_torch.config import Config  # noqa: E402
from cnmnet_tpu_torch.models import layers as tlayers  # noqa: E402
from cnmnet_tpu_torch.train import CheckpointManager, TrainState, make_optimizer  # noqa: E402
from cnmnet_tpu_torch.train import loop as loop_mod  # noqa: E402


def _cfg():
    cfg = Config()
    cfg.model.num_planes = 8
    cfg.model.k_size = 5
    return cfg


def _fresh(seed=0):
    """A small state of the train state's kind: a conv and the port's
    BatchNorm (parameters, running statistics, a step counter) and zero
    Adam moments. A CNMModel's checkpoint is some 500 MB."""
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, bias=False), tlayers.BatchNorm2d(4))
    tlayers.init_weights(model, torch.Generator().manual_seed(seed))
    opt_state = make_optimizer(_cfg()).init(dict(model.named_parameters()))
    return TrainState(model=model, opt_state=opt_state)


def _filled_state(seed, step=3, epoch=1):
    """A state whose every tensor is seeded noise: parameters, BatchNorm
    statistics and Adam moments."""
    state = _fresh()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in state.model.state_dict().items():
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
        for m in ("mu", "nu"):
            for t in state.opt_state[m].values():
                t.copy_(torch.rand(t.shape, generator=g))
    state.opt_state["count"] = step
    state.step, state.epoch = step, epoch
    return state


def _assert_equal_states(a, b, with_optimizer=True):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert (a.step, a.epoch) == (b.step, b.epoch)
    if with_optimizer:
        assert a.opt_state["count"] == b.opt_state["count"]
        for m in ("mu", "nu"):
            for k in a.opt_state[m]:
                assert torch.equal(a.opt_state[m][k], b.opt_state[m][k]), (m, k)


def test_round_trip_is_bit_exact(tmp_path):
    state = _filled_state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    assert mgr.save(state) == 3
    mgr.wait()
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / "ck")) == ["3"]  # no temporary left behind
    restored = mgr.restore("latest", _fresh())
    _assert_equal_states(restored, state)


@pytest.mark.parametrize("how", ["int", "latest", "none", "root", "step_dir"])
def test_restore_addresses(tmp_path, how):
    root = tmp_path / "root"
    mgr = CheckpointManager(str(root), device="cpu")
    mgr.save(_filled_state(0, step=2))
    newest = _filled_state(5, step=7)
    mgr.save(newest)
    other = CheckpointManager(str(tmp_path / "elsewhere"), device="cpu")
    template = _fresh()
    if how == "int":
        restored = mgr.restore(7, template)
    elif how == "latest":
        restored = mgr.restore("latest", template)
    elif how == "none":
        restored = mgr.restore(None, template)
    elif how == "root":
        restored = other.restore(str(root), template)
    else:
        restored = other.restore(str(root / "7"), template)
    _assert_equal_states(restored, newest)


def test_restore_latest_of_an_empty_manager_is_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"), device="cpu")
    assert mgr.latest_step() is None
    assert mgr.restore("latest", _fresh()) is None


def test_restore_without_optimizer_zeroes_the_moments(tmp_path):
    state = _filled_state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    mgr.save(state)
    restored = mgr.restore("latest", _filled_state(1), with_optimizer=False)
    _assert_equal_states(restored, state, with_optimizer=False)
    assert restored.opt_state["count"] == 0
    for m in ("mu", "nu"):
        assert all(float(t.abs().max()) == 0.0 for t in restored.opt_state[m].values())


def test_save_is_idempotent(tmp_path):
    first = _filled_state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    mgr.save(first, step=4)
    assert mgr.save(_filled_state(9), step=4) == 4
    _assert_equal_states(mgr.restore(4, _fresh()), first)


def test_retention_keeps_the_newest(tmp_path):
    state = _filled_state(0)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        mgr.save(state, step=s)
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]


# -- cadence ------------------------------------------------------------------


class Recorder:
    def __init__(self):
        self.saved = []

    def save(self, state, step=None):
        self.saved.append(int(step))

    def wait(self):
        pass


@pytest.fixture
def counting_step(monkeypatch):
    """``make_train_step`` stood in by a step that only counts, and
    ``create_train_state`` by the small state."""
    monkeypatch.setattr(loop_mod, "create_train_state", lambda cfg, seed, device: _fresh(seed))

    def fake_make_train_step(cfg, mesh=None):
        def fake_step(state, batch):
            state.step += 1
            return state, {"loss": torch.tensor(1.0)}

        return fake_step

    monkeypatch.setattr(loop_mod, "make_train_step", fake_make_train_step)


def _data(n):
    def data():
        return iter([{}] * n)

    return data


def test_interval_and_epoch_end_saves(counting_step):
    cfg = _cfg()
    cfg.train.num_epochs = 1
    cfg.train.ckpt_interval = 2
    rec = Recorder()
    loop_mod.train_loop(cfg, _data(5), checkpointer=rec, device="cpu")
    assert rec.saved == [2, 4, 5]


def test_max_steps_exit_saves(counting_step):
    cfg = _cfg()
    cfg.train.num_epochs = 1
    cfg.train.ckpt_interval = 2
    rec = Recorder()
    state = loop_mod.train_loop(cfg, _data(10), checkpointer=rec, max_steps=3, device="cpu")
    assert rec.saved == [2, 3]
    assert state.step == 3


def test_steps_per_epoch_and_epoch_ends(counting_step):
    cfg = _cfg()
    cfg.train.num_epochs = 2
    cfg.train.steps_per_epoch = 3
    rec = Recorder()
    state = loop_mod.train_loop(cfg, _data(100), checkpointer=rec, device="cpu")
    assert rec.saved == [3, 6]
    assert (state.step, state.epoch) == (6, 1)


def test_sigterm_leaves_a_checkpoint_at_its_step(counting_step, monkeypatch, tmp_path):
    """SIGTERM sent to this process during step 3: the step finishes, the
    loop raises KeyboardInterrupt and step 3 is on disk. No subprocess and
    no clock."""

    def make(cfg, mesh=None):
        def step(state, batch):
            state.step += 1
            if state.step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, {"loss": torch.tensor(1.0)}

        return step

    monkeypatch.setattr(loop_mod, "make_train_step", make)
    before = signal.getsignal(signal.SIGTERM)
    cfg = _cfg()
    cfg.train.num_epochs = 1
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    with pytest.raises(KeyboardInterrupt, match="SIGTERM"):
        loop_mod.train_loop(cfg, _data(100), checkpointer=mgr, device="cpu")
    assert mgr.latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_resume_continues_from_the_checkpoint(counting_step, monkeypatch, tmp_path):
    """A run to step 2, then a run from ``train.resume_dir`` to step 3: it
    starts from the checkpoint's weights and counters."""
    cfg = _cfg()
    cfg.train.num_epochs = 1
    mgr = CheckpointManager(str(tmp_path / "ck"), device="cpu")
    first = loop_mod.train_loop(cfg, _data(10), checkpointer=mgr, max_steps=2, device="cpu")
    with torch.no_grad():
        for p in first.model.parameters():
            p.add_(1.0)  # the resumed run must read the disk, not this state
    saved = CheckpointManager(str(tmp_path / "ck"), device="cpu").restore(2, _fresh(7))

    cfg.train.resume_dir = str(tmp_path / "ck")
    seen = []

    def recording_step(state, batch):
        seen.append(copy.deepcopy(state.model.state_dict()))
        state.step += 1
        return state, {"loss": torch.tensor(1.0)}

    monkeypatch.setattr(loop_mod, "make_train_step", lambda c, mesh=None: recording_step)
    resumed = loop_mod.train_loop(cfg, _data(10), checkpointer=mgr, max_steps=3, device="cpu")
    assert resumed.step == 3 and mgr.all_steps() == [2, 3]
    for k, v in saved.model.state_dict().items():
        assert torch.equal(seen[0][k], v), k
