"""The port's configuration loading and ``PrefetchLoader`` against the JAX
package's, on the CPU (host code: nothing is compiled).

* ``apply_overrides`` gives the JAX function's typed values (ints, floats,
  bools, Optional fields set and cleared, strings), equal config dicts;
  ``load_config`` reads the same YAML to the same config, and without
  PyYAML raises an ``ImportError`` that says so, while ``load_config(None)``
  and overrides still work.
* ``PrefetchLoader`` yields the JAX loader's batches, equal, for every
  epoch, shard, ``shuffle`` and ``drop_last`` setting tried; a worker's
  exception reaches the consumer.
"""

import sys
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from cnmnet_tpu import config as jconfig  # noqa: E402
from cnmnet_tpu.data.pipeline import PrefetchLoader as JLoader  # noqa: E402
from cnmnet_tpu_torch import config as tconfig  # noqa: E402
from cnmnet_tpu_torch.data import PrefetchLoader, collate  # noqa: E402

OVERRIDES = [
    ["dataset.batch_size=2"],
    ["solver.lr=3e-4", "solver.weight_decay=0"],
    ["solver.grad_clip_norm=1.5"],
    ["solver.grad_clip_norm=none"],
    ["train.steps_per_epoch=7", "train.ckpt_interval=null"],
    ["train.resume_dir=/runs/a", "parallel.coordinator_address=localhost:1234"],
    ["model.use_refiner=false", "dataset.synthetic=yes", "model.cv_backend=cuda"],
    ["dataset.depth_scale=2", "model.k_size=5", "model.compute_dtype=bfloat16"],
    ["train.log_dir=a=b"],
]


def test_defaults_match_jax():
    assert tconfig.to_dict(tconfig.Config()) == jconfig.to_dict(jconfig.Config())


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: ",".join(o))
def test_overrides_match_jax(overrides):
    got = tconfig.to_dict(tconfig.apply_overrides(tconfig.Config(), overrides))
    want = jconfig.to_dict(jconfig.apply_overrides(jconfig.Config(), overrides))
    assert got == want
    assert [type(v) for s in got.values() for v in s.values()] == \
        [type(v) for s in want.values() for v in s.values()]


@pytest.mark.parametrize("text,current", [
    ("4", None), ("2.5", None), ("abc", None), ("None", None), ("True", False),
    ("0", True), ("7", 1), ("7", 1.0), ("a,b", ["x"]), ("s", "t"),
])
def test_parse_value_matches_jax(text, current):
    got, want = tconfig._parse_value(text, current), jconfig._parse_value(text, current)
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("bad,error", [
    (["dataset.batch_size"], ValueError),
    (["dataset.no_such_key=1"], KeyError),
])
def test_bad_overrides_raise_as_jax(bad, error):
    with pytest.raises(error):
        jconfig.apply_overrides(jconfig.Config(), bad)
    with pytest.raises(error):
        tconfig.apply_overrides(tconfig.Config(), bad)


def test_load_config_yaml_matches_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("dataset:\n  batch_size: 5\n  image_height: 96\nsolver:\n  method: sgd\n"
                    "  grad_clip_norm: 2.0\ntrain:\n  resume_dir: null\n  seed: 7\n")
    assert tconfig.to_dict(tconfig.load_config(str(path))) == \
        jconfig.to_dict(jconfig.load_config(str(path)))
    bad = tmp_path / "bad.yaml"
    bad.write_text("model:\n  no_such_key: 1\n")
    with pytest.raises(KeyError, match="no_such_key"):
        tconfig.load_config(str(bad))


def test_load_config_without_yaml(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    with pytest.raises(ImportError, match="PyYAML"):
        tconfig.load_config(str(tmp_path / "cfg.yaml"))
    cfg = tconfig.apply_overrides(tconfig.load_config(None), ["dataset.batch_size=3"])
    assert cfg.dataset.batch_size == 3


class Indexed:
    """A dataset whose sample is its own index."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise IndexError(f"sample {i} is broken")
        return {"i": np.int64(i), "x": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("batch_size,shuffle,drop_last,shard_index,shard_count", [
    (3, True, True, 0, 1),
    (3, True, False, 0, 1),
    (4, False, False, 0, 1),
    (2, True, True, 1, 3),
    (3, True, False, 2, 3),
    (5, False, True, 0, 2),
])
def test_prefetch_loader_matches_jax(batch_size, shuffle, drop_last, shard_index, shard_count):
    kw = dict(batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, seed=9,
              num_workers=2, shard_index=shard_index, shard_count=shard_count)
    ours, theirs = PrefetchLoader(Indexed(23), **kw), JLoader(Indexed(23), **kw)
    assert len(ours) == len(theirs)
    for _ in range(3):  # each epoch reshuffles with seed + epoch
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_transform_and_collate():
    loader = PrefetchLoader(Indexed(6), batch_size=2, shuffle=False,
                            transform=lambda b: {**b, "x": b["x"] * 2})
    batches = list(loader)
    assert [b["i"].tolist() for b in batches] == [[0, 1], [2, 3], [4, 5]]
    np.testing.assert_array_equal(batches[1]["x"], 2 * collate([Indexed(6)[i] for i in (2, 3)])["x"])


def test_prefetch_loader_worker_error_reaches_the_consumer():
    loader = PrefetchLoader(Indexed(8, fail_at=5), batch_size=2, shuffle=False)
    seen = []
    with pytest.raises(IndexError, match="sample 5"):
        for b in loader:
            seen.append(b["i"].tolist())
    assert seen == [[0, 1], [2, 3]]


def test_prefetch_loader_stops_its_producer_when_the_consumer_leaves():
    before = set(threading.enumerate())
    it = iter(PrefetchLoader(Indexed(64), batch_size=2, prefetch=1))
    next(it)
    assert set(threading.enumerate()) - before  # the producer and its workers
    it.close()  # the generator's finally stops and joins the producer
    assert not set(threading.enumerate()) - before


def test_prefetch_loader_shard_arguments_are_checked():
    with pytest.raises(ValueError, match="shard_index"):
        PrefetchLoader(Indexed(4), batch_size=2, shard_index=2, shard_count=2)
