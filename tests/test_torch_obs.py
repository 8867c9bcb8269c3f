"""The port's ``obs/`` against the JAX package's, on the CPU (host code:
nothing is compiled).

* ``MetricLogger``: the same calls give the same ``events.jsonl`` records
  (``time`` apart), the same ``config.json``, the same echo lines, and
  PNGs that decode to the same pixels (the JAX logger writes them with
  PIL, the port with ``data/imageio.write_png``); only rank 0 writes.
* ``tb_export``: the two converters write byte-equal files for the same
  run directory at the same wall clock.
* ``AverageMeter`` averages as JAX's does, and ``synchronize`` waits for
  the CUDA device of a result (never for a CPU tensor).
* ``forward_slope_seconds`` chains each call on the previous output and
  takes the median slope.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from cnmnet_tpu.obs import logger as jlogger  # noqa: E402
from cnmnet_tpu.obs import meters as jmeters  # noqa: E402
from cnmnet_tpu.obs import tb_export as jtb  # noqa: E402
from cnmnet_tpu_torch.data.imageio import read_png  # noqa: E402
from cnmnet_tpu_torch.obs import AverageMeter, MetricLogger  # noqa: E402
from cnmnet_tpu_torch.obs import logger as tlogger  # noqa: E402
from cnmnet_tpu_torch.obs import meters as tmeters  # noqa: E402
from cnmnet_tpu_torch.obs import tb_export as ttb  # noqa: E402
from cnmnet_tpu_torch.obs.timing import forward_slope_seconds  # noqa: E402


def _log_run(cls, log_dir, echoed):
    rng = np.random.default_rng(4)
    log = cls(str(log_dir), config={"solver": {"lr": 1e-4}, "path": log_dir}, echo=echoed.append)
    log.log_scalars(1, {"loss": 2.5, "abs_rel": np.float32(0.25), "n": 3}, prefix="epoch 0")
    log.log_scalars(2, {"loss": 1.25})
    values = rng.normal(size=200)
    values[:5] = [np.nan, np.inf, -np.inf, np.nan, 1e30]
    log.log_histogram(2, "prob_map", values)
    log.log_histogram(2, "empty", np.full(4, np.nan))  # nothing finite: no record
    log.log_histogram(3, "const", np.full(64, 2.0))
    log.log_image(3, "rgb", rng.integers(0, 256, (5, 7, 3), dtype=np.uint8))
    log.log_image(3, "float", rng.uniform(-0.2, 1.2, (4, 6, 3)))
    log.close()


def _records(log_dir):
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        assert isinstance(r.pop("time"), float)
    return recs


def test_metric_logger_matches_jax(tmp_path):
    ours, theirs = [], []
    _log_run(MetricLogger, tmp_path / "port", ours)
    _log_run(jlogger.MetricLogger, tmp_path / "jax", theirs)
    assert ours == theirs and ours[0].startswith("[epoch 0][1] loss: 2.5000")
    got, want = _records(tmp_path / "port"), _records(tmp_path / "jax")
    assert got == want and len(got) == 4
    assert set(got[2]) == {"step", "type", "tag", "min", "max", "mean", "std", "p5", "p50", "p95"}
    cfg = [json.loads((tmp_path / d / "config.json").read_text()) for d in ("port", "jax")]
    assert cfg[0]["solver"] == cfg[1]["solver"] == {"lr": 1e-4}
    for tag in ("rgb", "float"):
        a = read_png(str(tmp_path / "port" / "images" / tag / "00000003.png"))
        b = np.asarray(Image.open(tmp_path / "jax" / "images" / tag / "00000003.png"))
        np.testing.assert_array_equal(a, b)


def test_metric_logger_writes_on_rank_zero_only(tmp_path, monkeypatch):
    assert tlogger._is_main_process()  # no process group
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    log = MetricLogger(str(tmp_path / "rank1"), config={"a": 1})
    log.log_scalars(1, {"loss": 1.0})
    log.log_image(1, "rgb", np.zeros((2, 2, 3), np.uint8))
    log.close()
    assert not log.enabled and not (tmp_path / "rank1").exists()
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    assert MetricLogger(str(tmp_path / "rank0"), echo=None).enabled


def test_tb_export_is_byte_equal_to_jax(tmp_path, monkeypatch):
    _log_run(MetricLogger, tmp_path / "run", [])
    monkeypatch.setattr(ttb.time, "time", lambda: 1.7e9)  # the file name and version record
    ours = ttb.convert_run(str(tmp_path / "run"), str(tmp_path / "port"))
    theirs = jtb.convert_run(str(tmp_path / "run"), str(tmp_path / "jax"))
    assert os.path.basename(ours) == os.path.basename(theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        blob = a.read()
        assert blob == b.read() and len(blob) > 200
    events = [ttb.parse_proto(r) for r in ttb.read_records(ours)]
    assert events[0][3] == [b"brain.Event:2"]
    assert sorted(e[2][0] for e in events[1:]) == [1, 2, 2, 3, 3, 3]


def test_tb_export_codec():
    assert ttb.crc32c(b"123456789") == 0xE3069283
    assert ttb._varint(300) == jtb._varint(300) == b"\xac\x02"
    data = ttb._f_varint(2, 7) + ttb._f_double(1, 0.5) + ttb._f_float(5, 1.5) + ttb._f_bytes(3, b"x")
    assert ttb.parse_proto(data) == {2: [7], 1: [0.5], 5: [1.5], 3: [b"x"]}


def test_tb_export_main_and_crc_check(tmp_path):
    _log_run(MetricLogger, tmp_path / "run", [])
    ttb.main([str(tmp_path / "run"), "--out", str(tmp_path / "tb")])
    (path,) = [p for p in (tmp_path / "tb").iterdir() if p.name.startswith("events.out.tfevents")]
    blob = bytearray(path.read_bytes())
    blob[-3] ^= 0xFF
    bad = tmp_path / "corrupt.tfevents"
    bad.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="crc"):
        list(ttb.read_records(str(bad)))


def test_average_meter_matches_jax():
    ours, theirs = AverageMeter(), jmeters.AverageMeter()
    for val, n in ((2.0, 1), (4.0, 3), (0.5, 2)):
        ours.update(val, n)
        theirs.update(val, n)
        assert (ours.val, ours.sum, ours.count, ours.avg) == \
            (theirs.val, theirs.sum, theirs.count, theirs.avg)
    ours.reset()
    assert (ours.avg, ours.count) == (0.0, 0)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device."""

    @property
    def is_cuda(self):
        return True


def test_synchronize_waits_for_the_result_device(monkeypatch):
    synced = []
    monkeypatch.setattr(tmeters.torch.cuda, "synchronize", lambda device=None: synced.append(device))
    tmeters.synchronize(torch.ones(3))
    assert synced == []  # CPU: no sync
    card = torch.ones(2).as_subclass(_OnCard)
    tmeters.synchronize({"a": card, "b": (torch.ones(1), [card])})
    assert synced == [card.device, card.device]


def test_forward_slope_chains_calls():
    seen = []

    def forward(images, cams):
        seen.append(images)
        return images * 2.0, None

    images = torch.ones(1, 2, 4, 4, 3)
    t = forward_slope_seconds(forward, images, torch.zeros(1), k1=2, k2=4, repeats=3)
    assert np.isfinite(t) and len(seen) == 2 + 3 * (2 + 4)
    # within one chain every call after the first takes the previous call's mix
    assert seen[0] is images and seen[1] is not images and seen[2] is images
