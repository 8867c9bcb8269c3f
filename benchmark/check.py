"""The comparison that decides ``correct``.

What the timed path produced for a sample of its answers is held against
the plain reference (``reference/model.py``) run on the same inputs and
the same weights, in float32 with TF32 off, on the run's device, in blocks
of frames, after the window has closed and the program's state is freed.

The numbers compared, each the worst frame of the sample:

* ``idepth_gap``: the 99th percentile over the frame's pixels of ``|idepth
  - ref|``, the refined inverse depth's difference, over that of ``|stated
  - ref|``, where ``ref`` is the reference in
  float32 and ``stated`` the reference computed in the precision the
  configuration states (``stated``: its convolutions' operands rounded to
  bfloat16 or TF32). So it reads about 1 for a program that rounds as the
  configuration says, whatever the seed's weights make of rounding, and
  several times that one precision lower. The percentile, and not the L2
  norm, because a random net turns rounding into error nonlinearly in a few
  pixels on some seeds, which pulls the two readings together (``PERF.md``).
  It covers the cost volume, DepthNet and the RefineNet.
* ``idepth_max_gap``: the same with the largest difference of the frame in
  place of the 99th percentile: a fault confined to fewer than a hundredth
  of the pixels (a border row or column, a tile, an edge) hides under the
  percentile and not under the maximum.
* ``prob_gap``, ``prob_max_gap``: the same two of the occlusion probability.
* ``normal_deg``: the mean angle in degrees between the program's normals
  and the reference's float32 fit of the program's own depth (``1 /
  (idepth + 1e-8)``): depth -> normal alone. The fit is ill-conditioned,
  so the normals of two depths a rounding apart can differ by degrees;
  given the same depth, they agree. A window with no valid depth has the
  normal 0 on both sides, and two zero normals agree (0 degrees); a zero
  normal against one that is not reads 90.
* ``normal_max_deg``: the largest angle of the frame.

A cell compares the numbers its ``limits/<cell>.json`` names, each against
its limit there; ``PERF.md`` gives the readings each was set from. The
control (``calibrate.py``) is the reference in the program's place one step
below each stated precision.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from benchmark.reference import model as reference

NUMBERS = ("idepth_gap", "idepth_max_gap", "prob_gap", "prob_max_gap", "normal_deg",
           "normal_max_deg")
OUTPUT = {"idepth_gap": "idepth", "idepth_max_gap": "idepth", "prob_gap": "prob",
          "prob_max_gap": "prob", "normal_deg": "normal", "normal_max_deg": "normal"}
BLOCK = 8


def _blocks(check: dict, device, fn) -> Dict[str, np.ndarray]:
    """``fn(state, images, cams, i)`` over blocks of ``BLOCK`` checked frames
    on ``device``, TF32 off, outputs concatenated as host arrays."""
    state = check["state"]
    out: Dict[str, list] = {}
    with reference.exact_float32():
        for i in range(0, len(check["images"]), BLOCK):
            o = fn(state, torch.from_numpy(check["images"][i:i + BLOCK]).to(device),
                   torch.from_numpy(check["cams"][i:i + BLOCK]).to(device), i)
            for k, v in o.items():
                out.setdefault(k, []).append(v.cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def _device(check):
    """The run's device: that of the weights."""
    return next(iter(check["state"].values())).device


def reference_outputs(check: dict, config: dict, precision: Optional[str] = None,
                      fit_dtype=torch.float32) -> Dict[str, np.ndarray]:
    """The reference's outputs for the checked inputs; ``precision`` and
    ``fit_dtype`` as ``reference.forward`` takes them."""
    return _blocks(check, _device(check),
                   lambda sd, images, cams, i: reference.forward(
                       sd, images, cams, config["model"], precision, fit_dtype))


def fitted_normals(check: dict, config: dict, idepth: np.ndarray) -> np.ndarray:
    """The reference's float32 normals of the depth ``1 / (idepth + 1e-8)``."""
    dev = _device(check)
    k = int(config["model"]["k_size"])
    return _blocks(check, dev, lambda sd, images, cams, i: {"normal": reference.normals(
        torch.from_numpy(np.ascontiguousarray(idepth[i:i + BLOCK])).to(dev), cams, k)})["normal"]


def _frames(x: np.ndarray) -> np.ndarray:
    return x.reshape(len(x), -1).astype(np.float64)


def _p99(d: np.ndarray) -> np.ndarray:
    return np.percentile(np.abs(d), 99, axis=1)


def _max(d: np.ndarray) -> np.ndarray:
    return np.abs(d).max(axis=1)


def _gap(got: np.ndarray, ref: np.ndarray, stated: np.ndarray, stat=_p99) -> float:
    num = stat(_frames(got) - _frames(ref))
    den = stat(_frames(stated) - _frames(ref))
    return float((num / np.maximum(den, 1e-30)).max())


def angles_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The angle in degrees between the normals ``[N, H, W, 3]`` of ``a`` and
    ``b``, pixel by pixel, ``[N, H x W]``: 0 where both are zero, 90 where
    one is."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    cos = (a * b).sum(-1) / np.maximum(na * nb, 1e-300)
    deg = np.where((na == 0) & (nb == 0), 0.0, np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return deg.reshape(len(deg), -1)


def numbers(check: dict, config: dict, outputs: Dict[str, np.ndarray],
            ref: Dict[str, np.ndarray], stated: Dict[str, np.ndarray],
            names=NUMBERS) -> Dict[str, float]:
    """``names`` of ``NUMBERS`` for ``outputs`` of the checked frames; an
    output that is missing, of another shape or not finite reads infinite."""
    out, angles = {}, None
    for name in names:
        key = OUTPUT[name]
        got = outputs.get(key)
        if got is None or got.shape != ref[key].shape or not np.isfinite(got).all():
            out[name] = float("inf")
        elif key == "normal":
            if not np.isfinite(outputs["idepth"]).all():
                out[name] = float("inf")
                continue
            if angles is None:
                angles = angles_deg(got, fitted_normals(check, config, outputs["idepth"]))
            out[name] = float(angles.max() if name == "normal_max_deg" else angles.mean(1).max())
        else:
            out[name] = _gap(got, ref[key], stated[key], _max if "_max_" in name else _p99)
    return {k: v if np.isfinite(v) else float("inf") for k, v in out.items()}


def judge(check: dict, config: dict, limits: Dict[str, float]):
    """``(correct, {name: {"value", "limit"}})`` for the checked sample, the
    numbers being those ``limits`` names; no sample at all is not correct."""
    if not len(check["images"]):
        return False, {name: {"value": None, "limit": limit} for name, limit in limits.items()}
    ref = reference_outputs(check, config)
    stated = reference_outputs(check, config, config["stated"])
    readings = numbers(check, config, check["outputs"], ref, stated, tuple(limits))
    checks = {name: {"value": readings[name], "limit": limits[name]} for name in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
