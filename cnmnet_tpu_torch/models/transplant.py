"""Carry the JAX package's weights over: flax variables -> the port's state_dict.

``load_flax_variables(model, variables)`` takes a ``{"params",
"batch_stats"}`` tree of ``cnmnet_tpu.models.CNMModel`` (numpy arrays or
anything ``np.asarray`` reads) and fills every parameter and buffer of a
:class:`~cnmnet_tpu_torch.models.CNMModel`:

* conv kernels HWIO -> weights OIHW, the disparity heads' biases as they are;
* BatchNorm ``scale/bias`` -> ``weight/bias``, ``batch_stats`` ``mean/var``
  -> ``running_mean/running_var``; GroupNorm ``scale/bias`` -> ``weight/bias``.

The flax module paths are the inverse of the layouts in
``tools/import_torch_checkpoint.py`` (kept here as the port's own copy).
Any flax leaf left unused, any port tensor left unfilled (apart from the
BatchNorm ``num_batches_tracked`` counters, which flax has no counterpart
of) and any shape mismatch raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_DEPTH_UPS = ("upconv5", "upconv4", "upconv3", "upconv2", "upconv1")
_DEPTH_ICS = ("iconv5", "iconv4", "iconv3", "iconv2", "iconv1")
_DEPTH_HEADS = (("DispHead_0", "disp4"), ("DispHead_1", "disp3"),
                ("DispHead_2", "disp2"), ("DispHead_3", "disp1"))
_REFINE_HEADS = (("depth_branch/DispHead_0", "disp_refine"),
                 ("prob_branch/DispHead_0", "prob"))


def _units(use_refiner: bool):
    """(flax path, port prefix, conv index, norm index) for every conv+norm."""
    units = []
    for i in range(5):
        for j, (ci, ni) in enumerate(((0, 1), (3, 4))):
            units.append((f"depth_net/DownConvBlock_{i}/ConvNormAct_{j}",
                          f"depth_net.conv{i + 1}", ci, ni))
    for k in range(5):
        units.append((f"depth_net/UpConvBlock_{k}/ConvNormAct_0",
                      f"depth_net.{_DEPTH_UPS[k]}", 1, 2))
        units.append((f"depth_net/ConvNormAct_{k}", f"depth_net.{_DEPTH_ICS[k]}", 0, 1))
    if use_refiner:
        for i in range(3):
            for j, (ci, ni) in enumerate(((0, 1), (3, 4))):
                units.append((f"refine_net/DownConvBlock_{i}/ConvNormAct_{j}",
                              f"refine_net.conv{i + 1}", ci, ni))
        for branch, tag in (("depth_branch", "depth"), ("prob_branch", "prob")):
            for k, lvl in enumerate((3, 2, 1)):
                units.append((f"refine_net/{branch}/UpConvBlock_{k}/ConvNormAct_0",
                              f"refine_net.upconv{lvl}_{tag}", 1, 2))
                units.append((f"refine_net/{branch}/ConvNormAct_{k}",
                              f"refine_net.iconv{lvl}_{tag}", 0, 1))
    return units


def _heads(use_refiner: bool):
    heads = [(f"depth_net/{f}", f"depth_net.{t}") for f, t in _DEPTH_HEADS]
    if use_refiner:
        heads += [(f"refine_net/{f}", f"refine_net.{t}") for f, t in _REFINE_HEADS]
    return heads


def _conv(kernel: np.ndarray) -> np.ndarray:
    return np.transpose(kernel, (3, 2, 0, 1))  # HWIO -> OIHW


def _same(x: np.ndarray) -> np.ndarray:
    return x


def key_map(model: nn.Module):
    """``{flax key: (port key, transform)}`` for ``model``; flax keys are
    ``"params/..."`` or ``"batch_stats/..."`` paths."""
    use_refiner = getattr(model, "refine_net", None) is not None
    out = {}
    for fpath, tpre, ci, ni in _units(use_refiner):
        out[f"params/{fpath}/Conv_0/kernel"] = (f"{tpre}.{ci}.weight", _conv)
        if isinstance(model.get_submodule(f"{tpre}.{ni}"), nn.BatchNorm2d):
            norm = "BatchNorm_0"
            out[f"batch_stats/{fpath}/{norm}/mean"] = (f"{tpre}.{ni}.running_mean", _same)
            out[f"batch_stats/{fpath}/{norm}/var"] = (f"{tpre}.{ni}.running_var", _same)
        else:
            norm = "GroupNorm_0"
        out[f"params/{fpath}/{norm}/scale"] = (f"{tpre}.{ni}.weight", _same)
        out[f"params/{fpath}/{norm}/bias"] = (f"{tpre}.{ni}.bias", _same)
    for fpath, tpre in _heads(use_refiner):
        out[f"params/{fpath}/Conv_0/kernel"] = (f"{tpre}.0.weight", _conv)
        out[f"params/{fpath}/Conv_0/bias"] = (f"{tpre}.0.bias", _same)
    return out


def flatten(tree: Mapping, prefix: str = "") -> dict:
    """Nested mapping -> ``{"a/b/c": np.ndarray}``."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill ``model``'s parameters and buffers from a flax variables tree."""
    flat = flatten({k: variables[k] for k in ("params", "batch_stats") if k in variables})
    mapping = key_map(model)
    extra = sorted(set(flat) - set(mapping))
    missing = sorted(set(mapping) - set(flat))
    if extra or missing:
        raise KeyError(f"flax tree does not match the model: unused {extra}, missing {missing}")
    current = model.state_dict()
    new = {}
    for fkey, (tkey, transform) in mapping.items():
        value = torch.from_numpy(np.array(transform(flat[fkey])))  # a writable copy
        if tuple(value.shape) != tuple(current[tkey].shape):
            raise ValueError(f"{fkey} -> {tkey}: shape {tuple(value.shape)} "
                             f"vs {tuple(current[tkey].shape)}")
        new[tkey] = value
    unfilled = sorted(k for k in set(current) - set(new) if not k.endswith("num_batches_tracked"))
    if unfilled:
        raise KeyError(f"model tensors left unfilled: {unfilled}")
    for k in set(current) - set(new):
        new[k] = current[k]
    model.load_state_dict(new, strict=True)
