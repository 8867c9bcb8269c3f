"""Import trained weights into a port checkpoint.

    python -m cnmnet_tpu_torch.train.import_checkpoint --npz state.npz --out checkpoints
    python -m cnmnet_tpu_torch.train.import_checkpoint --torch-ckpt model.pt --out checkpoints \\
        [--idepth-scale 3.0]

Either source becomes one step of ``train/checkpoint.CheckpointManager``
under ``--out``, so every consumer of port checkpoints takes it as it is:
``cli eval|eval-scannet|infer --checkpoint``, ``train.resume_dir`` and
``InferenceSession(checkpoint=)``. The model is the one of ``--config`` and
the dotted overrides, as for the CLI.

* ``--npz``: a JAX training checkpoint converted by
  ``tools/orbax_to_npz.py`` (run where JAX is installed). Parameters and
  BatchNorm statistics go through ``models/transplant.load_flax_variables``;
  the moments ``opt_state/<moment>/<flax path>`` map onto the port
  optimizer's (``train/state.py:MOMENTS``) through the same key map (HWIO
  kernels to OIHW), with the optimizer's count set to the step. The file's
  moments must be those of ``solver.method``.
* ``--torch-ckpt``: the reference's checkpoint, ``{depth_network_state_dict,
  depth_refine_network_state_dict}`` (``train.py:402-410``), read with
  ``torch.load(weights_only=True)``. ``reference_to_flax`` lays its
  Sequential names out as the JAX package's importer does
  (``tools/import_torch_checkpoint.py``), through the layout that
  ``models/transplant.py`` keeps of it: DataParallel's ``module.``
  stripped, OIHW kernels to HWIO, BatchNorm ``weight/bias`` to
  ``scale/bias`` and its running statistics to ``mean/var``; the tree then
  goes through ``load_flax_variables``. The moments start at zero, the step
  is the checkpoint's ``global_step``.

``--idepth-scale`` sets ``model.idepth_scale``, as the JAX importer's flag
does; a checkpoint does not record it, so serve with the same value.

Nothing is skipped: a tree that does not match the model raises, as does a
reference tensor that no layer takes (BatchNorm's ``num_batches_tracked``
counters, which no layer of either package keeps, excepted).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from cnmnet_tpu_torch.config import Config, apply_overrides, load_config
from cnmnet_tpu_torch.models.transplant import (
    conv_norm_units,
    head_units,
    key_map,
    load_flax_variables,
)
from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
from cnmnet_tpu_torch.train.state import MOMENTS, TrainState, build_model, make_optimizer

def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def reference_to_flax(ckpt: Mapping) -> Dict[str, np.ndarray]:
    """The reference checkpoint as flat flax keys (``params/...`` and
    ``batch_stats/...``, the JAX package's layout); raises on a missing
    tensor or one that no layer takes. The reference's Sequential names are
    the port's module names without their ``depth_net.`` / ``refine_net.``
    prefix, so ``models/transplant``'s layout maps both."""
    nets = {"depth_net": ckpt["depth_network_state_dict"]}
    if "depth_refine_network_state_dict" in ckpt:
        nets["refine_net"] = ckpt["depth_refine_network_state_dict"]
    nets = {net: {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
            for net, sd in nets.items()}
    used = {net: set() for net in nets}

    def take(port_key):
        net, _, key = port_key.partition(".")
        if key not in nets[net]:
            raise KeyError(f"{net}: reference tensor {key!r} is missing")
        used[net].add(key)
        return _numpy(nets[net][key])

    flat: Dict[str, np.ndarray] = {}
    for fpath, prefix, ci, bi in conv_norm_units("refine_net" in nets):
        flat[f"params/{fpath}/Conv_0/kernel"] = np.transpose(take(f"{prefix}.{ci}.weight"),
                                                             (2, 3, 1, 0))  # OIHW -> HWIO
        flat[f"params/{fpath}/BatchNorm_0/scale"] = take(f"{prefix}.{bi}.weight")
        flat[f"params/{fpath}/BatchNorm_0/bias"] = take(f"{prefix}.{bi}.bias")
        flat[f"batch_stats/{fpath}/BatchNorm_0/mean"] = take(f"{prefix}.{bi}.running_mean")
        flat[f"batch_stats/{fpath}/BatchNorm_0/var"] = take(f"{prefix}.{bi}.running_var")
        net, _, key = prefix.partition(".")
        used[net].add(f"{key}.{bi}.num_batches_tracked")
    for fpath, prefix in head_units("refine_net" in nets):
        flat[f"params/{fpath}/Conv_0/kernel"] = np.transpose(take(f"{prefix}.0.weight"),
                                                             (2, 3, 1, 0))
        flat[f"params/{fpath}/Conv_0/bias"] = take(f"{prefix}.0.bias")
    for net, sd in nets.items():
        left = sorted(set(sd) - used[net])
        if left:
            raise KeyError(f"{net}: reference tensors that no layer takes: {left}")
    return flat


def unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def moments_from_flax(model, flat: Mapping[str, np.ndarray], method: str) -> Dict:
    """The port optimizer's moments (``{moment: {parameter name: tensor}}``)
    from ``opt_state/<moment>/<flax path>`` keys; raises unless they are
    exactly ``method``'s moments over every parameter."""
    params = {f[len("params/"):]: t for f, t in key_map(model).items() if f.startswith("params/")}
    names = dict(model.named_parameters())
    found = sorted({k.split("/")[1] for k in flat if k.startswith("opt_state/")})
    if found != sorted(MOMENTS[method]):
        raise KeyError(f"the file holds moments {found}, solver.method={method!r} "
                       f"takes {sorted(MOMENTS[method])}")
    out = {}
    for m in MOMENTS[method]:
        prefix = f"opt_state/{m}/"
        keys = {k[len(prefix):] for k in flat if k.startswith(prefix)}
        if keys != set(params):
            raise KeyError(f"moment {m!r} does not match the model's parameters: unused "
                           f"{sorted(keys - set(params))}, missing {sorted(set(params) - keys)}")
        out[m] = {}
        for fpath, (tkey, transform) in params.items():
            value = torch.from_numpy(np.array(transform(flat[prefix + fpath]), np.float32))
            if value.shape != names[tkey].shape:
                raise ValueError(f"{prefix + fpath} -> {tkey}: shape {tuple(value.shape)} "
                                 f"vs {tuple(names[tkey].shape)}")
            out[m][tkey] = value
    return out


def import_npz(cfg: Config, path: str) -> TrainState:
    """A train state from a ``tools/orbax_to_npz.py`` file."""
    with np.load(path) as z:
        return state_from_arrays(cfg, {k: z[k] for k in z.files})


def state_from_arrays(cfg: Config, flat: Mapping[str, np.ndarray]) -> TrainState:
    """A train state from the converter's arrays (the ``.npz``'s keys)."""
    model = build_model(cfg)
    load_flax_variables(model, unflatten({k: v for k, v in flat.items()
                                          if k.startswith(("params/", "batch_stats/"))}))
    step = int(flat["step"])
    opt_state = {"count": step, **moments_from_flax(model, flat, cfg.solver.method.lower())}
    return TrainState(model=model, opt_state=opt_state, step=step, epoch=int(flat["epoch"]))


def import_reference(cfg: Config, path: str) -> TrainState:
    """A train state from the reference's ``.pt``: its weights and
    statistics, zero moments, its ``global_step``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model = build_model(cfg)
    load_flax_variables(model, unflatten(reference_to_flax(ckpt)))
    opt_state = make_optimizer(cfg).init(dict(model.named_parameters()))
    return TrainState(model=model, opt_state=opt_state, step=int(ckpt.get("global_step", 0)))


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(prog="cnmnet_tpu_torch.train.import_checkpoint",
                                description="write a port checkpoint step from trained weights")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--npz", help="a JAX checkpoint converted by tools/orbax_to_npz.py")
    src.add_argument("--torch-ckpt", help="the reference's checkpoint (.pt)")
    p.add_argument("--out", required=True, help="checkpoint directory (a manager root)")
    p.add_argument("--idepth-scale", type=float, default=None,
                   help="model.idepth_scale (the config's, 3.0, unless given)")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    if args.overrides:
        apply_overrides(cfg, list(args.overrides))
    if args.idepth_scale is not None:
        cfg.model.idepth_scale = args.idepth_scale
    state = import_reference(cfg, args.torch_ckpt) if args.torch_ckpt else import_npz(cfg, args.npz)
    step = CheckpointManager(args.out, device="cpu").save(state)
    print(f"imported {args.npz or args.torch_ckpt} -> {args.out} (step {step})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
