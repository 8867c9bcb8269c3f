"""Convert a JAX training checkpoint (orbax) into one ``.npz`` for the
PyTorch port.

Runs where JAX is installed, never on the card's machine: it restores a
``cnmnet_tpu.train.checkpoint.CheckpointManager`` checkpoint into the
structure of ``create_train_state`` under ``--config`` and the dotted
overrides (which must describe the model that was trained), and writes

  params/<flax path>               parameters (flax layout, HWIO kernels)
  batch_stats/<flax path>          BatchNorm running statistics
  opt_state/<moment>/<flax path>   the optimizer's moments
  step, epoch                      the counters

The moments are found by the type of their optax state, not by their
index in the chain (which shifts with ``grad_clip_norm`` and
``weight_decay``): Adam's ``mu`` and ``nu``, SGD's ``trace``, RMSprop's
``nu``, Adadelta's ``e_g`` and ``e_x``, the names the port's optimizer
uses (``cnmnet_tpu_torch/train/state.py:MOMENTS``). The port reads the file
with ``python -m cnmnet_tpu_torch.train.import_checkpoint --npz``.

The checkpoint takes the three forms of the JAX manager's ``restore``: a
manager root (its newest step, or ``--step N``), a step directory
``<root>/<step>``, or a directory written by ``StandardCheckpointer``.

Usage:
  python tools/orbax_to_npz.py --checkpoint checkpoints --out state.npz \
      [--step N] [--config cfg.yaml] [model.num_planes=64 ...]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# optax state type -> the moments it holds, by the port's names
MOMENT_FIELDS = {
    "ScaleByAdamState": ("mu", "nu"),
    "TraceState": ("trace",),
    "ScaleByRmsState": ("nu",),
    "ScaleByAdaDeltaState": ("e_g", "e_x"),
}


def template_state(cfg):
    """The shapes and dtypes of ``create_train_state`` of ``cfg`` on one
    synthetic batch (``jax.eval_shape``: nothing is computed): the tree
    that the checkpoint restores into."""
    import jax

    from cnmnet_tpu.data.pipeline import collate
    from cnmnet_tpu.data.synthetic import SyntheticScenes
    from cnmnet_tpu.train.state import create_train_state

    ds = SyntheticScenes(num_samples=1, height=cfg.dataset.image_height,
                         width=cfg.dataset.image_width, view_num=cfg.dataset.view_num)
    batch = collate([{k: v for k, v in ds[0].items() if k != "index"}])
    return jax.eval_shape(lambda: create_train_state(cfg, jax.random.PRNGKey(0), batch))


def restore(path: str, template, step=None):
    """The checkpoint at ``path`` (manager root, step directory or
    standard checkpoint) restored into ``template``'s structure."""
    from cnmnet_tpu.train.checkpoint import CheckpointManager

    path = os.path.abspath(path)
    if step is not None:
        return CheckpointManager(path).restore(int(step), template)
    is_root = os.path.isdir(path) and any(d.isdigit() for d in os.listdir(path))
    mgr = CheckpointManager(path if is_root else os.path.dirname(path))
    return mgr.restore(path, template)


def find_moments(opt_state) -> dict:
    """``{moment: tree}`` from the optax states in ``opt_state``, by type."""
    found = {}

    def walk(node):
        fields = MOMENT_FIELDS.get(type(node).__name__)
        if fields is not None:
            for f in fields:
                if f in found:
                    raise ValueError(f"two optimizer states hold a moment {f!r}")
                found[f] = getattr(node, f)
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)
        elif isinstance(node, dict):
            for child in node.values():
                walk(child)

    walk(opt_state)
    return found


def flatten(tree, prefix: str) -> dict:
    """Nested mapping -> ``{"prefix/a/b": np.ndarray}``."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if hasattr(v, "items"):
            out.update(flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def state_to_arrays(state) -> dict:
    arrays = {**flatten(state.params, "params"), **flatten(state.batch_stats, "batch_stats")}
    for name, tree in find_moments(state.opt_state).items():
        arrays.update(flatten(tree, f"opt_state/{name}"))
    arrays["step"] = np.asarray(int(state.step), np.int64)
    arrays["epoch"] = np.asarray(int(state.epoch), np.int64)
    return arrays


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="manager root, step directory or standard checkpoint directory")
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--step", type=int, default=None, help="a step of the manager root")
    p.add_argument("--config", default=None)
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from cnmnet_tpu.config import apply_overrides, load_config

    cfg = load_config(args.config)
    if args.overrides:
        apply_overrides(cfg, list(args.overrides))
    state = restore(args.checkpoint, template_state(cfg), args.step)
    arrays = state_to_arrays(state)
    np.savez(args.out, **arrays)
    moments = sorted({k.split("/")[1] for k in arrays if k.startswith("opt_state/")})
    print(f"wrote {len(arrays)} arrays to {args.out} (step {int(arrays['step'])}, "
          f"moments {moments})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
