"""Collective census of one sharded train step (``tools/probe_multichip_hlo.py``).

The JAX tool compiles ``dryrun_multichip``'s step and counts the
collectives GSPMD put into its HLO. PyTorch has no HLO: the port's step
makes its collectives itself, every one through
``parallel/collectives.py`` (``all_reduce_``, ``all_gather``,
``broadcast_``). So this tool counts those calls in each rank over one
``make_train_step(cfg, mesh)`` step, after one warm-up step (which also
broadcasts the state from rank 0), on a ``data x tile`` mesh of
``n_devices`` ranks (``tools/_ranks.py``: NCCL, one a card, on CUDA; gloo
on the CPU):

* by kind: all-reduce, all-gather, broadcast;
* by caller: the gradient all-reduce (``train/loop._all_reduce_mean``),
  BatchNorm statistics (``models/layers._GlobalBatchNorm``, forward and
  backward), loss reductions (``ops/losses.py``, ``train/losses.py``,
  ``ops/planes.py``, and the backward of their group sums), row fetches
  (``parallel/sharding.fetch_rows``, forward and backward), and ``other``,
  itemised by file and function;
* with the bytes each rank hands to the collective (an all-gather's is
  this rank's part) and how many cross through host memory
  (``collectives._via_host``: a CUDA tensor on a gloo group).

Config as in the JAX tool: ``Config()`` with 16 planes, k = 5, batch = the
data axis (``--batch``), the normal losses on, 32x64 images (the least
height the port's row plan splits over the tile axis where that is more:
64 at tile 2). ``--height``, ``--width`` and dotted overrides reach other
configurations (``chip_smoke.py`` phase 10's: 64 planes, k = 9). Prints
``mesh={...} collectives: {...}`` (rank 0's counts by kind) as JAX does,
then one JSON line per rank.

    python -m cnmnet_tpu_torch.tools.probe_multichip_hlo [n_devices] [tile]
        [--batch B] [--height H --width W] [--device cuda] [dotted.overrides=...]
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter, defaultdict
from pathlib import PurePath

KINDS = {"all_reduce_": "all-reduce", "all_gather": "all-gather", "broadcast_": "broadcast"}

# (file under cnmnet_tpu_torch/, function's qualified name) -> caller
CALLERS = {
    ("train/loop.py", "_all_reduce_mean"): "gradients",
    ("train/loop.py", "_broadcast_state"): "state_broadcast",
    ("models/layers.py", "_GlobalBatchNorm.forward"): "batch_norm",
    ("models/layers.py", "_GlobalBatchNorm.backward"): "batch_norm",
    ("parallel/sharding.py", "_RowFetch.forward"): "row_fetch",
    ("parallel/sharding.py", "_RowFetch.backward"): "row_fetch",
}
LOSS_FILES = ("ops/losses.py", "train/losses.py", "ops/planes.py")
GROUP_SUM = ("parallel/collectives.py", "_GroupSum")


def _where(code):
    """``(path under cnmnet_tpu_torch/ or None, qualified name)``."""
    parts = PurePath(code.co_filename).parts
    if "cnmnet_tpu_torch" not in parts:
        return None, code.co_qualname
    i = len(parts) - 1 - parts[::-1].index("cnmnet_tpu_torch")
    return "/".join(parts[i + 1:]), code.co_qualname


def caller_of(frame):
    """``(caller, site)`` of a collective called from ``frame``: the first
    frame outward that ``CALLERS`` or ``LOSS_FILES`` name. A group sum's
    backward runs under the autograd engine, out of its caller's stack:
    its forward leaves the caller on its ``ctx``, which the backward reads."""
    ctx, f, first = None, frame, None
    while f is not None:
        path, name = _where(f.f_code)
        if first is None and path not in (None, GROUP_SUM[0]):
            first = f"{path}:{name}"
        if (path, name) == (GROUP_SUM[0], f"{GROUP_SUM[1]}.backward"):
            return getattr(f.f_locals["ctx"], "census_caller", ("other", f"{path}:{name}"))
        if (path, name) == (GROUP_SUM[0], f"{GROUP_SUM[1]}.forward"):
            ctx = f.f_locals["ctx"]
        caller = CALLERS.get((path, name)) or ("loss" if path in LOSS_FILES else None)
        if caller is not None:
            found = (caller, f"{path}:{name}")
            if ctx is not None:
                ctx.census_caller = found
            return found
        f = f.f_back
    return "other", first or "outside the port"


class Census:
    """For the span of a ``with``: every call of ``collectives``'
    ``all_reduce_``, ``all_gather`` and ``broadcast_`` in this process,
    counted by kind and by caller with its bytes and whether it crossed
    through host memory. The three functions are replaced in
    ``collectives`` and in every port module that imported them by name,
    and restored on exit."""

    def __init__(self):
        self.calls = []  # (kind, caller, site, bytes, via_host)
        self._patched = []

    def _wrap(self, name, fn):
        from cnmnet_tpu_torch.parallel import collectives

        def counted(x, *args, **kwargs):
            group = kwargs.get("group", args[-1] if args else None)
            caller, site = caller_of(sys._getframe(1))
            self.calls.append((KINDS[name], caller, site, x.numel() * x.element_size(),
                               collectives._via_host(x, group)))
            return fn(x, *args, **kwargs)

        return counted

    def __enter__(self):
        from cnmnet_tpu_torch.parallel import collectives

        for name in KINDS:
            fn = getattr(collectives, name)
            counted = self._wrap(name, fn)
            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").startswith("cnmnet_tpu_torch")
                        and getattr(mod, name, None) is fn):
                    self._patched.append((mod, name, fn))
                    setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._patched):
            setattr(mod, name, fn)
        self._patched.clear()

    def summary(self) -> dict:
        """``{"calls", "bytes", "via_host", "by_kind": {kind: {calls, bytes,
        via_host}}, "by_caller": {caller: {calls, bytes, by_kind}},
        "other_sites": {site: calls}}``."""
        by_kind = defaultdict(Counter)
        by_caller = defaultdict(lambda: {"calls": 0, "bytes": 0, "by_kind": Counter()})
        other = Counter()
        for kind, caller, site, nbytes, host in self.calls:
            by_kind[kind].update(calls=1, bytes=nbytes, via_host=int(host))
            c = by_caller[caller]
            c["calls"] += 1
            c["bytes"] += nbytes
            c["by_kind"][kind] += 1
            if caller == "other":
                other[site] += 1
        return {"calls": len(self.calls), "bytes": sum(c[3] for c in self.calls),
                "via_host": sum(int(c[4]) for c in self.calls),
                "by_kind": {k: dict(v) for k, v in sorted(by_kind.items())},
                "by_caller": {k: {**v, "by_kind": dict(v["by_kind"])}
                              for k, v in sorted(by_caller.items())},
                "other_sites": dict(other)}


def probe_config(batch: int, height: int, width: int, overrides=()):
    from cnmnet_tpu_torch.config import Config, apply_overrides

    cfg = Config()
    cfg.model.num_planes = 16
    cfg.model.k_size = 5
    cfg.dataset.batch_size = batch
    cfg.dataset.image_height, cfg.dataset.image_width = height, width
    cfg.train.use_normal_loss = True
    return apply_overrides(cfg, list(overrides))


def probe_rank(device, tile: int, batch, height, width: int, overrides=()) -> dict:
    """One rank: a warm-up step, then the census of one step."""
    import torch.distributed as dist

    from cnmnet_tpu_torch.kernels.dispatch import launch_counts
    from cnmnet_tpu_torch.parallel.mesh import least_height, make_mesh
    from cnmnet_tpu_torch.parallel.sharding import shard_batch
    from cnmnet_tpu_torch.tools._batch import tiny_batch
    from cnmnet_tpu_torch.train.loop import make_train_step
    from cnmnet_tpu_torch.train.state import create_train_state

    mesh = make_mesh(data=dist.get_world_size() // tile, tile=tile)
    batch = batch or mesh.data
    height = height or least_height(tile)
    cfg = probe_config(batch, height, width, overrides)
    local = shard_batch(mesh, tiny_batch(batch, height, width, device=device))
    state = create_train_state(cfg, 0, device)
    step = make_train_step(cfg, mesh)
    state, metrics = step(state, local)
    float(metrics["loss"])
    before = launch_counts()
    with Census() as census:
        state, metrics = step(state, local)
        loss = float(metrics["loss"])
    return {"rank": dist.get_rank(), "mesh": mesh.shape, "batch": batch, "height": height,
            "width": width, "backend": dist.get_backend(), "loss": loss,
            "params": sum(p.numel() for p in state.model.parameters()),
            "launches": {k: v - before[k] for k, v in launch_counts().items()},
            **census.summary()}


def main(argv=None) -> int:
    from cnmnet_tpu_torch.tools import _ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("tile", nargs="?", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None, help="global batch (default: data axis)")
    ap.add_argument("--height", type=int, default=None,
                    help="default: 32, or the least height the row plan splits over the tile")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)
    if args.n_devices % args.tile:
        raise ValueError(f"tile {args.tile} does not divide {args.n_devices} devices")
    ranks = _ranks.run(args.n_devices, probe_rank, args.tile, args.batch, args.height,
                       args.width, args.overrides, device=args.device)
    lead = ranks[0]
    print(f"mesh={lead['mesh']} collectives: "
          f"{ {k: v['calls'] for k, v in lead['by_kind'].items()} }")
    for r in ranks:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
