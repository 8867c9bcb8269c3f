"""Train state and optimizer (``cnmnet_tpu/train/state.py``).

The optimizer is the JAX package's optax chain written as plain functions
on tensors, step for step, rather than ``torch.optim``, whose semantics
differ in ways that move a parameter:

* ``clip_by_global_norm``: ``g`` where ``norm < max_norm``, else
  ``g / norm * max_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm);
* ``add_decayed_weights_active``: torch-style L2 decay ``g + wd * p``
  added *before* the moments, and only to a tensor whose gradient has a
  nonzero element (a module left out of the forward stays bit-identical);
* the method: ``adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias
  corrections ``1 - b^t`` in f32), ``sgd`` (momentum 0.9, ``g + 0.9 t``),
  ``rmsprop`` (decay 0.9, eps 1e-8 inside the square root, no centring) or
  ``adadelta`` (rho 0.9, eps 1e-6);
* the step ``-lr * u``, with ``lr`` ramped by ``linear_schedule(0, lr,
  warmup)`` when ``warmup_steps`` is set: 0 at step 0.

A parameter without a gradient takes a zero gradient, as optax's zeros do:
its moments still decay. The learning rate and bias corrections are
computed on the host in float32 from the step count, so the update waits
on nothing.

``build_model(cfg)`` checks the model options as the JAX ``build_model``
and its layers do:

* ``model.remat=true`` with ``remat_stages`` outside -1 and 1-5 raises
  ``ValueError`` (``_remat_stages``; -1 means all five stages);
* a ``model.stride2`` other than ``conv``, ``s2d`` or ``psg`` raises
  ``KeyError``, as the JAX layers do when they build a stride-2 conv. All
  three build the plain strided conv here: ``s2d`` and ``psg`` are TPU
  lowerings of the same conv with the same parameters and outputs
  (RESULTS.md, "backward-conv lever").

One check is stricter on purpose: a ``model.norm`` other than ``batch`` or
``group`` raises ``ValueError`` (``models/layers.py:_norm``), where the JAX
layers take any value but ``batch`` as GroupNorm.

Training in bf16 (``model.compute_dtype="bfloat16"``) is flax's
``dtype=bfloat16``: the parameters, the optimizer's moments and the norm
layers' statistics stay f32, and every conv casts its input and weight to
bf16 at use (``layers.set_compute_dtype``). ``models/cnm.py``'s
``cast_for_compute`` casts the weights themselves and is for serving.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from cnmnet_tpu_torch.config import Config, SolverConfig
from cnmnet_tpu_torch.models.cnm import CNMModel
from cnmnet_tpu_torch.models.layers import init_weights, set_compute_dtype
from cnmnet_tpu_torch.models.transplant import load_flax_variables
from cnmnet_tpu_torch.serve import resolve_device

STRIDE2 = ("conv", "s2d", "psg")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Tensors = List[torch.Tensor]

# Per-parameter state of each method, by name.
MOMENTS = {"adam": ("mu", "nu"), "sgd": ("trace",), "rmsprop": ("nu",),
           "adadelta": ("e_g", "e_x")}


def _f32(x) -> float:
    """A Python float holding ``x`` rounded to float32."""
    return float(np.float32(x))


def _decayed(g: Tensors, moments: Tensors, decay: float) -> Tensors:
    """``(1 - decay) * g + decay * t`` (optax's ``update_moment``, order 1)."""
    return [(1.0 - decay) * x + decay * t for x, t in zip(g, moments)]


def _decayed_sq(g: Tensors, moments: Tensors, decay: float) -> Tensors:
    """``(1 - decay) * g^2 + decay * t`` (order 2)."""
    return [(1.0 - decay) * (x * x) + decay * t for x, t in zip(g, moments)]


def global_norm(g: Tensors) -> torch.Tensor:
    """``sqrt(sum of every tensor's sum of squares)``."""
    return torch.sqrt(sum((x * x).sum() for x in g))


def clip_by_global_norm(g: Tensors, max_norm: float) -> Tensors:
    norm = global_norm(g)
    keep = norm < max_norm
    return [torch.where(keep, x, x / norm * max_norm) for x in g]


def add_decayed_weights_active(g: Tensors, params: Tensors, weight_decay: float) -> Tensors:
    """``g + wd * active * p`` with ``active`` = any element of ``g`` nonzero."""
    return [x + weight_decay * (x != 0).any().to(p.dtype) * p for x, p in zip(g, params)]


def _adam(g, state, count, b1=0.9, b2=0.999, eps=1e-8):
    mu = _decayed(g, state["mu"], b1)
    nu = _decayed_sq(g, state["nu"], b2)
    c1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(count + 1))
    c2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(count + 1))
    updates = [(m / c1) / (torch.sqrt(v / c2) + eps) for m, v in zip(mu, nu)]
    return updates, {"mu": mu, "nu": nu}


def _sgd(g, state, count, momentum=0.9):
    trace = [x + momentum * t for x, t in zip(g, state["trace"])]
    return trace, {"trace": trace}


def _rmsprop(g, state, count, decay=0.9, eps=1e-8):
    nu = _decayed_sq(g, state["nu"], decay)
    return [torch.rsqrt(v + eps) * x for x, v in zip(g, nu)], {"nu": nu}


def _adadelta(g, state, count, rho=0.9, eps=1e-6):
    e_g = _decayed_sq(g, state["e_g"], rho)
    updates = [torch.sqrt(ex + eps) / torch.sqrt(eg + eps) * x
               for x, eg, ex in zip(g, e_g, state["e_x"])]
    return updates, {"e_g": e_g, "e_x": _decayed_sq(updates, state["e_x"], rho)}


_METHODS = {"adam": _adam, "sgd": _sgd, "rmsprop": _rmsprop, "adadelta": _adadelta}


class Optimizer:
    """The optax chain of ``cnmnet_tpu/train/state.py:make_optimizer``:
    clip, active decay, method, learning rate. ``init(params)`` makes the
    state ``{"count": int, <moment>: {name: tensor}}``; ``update(grads,
    state, params)`` returns ``(updates, new_state)`` keyed like ``params``;
    ``apply(params, updates)`` adds the updates in place."""

    def __init__(self, solver: SolverConfig):
        method = solver.method.lower()
        if method not in _METHODS:
            raise ValueError(f"unknown solver method {solver.method!r}")
        self.method = method
        self.lr = solver.lr
        self.weight_decay = solver.weight_decay
        self.grad_clip_norm = solver.grad_clip_norm
        self.warmup_steps = solver.warmup_steps

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        state = {"count": 0}
        for m in MOMENTS[self.method]:
            state[m] = {k: torch.zeros_like(p) for k, p in params.items()}
        return state

    def learning_rate(self, count: int) -> float:
        """The step size at ``count`` (optax's ``linear_schedule(0, lr,
        warmup)`` in float32 when warming up)."""
        if not self.warmup_steps:
            return self.lr
        frac = np.float32(1) - np.float32(min(max(count, 0), self.warmup_steps)) / np.float32(
            self.warmup_steps)
        return _f32(np.float32(-self.lr) * frac + np.float32(self.lr))

    @torch.no_grad()
    def update(self, grads: Mapping[str, Optional[torch.Tensor]], state: Dict,
               params: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
        """The updates and the new state. Outside autograd: the weight decay
        reads the parameters, and moments built with a gradient would chain
        every step's graph (and its saved gradients) to the next."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] if grads.get(k) is not None else torch.zeros_like(params[k])
             for k in names]
        if self.grad_clip_norm:
            g = clip_by_global_norm(g, self.grad_clip_norm)
        if self.weight_decay:
            g = add_decayed_weights_active(g, p, self.weight_decay)
        count = state["count"]
        moments = {m: [state[m][k] for k in names] for m in MOMENTS[self.method]}
        u, moments = _METHODS[self.method](g, moments, count)
        step = -_f32(self.learning_rate(count))
        new_state = {"count": count + 1}
        for m, values in moments.items():
            new_state[m] = dict(zip(names, values))
        return {k: step * x for k, x in zip(names, u)}, new_state

    @staticmethod
    @torch.no_grad()
    def apply(params: Mapping[str, torch.Tensor], updates: Mapping[str, torch.Tensor]) -> None:
        for k, p in params.items():
            p.add_(updates[k])


def make_optimizer(cfg: Config) -> Optimizer:
    return Optimizer(cfg.solver)


def _remat_stages(cfg: Config) -> int:
    """``model.remat``/``remat_stages`` as an encoder stage count: 0 without
    remat, 5 for -1, 1-5 as they are; anything else with remat on raises
    (``cnmnet_tpu/train/state.py:_remat_stages``)."""
    if not cfg.model.remat:
        return 0
    n = cfg.model.remat_stages
    if n == -1:
        return 5
    if not 1 <= n <= 5:
        raise ValueError(
            f"model.remat_stages={n} with model.remat=true: expected -1 "
            "(all five encoder stages) or 1-5 (that many from the input side)"
        )
    return n


def build_model(cfg: Config) -> CNMModel:
    """The ``CNMModel`` of ``cfg.model``, its options checked (see the module
    docstring); weights uninitialised, computing in its weights' dtype."""
    m = cfg.model
    if m.stride2 not in STRIDE2:
        raise KeyError(m.stride2)
    return CNMModel(
        idepth_scale=m.idepth_scale, num_planes=m.num_planes, norm=m.norm,
        cv_backend=m.cv_backend, sampling=m.sampling, use_refiner=m.use_refiner,
        remat=_remat_stages(cfg), remat_refiner=m.remat_refiner,
    )


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), the optimizer's
    state, and the step and epoch counters."""

    model: CNMModel
    opt_state: Dict = field(default_factory=dict)
    step: int = 0
    epoch: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(cfg: Config, seed: int, device="cuda",
                       flax_variables: Optional[Mapping] = None) -> TrainState:
    """A fresh state on ``device``: weights seeded through ``init_weights``
    with a ``torch.Generator``, or carried over from the JAX package's
    ``{"params", "batch_stats"}`` tree; zero moments. Parameters, moments
    and statistics are f32; ``model.compute_dtype`` "bfloat16" computes
    the convs in bf16 (see the module docstring).
    """
    if cfg.model.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"model.compute_dtype={cfg.model.compute_dtype!r}: choose from "
                         f"{sorted(COMPUTE_DTYPES)}")
    dev = resolve_device(device)
    model = build_model(cfg)
    if flax_variables is not None:
        load_flax_variables(model, flax_variables)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    if cfg.model.compute_dtype != "float32":
        set_compute_dtype(model, COMPUTE_DTYPES[cfg.model.compute_dtype])
    model.to(dev)
    return TrainState(model=model, opt_state=make_optimizer(cfg).init(dict(model.named_parameters())))
