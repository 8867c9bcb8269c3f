"""Typed experiment configuration (the dataclasses of ``cnmnet_tpu.config``).

Same sections, fields and defaults, so a configuration means the same thing
to both packages. ``ModelConfig.cv_backend`` reads differently here: it
selects the kernel backend for every op that has one, ``None`` (auto: the
CUDA kernel for CUDA tensors, the plain PyTorch version for CPU tensors),
``"torch"`` or ``"cuda"``.

``remat``, ``remat_stages``, ``remat_refiner`` and ``stride2`` mean what
they mean to the JAX package and are checked as it checks them
(``train/state.py:build_model``): remat recomputes DepthNet's first
``remat_stages`` encoder stages (and RefineNet with ``remat_refiner``) in
the backward, through ``torch.utils.checkpoint``; ``stride2`` is one of
``conv``, ``s2d`` and ``psg``, and all three build the same strided conv.

``load_config(path)`` reads a YAML file with the same nesting (PyYAML is
imported only there, and only for a path: the card's machine may not have
it); ``apply_overrides(cfg, ["dataset.batch_size=2", ...])`` parses dotted
overrides to the type of the current value, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class SolverConfig:
    method: str = "adam"
    lr: float = 1e-4
    weight_decay: float = 1e-5
    grad_clip_norm: Optional[float] = None
    warmup_steps: int = 0


@dataclass
class DatasetConfig:
    root_dir: str = ""
    test_dir: str = ""
    list_filepath: str = ""
    test_list_filepath: str = ""
    batch_size: int = 1
    num_workers: int = 4
    image_width: int = 256
    image_height: int = 192
    view_num: int = 3
    interval: int = 10
    depth_scale: float = 5.0
    max_planes: int = 20
    synthetic: bool = False
    synthetic_size: int = 64
    wire_dtype: str = "float32"


@dataclass
class ModelConfig:
    idepth_scale: float = 3.0
    num_planes: int = 64
    k_size: int = 9
    norm: str = "batch"
    compute_dtype: str = "float32"
    use_refiner: bool = True
    remat: bool = False  # recompute encoder stages in the backward
    remat_stages: int = -1  # with remat: -1 = all five, 1-5 = from the input side
    remat_refiner: bool = False  # recompute RefineNet's blocks in the backward
    stride2: str = "conv"  # conv | s2d | psg: one strided conv in the port
    cv_backend: Optional[str] = None  # None = auto, "torch", "cuda"
    sampling: str = "exact"  # "torch": the reference's grid_sample convention


@dataclass
class ParallelConfig:
    data_axis: int = -1
    tile_axis: int = 1
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclass
class TrainConfig:
    seed: int = 123
    num_epochs: int = 100
    resume_dir: Optional[str] = None
    print_interval: int = 10
    checkpoint_dir: str = "checkpoints"
    ckpt_keep: int = 8
    ckpt_interval: Optional[int] = None
    use_normal_loss: bool = True
    use_normal_refined_by_planes: bool = True
    curriculum_epochs: int = 5
    prob_weight: float = 20.0
    normal_weight: float = 0.8
    include_prob_map_loss: bool = False
    grad_accum: int = 1
    log_dir: str = "logs"
    steps_per_epoch: Optional[int] = None


@dataclass
class Config:
    solver: SolverConfig = field(default_factory=SolverConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


_SECTION_TYPES = {
    "SolverConfig": SolverConfig,
    "DatasetConfig": DatasetConfig,
    "ModelConfig": ModelConfig,
    "ParallelConfig": ParallelConfig,
    "TrainConfig": TrainConfig,
}


def _from_dict(cls, data: dict):
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        section = _SECTION_TYPES.get(names[key].type)
        kwargs[key] = _from_dict(section, value) if section is not None else value
    return cls(**kwargs)


def load_config(path: Optional[str] = None) -> Config:
    if path is None:
        return Config()
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"load_config({path!r}) reads YAML and needs PyYAML, which is not "
                          "installed; pass dotted overrides instead") from e
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _from_dict(Config, data)


def _parse_value(text: str, current: Any) -> Any:
    if isinstance(current, bool):
        return text.lower() in ("1", "true", "yes")
    if current is None:
        if text.lower() in ("none", "null"):
            return None
        for caster in (int, float):
            try:
                return caster(text)
            except ValueError:
                pass
        return text
    if isinstance(current, int):
        return int(text)
    if isinstance(current, float):
        return float(text)
    return text


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``section.key=value`` strings (typed by the current value)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        dotted, text = item.split("=", 1)
        parts = dotted.split(".")
        obj = cfg
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key {dotted!r}")
        setattr(obj, leaf, _parse_value(text, getattr(obj, leaf)))
    return cfg


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
