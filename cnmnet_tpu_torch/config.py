"""Typed experiment configuration (the dataclasses of ``cnmnet_tpu.config``).

Same sections, fields and defaults, so a configuration means the same thing
to both packages. Two fields read differently here:

* ``ModelConfig.cv_backend`` selects the kernel backend for every op that
  has one: ``None`` (auto: the CUDA kernel for CUDA tensors, the plain
  PyTorch version for CPU tensors), ``"torch"`` or ``"cuda"``;
* ``remat``, ``remat_stages``, ``remat_refiner`` and ``stride2`` are
  accepted and ignored: they select TPU lowerings with identical parameters
  and outputs, and the port runs the plain form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


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
    remat: bool = False  # ignored (TPU lowering)
    remat_stages: int = -1  # ignored (TPU lowering)
    remat_refiner: bool = False  # ignored (TPU lowering)
    stride2: str = "conv"  # ignored (TPU lowering)
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
