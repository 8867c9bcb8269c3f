from cnmnet_tpu_torch.obs.logger import MetricLogger
from cnmnet_tpu_torch.obs.meters import AverageMeter
from cnmnet_tpu_torch.obs.colorize import (
    colorize_depth,
    colorize_idepth,
    colorize_prob,
    normal_to_color,
)

__all__ = [
    "MetricLogger",
    "AverageMeter",
    "colorize_depth",
    "colorize_idepth",
    "colorize_prob",
    "normal_to_color",
]
