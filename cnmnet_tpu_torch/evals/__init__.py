from cnmnet_tpu_torch.evals.seven_scenes_eval import (
    evaluate_seven_scenes,
    aggregate_metrics,
    protocol_frame_indices,
    EVAL_PROTOCOLS,
)
from cnmnet_tpu_torch.evals.scannet_eval import evaluate_scannet

__all__ = [
    "evaluate_seven_scenes",
    "aggregate_metrics",
    "protocol_frame_indices",
    "EVAL_PROTOCOLS",
    "evaluate_scannet",
]
