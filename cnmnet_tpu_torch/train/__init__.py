from cnmnet_tpu_torch.train.checkpoint import CheckpointManager
from cnmnet_tpu_torch.train.losses import LossWeights, compute_losses
from cnmnet_tpu_torch.train.loop import make_train_step, train_loop
from cnmnet_tpu_torch.train.state import TrainState, create_train_state, make_optimizer

__all__ = [
    "CheckpointManager",
    "LossWeights",
    "TrainState",
    "compute_losses",
    "create_train_state",
    "make_optimizer",
    "make_train_step",
    "train_loop",
]
