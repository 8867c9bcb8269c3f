from cnmnet_tpu_torch.models.cnm import CNMModel, CNMOutputs
from cnmnet_tpu_torch.models.depthnet import DepthNet
from cnmnet_tpu_torch.models.refinenet import DepthRefineNet
from cnmnet_tpu_torch.models.transplant import load_flax_variables

__all__ = ["CNMModel", "CNMOutputs", "DepthNet", "DepthRefineNet", "load_flax_variables"]
