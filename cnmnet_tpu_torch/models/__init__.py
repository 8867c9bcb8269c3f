from cnmnet_tpu_torch.models.cnm import CNMModel, CNMOutputs, cast_for_compute
from cnmnet_tpu_torch.models.depthnet import DepthNet
from cnmnet_tpu_torch.models.refinenet import DepthRefineNet
from cnmnet_tpu_torch.models.transplant import load_flax_variables

__all__ = ["CNMModel", "CNMOutputs", "DepthNet", "DepthRefineNet", "cast_for_compute",
           "load_flax_variables"]
