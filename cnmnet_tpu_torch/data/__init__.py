from cnmnet_tpu_torch.data.cameras import load_cam_text, write_cam_text, make_cam_array
from cnmnet_tpu_torch.data.synthetic import SyntheticScenes
from cnmnet_tpu_torch.data.scannet import ScanNetDataset
from cnmnet_tpu_torch.data.seven_scenes import SevenScenes
from cnmnet_tpu_torch.data.pipeline import PrefetchLoader, collate

__all__ = [
    "load_cam_text",
    "write_cam_text",
    "make_cam_array",
    "SyntheticScenes",
    "ScanNetDataset",
    "SevenScenes",
    "PrefetchLoader",
    "collate",
]
