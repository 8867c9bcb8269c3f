from cnmnet_tpu_torch.geometry.camera import (
    Camera,
    camera_from_array,
    invert_intrinsics,
    invert_se3,
    pixel_grid,
    plane_sweep_homography,
    plane_sweep_terms,
    relative_pose,
)
from cnmnet_tpu_torch.geometry.warp import pixel2cam

__all__ = [
    "Camera",
    "camera_from_array",
    "invert_intrinsics",
    "invert_se3",
    "pixel_grid",
    "plane_sweep_homography",
    "plane_sweep_terms",
    "relative_pose",
    "pixel2cam",
]
