from cnmnet_tpu_torch.geometry.camera import (
    Camera,
    camera_from_array,
    camera_to_array,
    invert_intrinsics,
    invert_se3,
    pixel_grid,
    plane_sweep_homography,
    plane_sweep_terms,
    relative_pose,
    scale_intrinsics,
)
from cnmnet_tpu_torch.geometry.warp import bilinear_sample, cam2pixel, inverse_warp, pixel2cam

__all__ = [
    "Camera",
    "camera_from_array",
    "camera_to_array",
    "invert_intrinsics",
    "invert_se3",
    "pixel_grid",
    "plane_sweep_homography",
    "plane_sweep_terms",
    "relative_pose",
    "scale_intrinsics",
    "bilinear_sample",
    "cam2pixel",
    "inverse_warp",
    "pixel2cam",
]
