from rtwc_tpu_torch.camera.camera import (
    Camera,
    basis,
    camera_from_numpy,
    camera_grads_to_numpy,
    camera_rays,
    default_camera,
    projection_elements,
    static_basis,
)
from rtwc_tpu_torch.camera.controller import Keys, add_rot, move

__all__ = [
    "Camera",
    "default_camera",
    "camera_from_numpy",
    "camera_grads_to_numpy",
    "basis",
    "static_basis",
    "projection_elements",
    "camera_rays",
    "Keys",
    "move",
    "add_rot",
]
