from rtwc_tpu_torch.scene.scene import (
    Planes,
    Scene,
    Spheres,
    add_plane,
    add_sphere,
    default_scene,
    empty_scene,
    grow_scene,
    random_scene,
    scene_from_numpy,
    scene_grads_to_numpy,
    spawn_random_sphere,
    update_scene,
)
from rtwc_tpu_torch.scene.io import load_scene, save_scene

__all__ = [
    "Spheres",
    "Planes",
    "Scene",
    "empty_scene",
    "add_sphere",
    "add_plane",
    "default_scene",
    "grow_scene",
    "random_scene",
    "spawn_random_sphere",
    "update_scene",
    "scene_from_numpy",
    "scene_grads_to_numpy",
    "save_scene",
    "load_scene",
]
