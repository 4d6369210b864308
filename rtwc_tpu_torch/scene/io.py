"""Scene / camera checkpointing to .npz.

Counterpart: rtwc_tpu/scene/io.py:16-43. The keys are the same
("spheres.center", ..., "camera.pos", "camera.rot"), so a file written by
either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from rtwc_tpu_torch.scene.scene import _PLANE_FIELDS, _SPHERE_FIELDS, Planes, Scene, Spheres


def save_scene(path: str, scene: Scene, camera=None) -> None:
    """Write scene (and optionally camera pose) to an .npz file."""
    data = {}
    for prefix, node, fields in (("spheres", scene.spheres, _SPHERE_FIELDS),
                                 ("planes", scene.planes, _PLANE_FIELDS)):
        for name in fields:
            data[f"{prefix}.{name}"] = getattr(node, name).detach().cpu().numpy()
    if camera is not None:
        data["camera.pos"] = np.asarray(torch.as_tensor(camera.pos).cpu())
        data["camera.rot"] = np.asarray(torch.as_tensor(camera.rot).cpu())
    np.savez(path, **data)


def load_scene(path: str, device: torch.device | str | None = None):
    """Load a scene saved by either package. Returns (scene, camera_or_None);
    the camera stays on the host."""
    from rtwc_tpu_torch.camera import Camera

    with np.load(path) as z:
        def grab(prefix, cls, fields):
            return cls(**{f: torch.from_numpy(np.array(z[f"{prefix}.{f}"])).to(device or "cpu")
                          for f in fields})

        scene = Scene(spheres=grab("spheres", Spheres, _SPHERE_FIELDS),
                      planes=grab("planes", Planes, _PLANE_FIELDS))
        camera = None
        if "camera.pos" in z:
            camera = Camera(pos=torch.from_numpy(np.array(z["camera.pos"])),
                            rot=torch.from_numpy(np.array(z["camera.rot"])))
    return scene, camera
