"""Camera movement / rotation controller, host NumPy between frames.

Counterpart: rtwc_tpu/camera/controller.py:22-72 (a copy: the JAX
package's module cannot be imported without JAX, because
rtwc_tpu/camera/__init__.py imports camera.py). Camera3D::Move / ::AddRot
(Camera3D.cpp:142-187); the pose stays on the host.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rtwc_tpu_torch.camera.camera import Camera

_PITCH_LIMIT = math.pi / 2.0 - 1e-4  # Camera3D.cpp:178-186


@dataclasses.dataclass
class Keys:
    """Pressed-key state (Camera3D.h:37-48 PressedKeys)."""

    w: int = 0
    a: int = 0
    s: int = 0
    d: int = 0
    space: int = 0
    shift: int = 0


def _np(x: torch.Tensor) -> np.ndarray:
    return np.array(x.detach().cpu().numpy(), np.float32)


def move(camera: Camera, keys: Keys, dt: float, speed: float = 10.0) -> Camera:
    """WASD/space/shift movement (Camera3D.cpp:142-163): planar motion on
    the yaw-only basis (junk y included), normalised as a 3-vector, only
    x/z applied; vertical motion unrotated."""
    ds = float(dt) * speed
    pos = _np(camera.pos)
    rot = _np(camera.rot)
    y = float(rot[1])
    sy, cy = math.sin(y), math.cos(y)
    static_right = np.array([cy, -sy, -sy], np.float32)
    static_forward = np.array([-sy, -cy, -cy], np.float32)
    total = static_right * float(keys.d - keys.a) + static_forward * float(keys.w - keys.s)
    norm = float(np.linalg.norm(total))
    if norm > 0.0:
        total = total / norm
    pos[0] += total[0] * ds
    pos[2] += total[2] * ds
    pos[1] += float(keys.space - keys.shift) * ds
    return camera.replace(pos=torch.from_numpy(pos))


def add_rot(camera: Camera, dp: float, dy: float, dr: float = 0.0,
            sensitivity: float = 0.002) -> Camera:
    """Mouse-delta rotation (Camera3D.cpp:166-187): pitch -= dp*s,
    yaw += dy*s, roll += dr*s, pitch clamped inside +-pi/2; not scaled by dt."""
    rot = _np(camera.rot)
    rot += np.array([-dp * sensitivity, dy * sensitivity, dr * sensitivity], np.float32)
    rot[0] = min(max(float(rot[0]), -_PITCH_LIMIT), _PITCH_LIMIT)
    return camera.replace(rot=torch.from_numpy(rot))
