"""Camera state + ray generation.

Counterpart: rtwc_tpu/camera/camera.py:25-115. The camera is a pose
(position, Euler rotation as pitch/yaw/roll) kept on the host between
frames; `basis`, `projection_elements` and `camera_rays` follow the JAX
package's formulas term for term.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.mathx import normalize, tensor_dataclass


@tensor_dataclass
class Camera:
    pos: torch.Tensor  # [3] f32
    rot: torch.Tensor  # [3] f32 = (pitch, yaw, roll)


def default_camera() -> Camera:
    """Reference defaults: origin, yaw = pi (Camera3D.h:62-65); host tensors."""
    return Camera(
        pos=torch.zeros(3, dtype=torch.float32),
        rot=torch.from_numpy(np.array([0.0, math.pi, 0.0], np.float32)),
    )


def camera_from_numpy(cam, device: torch.device | str | None = None,
                      requires_grad=()) -> Camera:
    """Build the port's Camera from a JAX-package Camera (or any object with
    `pos` / `rot` leaves that convert with np.asarray). `requires_grad`
    names the leaves ("pos", "rot", or "all") that become autograd leaves."""
    want = set(requires_grad)

    def t(name):
        out = torch.from_numpy(np.array(np.asarray(getattr(cam, name)), np.float32))
        out = out.to(device or "cpu")
        if "all" in want or name in want:
            out.requires_grad_(True)
        return out

    return Camera(pos=t("pos"), rot=t("rot"))


def camera_grads_to_numpy(camera: Camera) -> SimpleNamespace:
    """Gradients of the camera's leaves as f32 NumPy arrays under the JAX
    Camera's field names (zeros where a leaf has no gradient)."""
    def g(x):
        if x.grad is None:
            return np.zeros(tuple(x.shape), np.float32)
        return np.array(x.grad.detach().cpu().numpy(), np.float32)

    return SimpleNamespace(pos=g(camera.pos), rot=g(camera.rot))


def basis(rot: torch.Tensor):
    """Euler-angle orthonormal basis (Camera3D.cpp:53-75).
    Returns (right, up, forward), each [..., 3]."""
    p, y = rot[..., 0], rot[..., 1]
    sp, cp = torch.sin(p), torch.cos(p)
    sy, cy = torch.sin(y), torch.cos(y)
    forward = torch.stack([-sy, -sp * cy, -cp * cy], dim=-1)
    right = torch.stack([cy, -sp * sy, -cp * sy], dim=-1)
    up = torch.stack([torch.zeros_like(p), cp, -sp], dim=-1)
    return right, up, forward


def static_basis(rot: torch.Tensor):
    """Yaw-only movement basis with the reference's junk y/z components
    (Camera3D.cpp:61-71). Returns (static_right, static_forward)."""
    y = rot[..., 1]
    sy, cy = torch.sin(y), torch.cos(y)
    static_forward = torch.stack([-sy, -cy, -cy], dim=-1)
    static_right = torch.stack([cy, -sy, -sy], dim=-1)
    return static_right, static_forward


def projection_elements(config: RenderConfig):
    """pMatrix[0][0], [1][1] (Camera3D.cpp:10-47): e = 1/tan(fov/2),
    aspect = 1 / (aspect_coeff * H). Returns (e / aspect, e)."""
    e = 1.0 / math.tan(config.fov / 2.0)
    aspect = 1.0 / (config.aspect_coeff * config.height)
    return e / aspect, e


def camera_rays(camera: Camera, width: int, height: int, e1: float, e2: float,
                row_start: float = 0, n_rows: int | None = None,
                device: torch.device | str | None = None):
    """(n_rows, W) grid of world-space unit ray directions
    (camera.py:76-115): cx = (2 col - W)/W, cy = (H - 2 row)/H,
    v = (cx e1, cy e2, 1), d = B^T v normalised. Rows start at `row_start`
    (the band hook). Returns (origin [3], dirs [n_rows, W, 3]) on `device`
    (default: the camera's)."""
    device = torch.device(device) if device is not None else camera.pos.device
    if n_rows is None:
        n_rows = height
    rot = camera.rot.to(device)
    right, up, forward = basis(rot)
    col = torch.arange(width, dtype=torch.float32, device=device)
    row = float(row_start) + torch.arange(n_rows, dtype=torch.float32, device=device)
    cx = (2.0 * col - width) / width
    cy = (height - 2.0 * row) / height
    vx = (cx * e1)[None, :]
    vy = (cy * e2)[:, None]
    col0 = torch.stack([right[..., 0], up[..., 0], forward[..., 0]], dim=-1)
    col1 = torch.stack([right[..., 1], up[..., 1], forward[..., 1]], dim=-1)
    col2 = torch.stack([right[..., 2], up[..., 2], forward[..., 2]], dim=-1)
    d = vx[..., None] * col0 + vy[..., None] * col1 + col2
    return camera.pos.to(device), normalize(d)
