"""Camera pose, basis, rays and the WASD / mouse controller.

A pose is (pos [3], rot [3] = pitch, yaw, roll) in float32 on the host.
The formulas are upstream's (Camera3D.cpp), as the port writes them:
basis from the Euler angles, the projection elements e1 = e / aspect and
e2 = e with aspect = 1 / (aspect_coeff * height), rays through the
cell centres' grid cx = (2 col - W) / W, cy = (H - 2 row) / H.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PITCH_LIMIT = math.pi / 2.0 - 1e-4


def default_pose():
    return np.zeros(3, np.float32), np.array([0.0, math.pi, 0.0], np.float32)


def basis(rot: torch.Tensor):
    """(right, up, forward) of an Euler rotation (pitch, yaw, roll)."""
    p, y = rot[..., 0], rot[..., 1]
    sp, cp = torch.sin(p), torch.cos(p)
    sy, cy = torch.sin(y), torch.cos(y)
    forward = torch.stack([-sy, -sp * cy, -cp * cy], dim=-1)
    right = torch.stack([cy, -sp * sy, -cp * sy], dim=-1)
    up = torch.stack([torch.zeros_like(p), cp, -sp], dim=-1)
    return right, up, forward


def projection_elements(cfg) -> tuple[float, float]:
    e = 1.0 / math.tan(math.pi / cfg.fov_divisor / 2.0)
    aspect = 1.0 / (cfg.aspect_coeff * cfg.height)
    return e / aspect, e


def rays(pos: torch.Tensor, rot: torch.Tensor, cfg, row0: int, n_rows: int, device=None,
         dtype=torch.float32):
    """(origin [3], dirs [n_rows, W, 3]) of the rays of image rows row0 ..
    row0 + n_rows - 1: d = (r.v, u.v, f.v) for v = (vx, vy, 1), times
    1 / sqrt(d . d) (correctly rounded), differentiable in the pose. The
    basis is computed where `rot` lives (the display path keeps the pose on
    the host), the rays on `device` (default: rot's) in `dtype`."""
    device = rot.device if device is None else torch.device(device)
    right, up, fwd = (v.to(device=device, dtype=dtype) for v in basis(rot))
    e1, e2 = projection_elements(cfg)
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    W, H = cfg.width, cfg.height
    rowf = (float(row0) + torch.arange(n_rows, dtype=dtype, device=device))[:, None]
    rowf = rowf.expand(n_rows, W)
    colf = torch.arange(W, dtype=dtype, device=device)[None, :].expand(n_rows, W)
    vx = (2.0 * colf - W) / torch.tensor(W, dtype=dtype, device=device) * f32(e1)
    vy = (H - 2.0 * rowf) / torch.tensor(H, dtype=dtype, device=device) * f32(e2)
    dx = right[0] * vx + right[1] * vy + right[2]
    dy = up[0] * vx + up[1] * vy + up[2]
    dz = fwd[0] * vx + fwd[1] * vy + fwd[2]
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    return pos.to(device=device, dtype=dtype), torch.stack([dx * inv, dy * inv, dz * inv], -1)


def move(pos: np.ndarray, rot: np.ndarray, keys: dict, dt: float, speed: float) -> np.ndarray:
    """WASD / space / shift: planar motion on the yaw-only basis (junk y
    included), normalised as a 3-vector, x and z applied; vertical motion
    unrotated."""
    ds = float(dt) * speed
    pos = pos.copy()
    y = float(rot[1])
    sy, cy = math.sin(y), math.cos(y)
    static_right = np.array([cy, -sy, -sy], np.float32)
    static_forward = np.array([-sy, -cy, -cy], np.float32)
    k = lambda c: float(keys.get(c, 0))  # noqa: E731
    total = static_right * (k("d") - k("a")) + static_forward * (k("w") - k("s"))
    norm = float(np.linalg.norm(total))
    if norm > 0.0:
        total = total / norm
    pos[0] += total[0] * ds
    pos[2] += total[2] * ds
    pos[1] += (k("space") - k("shift")) * ds
    return pos


def add_rot(rot: np.ndarray, dp: float, dy: float, sensitivity: float) -> np.ndarray:
    """Mouse deltas: pitch -= dp s, yaw += dy s, pitch clamped inside +-pi/2."""
    rot = rot + np.array([-dp * sensitivity, dy * sensitivity, 0.0], np.float32)
    rot[0] = min(max(float(rot[0]), -PITCH_LIMIT), PITCH_LIMIT)
    return rot
