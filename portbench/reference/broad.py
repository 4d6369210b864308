"""A plain broad phase at fixed 16 x 16 tiles: which spheres each tile's
rays can reach.

The port's own list rules, frozen here so that the benchmark's count of a
kernel's work does not move when the port changes how it tiles or culls.
A tile's cone is bounded by the rays of its four padded corners, built as
the renderers build rays (d = vx col0 + vy col1 + col2 of the basis
columns). hard=True lists a sphere when some ray of the cone can hit it
(or the eye is inside it); the soft rule widens each sphere by the miss
penalty's reach, sqrt(1 + (far + 16 tau) / miss_penalty), as far as the
softmin weight stays above e^-16 of the background's. Lists are sorted
near to far by a stable sort.
"""
from __future__ import annotations

import torch

TILE = 16


def grid(height: int, width: int, tile: int = TILE):
    return (height + tile - 1) // tile, (width + tile - 1) // tile


def _norm3(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])[..., None]


def tile_cones(basis_cols, cfg, e1: float, e2: float, row0: float = 0.0, tile: int = TILE):
    """(axis [Ti, Tj, 3], cos of the half-angle [Ti, Tj]) of every tile;
    basis_cols = (col0, col1, col2), each [3], col_k = (right_k, up_k, fwd_k)."""
    col0, col1, col2 = basis_cols
    W, H = cfg.width, cfg.height
    Ti, Tj = grid(H, W, tile)
    dev = col0.device
    r_lo = row0 + torch.arange(Ti, dtype=torch.float32, device=dev) * tile
    c_lo = torch.arange(Tj, dtype=torch.float32, device=dev) * tile
    rr = torch.stack([r_lo, r_lo + tile - 1.0], -1)
    cc = torch.stack([c_lo, c_lo + tile - 1.0], -1)
    vy = (H - 2.0 * rr) / H * e2
    vx = (2.0 * cc - W) / W * e1
    d_raw = (vx[None, :, None, :, None] * col0 + vy[:, None, :, None, None] * col1 + col2)
    d_raw = d_raw.reshape(Ti, Tj, 4, 3)
    d = d_raw / _norm3(d_raw)
    axis = d[:, :, 0] + d[:, :, 1] + d[:, :, 2] + d[:, :, 3]
    axis = axis / _norm3(axis)
    cosc = (axis[:, :, None, 0] * d[..., 0] + axis[:, :, None, 1] * d[..., 1]
            + axis[:, :, None, 2] * d[..., 2])
    return axis, torch.clamp(cosc.min(dim=-1).values, -1.0, 1.0)


def sphere_lists(center, radius, active, origin, basis_cols, cfg, e1, e2, tau: float = 0.0,
                 hard: bool = True, row0: float = 0.0, tile: int = TILE):
    """int32 [T, 1, NS + 1]: slot 0 a tile's list length, then the listed
    sphere indices near to far, then the others (index order)."""
    with torch.no_grad():
        axis, cos_cone = tile_cones(basis_cols, cfg, e1, e2, row0, tile)
        cone = torch.arccos(cos_cone)
        mp = cfg.soft_miss_penalty
        reach = 0.0 if hard else (cfg.far + 16.0 * tau) / mp
        r_scale = 1.0 if hard else torch.sqrt(torch.tensor(
            1.0 + (cfg.far + 16.0 * tau) / mp, dtype=torch.float32)).to(center.device)
        v = center - origin
        dist = _norm3(v)[:, 0]
        u = v / torch.clamp(dist, min=1e-12)[:, None]
        r_eff = radius * r_scale
        cosang = (axis[..., None, 0] * u[:, 0] + axis[..., None, 1] * u[:, 1]
                  + axis[..., None, 2] * u[:, 2])
        ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        alpha = torch.arcsin(torch.clamp(r_eff / torch.clamp(dist, min=1e-12), 0.0, 1.0))
        live = active > 0.5
        incl = ((ang <= cone[..., None] + alpha[None, None, :])
                | (dist <= r_eff + reach)[None, None, :]) & live[None, None, :]
        incl = incl.reshape(-1, center.shape[0])
        key = torch.where(incl, dist[None, :].expand(incl.shape),
                          torch.tensor(float("inf"), device=center.device))
        order = torch.argsort(key, dim=1, stable=True)
        count = incl.sum(dim=1).to(torch.int32)
        return torch.cat([count[:, None], order.to(torch.int32)], 1)[:, None, :].contiguous()
