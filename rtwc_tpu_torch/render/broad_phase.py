"""Per-tile sphere work lists (the broad phase), as torch ops.

Counterpart: rtwc_tpu/render/pallas_soft.py:619-766 (`_tile_cones`,
`_compact_lists`, `_sphere_tile_lists`), ported whole, the soft `tau`
branch and the `aux` output included, with one fix: the tile cones are
built from the rays the renderers actually trace (see `_tile_cones`), so
for a pitched camera the lists differ from the JAX package's, which then
miss spheres. In JAX these are plain XLA ops, not
a Pallas kernel; here they are plain torch ops on the tables' device, run
without autograd. The display path uses `hard=True`.

Lists are sorted near to far by a stable argsort with +inf keys for
excluded spheres, so two spheres at the same distance keep index order:
the kernel's strict `t < t_best` then resolves exact ties the way the
JAX package does. Tile cones are built from the padded tile corners
(r_lo + bh - 1, c_lo + bw - 1), so the lists are exact for hard hits only
for a launch whose blocks cover exactly these (bh, bw) tiles.
Dot products and norms are written as left-to-right sums of three terms.
"""
from __future__ import annotations

import torch

from rtwc_tpu_torch.camera import projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import pack as P


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])[..., None]


def _tile_cones(cam: torch.Tensor, config: RenderConfig, bh: int, bw: int, grid):
    """Per-tile bounding ray cones from the 4 padded corner rays: unit axis
    [Ti, Tj, 3], cos of the half-angle [Ti, Tj] and the unnormalised
    corner directions [Ti, Tj, 4, 3]."""
    W, H = config.width, config.height
    e1, e2 = projection_elements(config)
    Ti, Tj = grid
    dev = cam.device
    row0 = cam[0, P.C_ROW0]
    r_lo = row0 + torch.arange(Ti, dtype=torch.float32, device=dev) * bh
    c_lo = torch.arange(Tj, dtype=torch.float32, device=dev) * bw
    rr = torch.stack([r_lo, r_lo + bh - 1.0], -1)                 # [Ti, 2]
    cc = torch.stack([c_lo, c_lo + bw - 1.0], -1)                 # [Tj, 2]
    vy = (H - 2.0 * rr) / H * e2
    vx = (2.0 * cc - W) / W * e1
    # The renderers trace d = (right.v, up.v, fwd.v) for v = (vx, vy, 1)
    # (camera_rays, the kernel's ray generation), i.e. d = vx*col0 + vy*col1
    # + col2 with col_k = (right_k, up_k, fwd_k). pallas_soft.py:640-642
    # builds vx*right + vy*up + fwd instead, which equals it only at zero
    # pitch; with pitch its cones miss spheres that tile rays hit.
    col0 = cam[0, [P.C_RX, P.C_UX, P.C_FX]]
    col1 = cam[0, [P.C_RY, P.C_UY, P.C_FY]]
    col2 = cam[0, [P.C_RZ, P.C_UZ, P.C_FZ]]
    d_raw = (vx[None, :, None, :, None] * col0
             + vy[:, None, :, None, None] * col1
             + col2)                                              # [Ti,Tj,2,2,3]
    d_raw = d_raw.reshape(Ti, Tj, 4, 3)
    d = d_raw / _norm3(d_raw)
    axis = d[:, :, 0] + d[:, :, 1] + d[:, :, 2] + d[:, :, 3]
    axis = axis / _norm3(axis)
    cosc = (axis[:, :, None, 0] * d[..., 0] + axis[:, :, None, 1] * d[..., 1]
            + axis[:, :, None, 2] * d[..., 2])
    cos_cone = cosc.min(dim=-1).values
    return axis, torch.clamp(cos_cone, -1.0, 1.0), d_raw


def _compact_lists(incl: torch.Tensor, sort_key: torch.Tensor | None = None):
    """[T, NS] inclusion mask -> int32 [T, 1, NS+1] table: slot 0 is the
    list length, then the included indices in sort_key order (index order
    when None), then the excluded ones."""
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=incl.device)
    key = torch.where(incl, 0.0 if sort_key is None else sort_key, inf)
    order = torch.argsort(key, dim=1, stable=True)
    count = incl.sum(dim=1).to(torch.int32)
    table = torch.cat([count[:, None], order.to(torch.int32)], dim=1)
    return table[:, None, :].contiguous()


def _f32_sqrt(x: float) -> torch.Tensor:
    """sqrt rounded like jnp.sqrt of a Python float (in f32)."""
    return torch.sqrt(torch.tensor(x, dtype=torch.float32))


def sphere_tile_lists(sph: torch.Tensor, cam: torch.Tensor, config: RenderConfig,
                      tau: float, bh: int, bw: int, grid, hard: bool = False,
                      disable: bool = False, cones=None):
    """Per-tile sphere lists: returns (table [T, 1, NS+1] i32, aux) with
    aux = (t_hi_sph [Ti, Tj], sky_sph [Ti, Tj]) or None when disable=True.

    hard=True: a sphere is listed for a tile exactly when some ray of the
    tile's cone can hit it geometrically (or the origin is inside it).
    Otherwise the soft rule of pallas_soft.py:674-719 applies (softmin
    weight above exp(-16) relative to the background)."""
    with torch.no_grad():
        Ti, Tj = grid
        sph = sph.detach()
        cam = cam.detach()
        active = sph[P.S_ACTIVE] > 0.5
        if disable:
            incl = active[None, :].expand(Ti * Tj, active.shape[0])
            return _compact_lists(incl), None
        mp = config.soft_miss_penalty
        reach = 0.0 if hard else (config.far + 16.0 * tau) / mp
        r_scale = 1.0 if hard else _f32_sqrt(1.0 + (config.far + 16.0 * tau) / mp).to(sph.device)

        axis, cos_cone, _ = (cones if cones is not None
                             else _tile_cones(cam, config, bh, bw, grid))
        cone = torch.arccos(cos_cone)                             # [Ti, Tj]

        centers = sph[P.S_CX:P.S_CZ + 1].T                        # [NS, 3]
        radius = sph[P.S_R]
        origin = cam[0, 0:3]
        v = centers - origin
        dist = _norm3(v)[:, 0]
        u = v / torch.clamp(dist, min=1e-12)[:, None]
        r_eff = radius * r_scale
        cosang = (axis[..., None, 0] * u[:, 0] + axis[..., None, 1] * u[:, 1]
                  + axis[..., None, 2] * u[:, 2])                 # [Ti, Tj, NS]
        ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        alpha = torch.arcsin(torch.clamp(r_eff / torch.clamp(dist, min=1e-12), 0.0, 1.0))
        geom = ang <= cone[..., None] + alpha[None, None, :]
        near = dist <= r_eff + reach
        incl3 = (geom | near[None, None, :]) & active[None, None, :]
        t_hi_sph = torch.where(incl3, (dist + radius)[None, None, :], 0.0).max(dim=-1).values
        r_eff40 = radius * _f32_sqrt(1.0 + (config.far + 40.0 * tau) / mp).to(sph.device)
        reach40 = (config.far + 40.0 * tau) / mp
        alpha40 = torch.arcsin(torch.clamp(r_eff40 / torch.clamp(dist, min=1e-12), 0.0, 1.0))
        incl40 = ((ang <= cone[..., None] + alpha40[None, None, :])
                  | (dist <= r_eff40 + reach40)[None, None, :]) & active[None, None, :]
        sky_sph = ~incl40.any(dim=-1)
        incl = incl3.reshape(Ti * Tj, -1)
        key = dist[None, :].expand(incl.shape)
        return _compact_lists(incl, sort_key=key), (t_hi_sph, sky_sph)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tile_grid(height: int, width: int, bh: int, bw: int):
    """(Ti, Tj) tiles covering a height x width image padded to the tile."""
    return round_up(height, bh) // bh, round_up(width, bw) // bw

