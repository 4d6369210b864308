"""Per-tile sphere and shadow-occluder work lists (the broad phase), as
torch ops.

Counterpart: rtwc_tpu/render/pallas_soft.py:619-982 (`_tile_cones`,
`_compact_lists`, `_sphere_tile_lists`, `_plane_depth_bounds`,
`_shadow_tile_lists`, `_build_tile_lists`), ported whole, the soft `tau`
branch and the `aux` output included, with two fixes. The tile cones are
built from the rays the renderers actually trace (see `_tile_cones`), so
for a pitched camera the lists differ from the JAX package's, which then
miss spheres. And the plane depth bounds are sound over the whole tile
(see `plane_depth_bounds`), so the port's shadow lists may be a superset
of JAX's. In JAX these are plain XLA ops, not a Pallas kernel; here they
are plain torch ops on the tables' device, run without autograd. The
display path uses `hard=True`.

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
from rtwc_tpu_torch.render.reference import _FLT_EPSILON


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


def plane_depth_bounds(pl: torch.Tensor, cam: torch.Tensor, config: RenderConfig, tau: float,
                       d_raw: torch.Tensor):
    """(t_hi_planes [Ti, Tj], covered [Ti, Tj], planes_sky [Ti, Tj]): every
    plane's possible blended-depth contribution over the tile, the
    certificate that some plane covers the whole tile in front of the
    background's weight floor, and the strict (e^-40) sky certificate
    (pallas_soft.py:769-849).

    The corner-extremal certificates rest on d_raw being linear in the
    NDC coordinates: denom = d_raw.n and t_raw = num / denom are extremal at
    the tile's corners. The unit-direction ray parameter t = t_raw |d_raw|
    is not: |d_raw| = sqrt(1 + vx^2 + vy^2) is at least 1 and largest at a
    corner, but t_raw and |d_raw| need not peak at the same corner. JAX
    bounds t by its corner values (:832, :843), which can miss an interior
    ray by a few percent; here min over the tile of t >= min(t_lo,
    t_lo * max|d_raw|) with t_lo the corner minimum of t_raw, and max over
    the tile of t <= t_hi * max|d_raw| with t_hi the corner maximum (where
    every corner's t is >= 0). Both only widen the shadow hull."""
    eps_sign = 1e-3
    far = config.far
    mp = config.soft_miss_penalty
    k = config.soft_mask_k
    sub = (far + 16.0 * tau) / mp
    active = pl[P.P_ACTIVE] > 0.5                                 # [NP]
    origin = cam[0, 0:3]
    n = pl[P.P_NX:P.P_NZ + 1].T                                   # [NP, 3]
    pc = pl[P.P_CX:P.P_CZ + 1].T
    hw = pl[P.P_HW]
    hh = pl[P.P_HH]
    dn = (d_raw[..., None, 0] * n[:, 0] + d_raw[..., None, 1] * n[:, 1]
          + d_raw[..., None, 2] * n[:, 2])                        # [Ti, Tj, 4, NP]
    w = pc - origin[None, :]
    num = w[:, 0] * n[:, 0] + w[:, 1] * n[:, 1] + w[:, 2] * n[:, 2]   # [NP]
    dnorm = _norm3(d_raw)                                         # [Ti, Tj, 4, 1]
    dn_u = dn / dnorm
    front_all = (dn_u <= -eps_sign).all(dim=2)                    # [Ti, Tj, NP]
    sign_ok = front_all | (dn_u >= eps_sign).all(dim=2)
    safe_dn = torch.where(dn.abs() < 1e-12, -1e-12, dn)
    t_raw = num / safe_dn                                         # [Ti, Tj, 4, NP]
    t_norm = t_raw * dnorm
    ex = origin[0] + d_raw[..., 0, None] * t_raw - pc[:, 0]
    ez = origin[2] + d_raw[..., 2, None] * t_raw - pc[:, 2]
    t_in = sign_ok & ((t_norm >= 0.0) & (t_norm <= far)).all(dim=2)

    def irrelevant_at(m):
        back_all = (dn_u >= m).all(dim=2)
        behind_all = sign_ok & (t_norm <= -m).all(dim=2)
        oob = front_all & t_in & (
            (ex >= hw + m).all(dim=2) | (ex <= -(hw + m)).all(dim=2)
            | (ez >= hh + m).all(dim=2) | (ez <= -(hh + m)).all(dim=2))
        return back_all | behind_all | oob | ~active[None, None, :]

    irrelevant = irrelevant_at(sub)
    planes_sky = irrelevant_at((far + 40.0 * tau) / mp).all(dim=-1)
    dmax = dnorm.amax(dim=2)                                      # [Ti, Tj, 1]
    t_lo = t_raw.amin(dim=2)                                      # [Ti, Tj, NP]
    t_max = torch.clamp(t_raw.amax(dim=2) * dmax, 0.0, far)       # sound (docstring)
    t_hi_pl = torch.where(irrelevant, 0.0, torch.where(front_all & t_in, t_max, far))
    t_hi_planes = t_hi_pl.amax(dim=-1)

    def pen(x):
        return torch.logaddexp(-k * x, torch.zeros_like(x)) / k

    eps = _FLT_EPSILON
    x1 = (-dn).amin(dim=2) / dmax - eps
    x2 = torch.minimum(t_lo, t_lo * dmax)                         # sound (docstring)
    x3 = hw - ex.abs().amax(dim=2)
    x4 = hh - ez.abs().amax(dim=2)
    pen_total = mp * (pen(x1) + pen(x2) + pen(x3) + pen(x4))
    covered = (front_all & t_in & active[None, None, :]
               & (t_max + pen_total <= far - 16.0 * tau - 1.0))
    return t_hi_planes, covered.any(dim=-1), planes_sky


_NB = 8            # balls covering a tile's truncated view cone
_CHUNK = 1 << 24   # elements of one [rows, Tj, NB, NS] temporary


def shadow_tile_lists(sph: torch.Tensor, pl: torch.Tensor, cam: torch.Tensor,
                      config: RenderConfig, tau: float, bh: int, bw: int, grid,
                      view_aux=None, disable: bool = False, cones=None):
    """Per-tile shadow-occluder lists, [T, 1, NS+1] i32 in index order
    (pallas_soft.py:852-965): a sphere is kept for a tile when it comes
    within its smoothed radius of the hull of the light and the tile's view
    cone truncated at the tile's depth bound, so that every excluded
    occluder has block < ~1e-7 for every ray of the tile. The [Ti, Tj, NB,
    NS] distance temporaries are built a few tile rows at a time (at most
    _CHUNK elements each: 64 MB), not at once (207 MB each at 3840x2160
    with 200 spheres and 16x16 tiles)."""
    with torch.no_grad():
        Ti, Tj = grid
        sph, pl, cam = sph.detach(), pl.detach(), cam.detach()
        active = sph[P.S_ACTIVE] > 0.5
        ns = active.shape[0]
        if disable:
            return _compact_lists(active[None, :].expand(Ti * Tj, ns))
        far = config.far
        ks = config.soft_shadow_k
        dev = sph.device
        light = torch.tensor(config.light_pos, dtype=torch.float32, device=dev)
        origin = cam[0, 0:3]
        axis, cos_cone, d_raw = (cones if cones is not None
                                 else _tile_cones(cam, config, bh, bw, grid))
        tan_cone = (torch.sqrt(torch.clamp(1.0 - cos_cone * cos_cone, min=0.0))
                    / torch.clamp(cos_cone, min=0.05))
        t_hi_pl, covered, planes_sky = plane_depth_bounds(pl, cam, config, tau, d_raw)
        if view_aux is None:
            t_hi_sph = torch.full((Ti, Tj), far, dtype=torch.float32, device=dev)
            sky_sph = torch.zeros((Ti, Tj), dtype=torch.bool, device=dev)
        else:
            t_hi_sph, sky_sph = view_aux
        t_cap = torch.where(covered, torch.maximum(t_hi_sph, t_hi_pl) + 1.0, far)
        t_cap = torch.clamp(t_cap, 1.0, far)
        skip = sky_sph & planes_sky
        half = t_cap / (2.0 * _NB)
        kk = torch.arange(_NB, dtype=torch.float32, device=dev)
        t_mid = (kk * 2.0 + 1.0) * half[..., None]                # [Ti, Tj, NB]
        t_sl = t_mid + half[..., None]
        cb = origin + axis[..., None, :] * t_mid[..., None]       # [Ti, Tj, NB, 3]
        R = torch.sqrt(half[..., None] ** 2 + (t_sl * tan_cone[..., None]) ** 2)
        centers = sph[P.S_CX:P.S_CZ + 1].T
        radius = sph[P.S_R]
        v = cb - light
        w = centers - light
        vv = (v * v).sum(-1)
        ww = (w * w).sum(-1)
        r_keep = (radius * _f32_sqrt(1.0 + 16.0 / ks).to(dev) + radius + 16.0 / ks + 0.02)
        rows = max(1, _CHUNK // max(1, Tj * _NB * ns))
        incl = torch.empty((Ti, Tj, ns), dtype=torch.bool, device=dev)
        for i0 in range(0, Ti, rows):
            sl = slice(i0, min(Ti, i0 + rows))
            wv = (v[sl, ..., None, 0] * w[:, 0] + v[sl, ..., None, 1] * w[:, 1]
                  + v[sl, ..., None, 2] * w[:, 2])                # [rows, Tj, NB, NS]
            t = torch.clamp(wv / torch.clamp(vv[sl], min=1e-12)[..., None], 0.0, 1.0)
            d2 = ww - 2.0 * t * wv + t * t * vv[sl][..., None]
            d = torch.sqrt(torch.clamp(d2, min=0.0))
            incl[sl] = (d - R[sl][..., None] <= r_keep).any(dim=2)
        incl = incl & active[None, None, :] & ~skip[..., None]
        return _compact_lists(incl.reshape(Ti * Tj, ns))


def build_tile_lists(sph, pl, cam, config: RenderConfig, tau: float, bh: int, bw: int, grid,
                     shadows: bool, disable: bool = False):
    """(view table, shadow table or None) from one cone computation
    (pallas_soft.py:968-982)."""
    cones = None if disable else _tile_cones(cam.detach(), config, bh, bw, grid)
    table, aux = sphere_tile_lists(sph, cam, config, tau, bh, bw, grid, disable=disable,
                                   cones=cones)
    if not shadows:
        return table, None
    return table, shadow_tile_lists(sph, pl, cam, config, tau, bh, bw, grid, view_aux=aux,
                                    disable=disable, cones=cones)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tile_grid(height: int, width: int, bh: int, bw: int):
    """(Ti, Tj) tiles covering a height x width image padded to the tile."""
    return round_up(height, bh) // bh, round_up(width, bw) // bw

