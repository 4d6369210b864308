"""The display path's plain renderer: closest hit, Blinn-Phong, hard shadows,
the supersampling box filter.

Upstream's formulas (Sphere.cu, Plane.cu, RayTracing.cu) as the port's
plain renderer writes them, elementwise, no matmul. A frame is rendered in
row bands so that its [rows, W, N] tensors fit. Only live objects take
part (dead pool slots never hit and never block); the live ones keep
their slot order, so the first index still wins a tie.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from portbench.reference.camera import rays

MISS = 99999999.0
FLT_EPSILON = 1.1920929e-07
BAND_PIXELS = 1 << 18   # pixels a band holds at most


def live_objects(scene: dict, device, dtype=torch.float32):
    """The scene's live spheres and planes as tensors on `device`."""
    def group(g, fields):
        live = scene[g]["active"] > 0.5
        return types.SimpleNamespace(**{f: torch.from_numpy(np.ascontiguousarray(
            scene[g][f][live])).to(device=device, dtype=dtype) for f in fields})

    return (group("spheres", ("center", "radius", "color")),
            group("planes", ("center", "normal", "color", "width", "height")))


def _dot3(a, b):
    """a [..., 3] . b [N, 3] -> [..., N]."""
    return a[..., None, 0] * b[:, 0] + a[..., None, 1] * b[:, 1] + a[..., None, 2] * b[:, 2]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v):
    return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _safe_normalize(v, eps=1e-20):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps))


def _spheres(o, d, sp):
    oc = o - sp.center
    a = _dot(d, d)[..., None]
    b = 2.0 * _dot3(d, oc)
    c = _dot(oc, oc) - sp.radius ** 2
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 1.0 / (2.0 * a)
    t1, t2 = (-b + sq) * inv2a, (-b - sq) * inv2a
    valid = (disc >= 0.0) & (t1 >= 0.0) & (t2 >= 0.0)
    return torch.where(valid, torch.minimum(t1, t2), MISS)


def _planes(o, d, pl):
    denom = _dot3(d, pl.normal)
    num = _dot(pl.center - o, pl.normal)
    t = num / torch.where(denom.abs() < FLT_EPSILON, -1.0, denom)
    p = o + d[..., None, :] * t[..., None]
    in_rect = (((p[..., 0] - pl.center[:, 0]).abs() < pl.width * 0.5)
               & ((p[..., 2] - pl.center[:, 2]).abs() < pl.height * 0.5))
    valid = (denom < -FLT_EPSILON) & (t > 0.0) & in_rect
    return torch.where(valid, t, MISS)


def _visibility(sp, pl, point, light):
    """0 where any live object lies strictly between the point (moved 1e-3
    toward the light) and the light, else 1."""
    to_light = light - point
    dist = torch.sqrt(_dot(to_light, to_light))
    d = to_light / dist[..., None]
    o = point + d * 1e-3
    oc = o[..., None, :] - sp.center
    b = 2.0 * torch.sum(d[..., None, :] * oc, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - sp.radius ** 2
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1, t2 = (-b + sq) * 0.5, (-b - sq) * 0.5
    s_block = (disc >= 0.0) & (t1 >= 0.0) & (t2 >= 0.0) & (torch.minimum(t1, t2) < dist[..., None])
    denom = torch.sum(d[..., None, :] * pl.normal, dim=-1)
    num = torch.sum((pl.center - o[..., None, :]) * pl.normal, dim=-1)
    pt = num / torch.where(denom.abs() < FLT_EPSILON, -1.0, denom)
    pp = o[..., None, :] + d[..., None, :] * pt[..., None]
    in_rect = (((pp[..., 0] - pl.center[:, 0]).abs() < pl.width * 0.5)
               & ((pp[..., 2] - pl.center[:, 2]).abs() < pl.height * 0.5))
    p_block = (denom < -FLT_EPSILON) & (pt > 0.0) & in_rect & (pt < dist[..., None])
    blocked = s_block.any(dim=-1) | p_block.any(dim=-1)
    return torch.where(blocked, 0.0, 1.0).to(point.dtype)


def blinn_phong(diffuse_col, spec_col, point, view, normal, cfg, vis=None):
    """Point light with 1/d^2 falloff, clamped N.L and N.H^hardness, ambient;
    vis scales the direct terms."""
    def vec(v):
        return torch.tensor(v, dtype=point.dtype, device=point.device)

    light_dir = vec(cfg.light_pos) - point
    inv_d2 = 1.0 / _dot(light_dir, light_dir)
    light_dir = _safe_normalize(light_dir)
    n = _safe_normalize(normal)
    v = _safe_normalize(view)
    diffuse = vec(cfg.light_diffuse_color) * (
        torch.clamp(_dot(n, light_dir), 0.0, 1.0) * cfg.light_diffuse_power * inv_d2)[..., None]
    h = _safe_normalize(light_dir + v)
    specular = vec(cfg.light_specular_color) * (
        torch.clamp(_dot(n, h), 0.0, 1.0) ** cfg.specular_hardness
        * cfg.light_specular_power * inv_d2)[..., None]
    if vis is not None:
        diffuse = diffuse * vis[..., None]
        specular = specular * vis[..., None]
    return cfg.ambient * diffuse_col + diffuse * diffuse_col + specular * spec_col


def _trace_band(sp, pl, o, d, cfg, shadows: bool):
    """(rgb 0..255, normal, depth, shading) of one band of rays."""
    t_all = torch.cat([_spheres(o, d, sp), _planes(o, d, pl)], dim=-1)
    idx = torch.argmin(t_all, dim=-1)
    t = torch.gather(t_all, -1, idx[..., None])[..., 0]
    ns = sp.center.shape[0]
    is_sph = idx < ns
    si = torch.where(is_sph, idx, 0)
    pi = torch.where(is_sph, 0, idx - ns)
    empty = torch.zeros((1, 3), dtype=o.dtype, device=o.device)
    s_center = (sp.center if ns else empty)[si]
    s_color = (sp.color if ns else empty)[si]
    p_normal = (pl.normal if pl.center.shape[0] else empty)[pi]
    p_color = (pl.color if pl.center.shape[0] else empty)[pi]
    s_n = _normalize(o + d * t[..., None] - s_center)
    normal = _normalize(torch.where(is_sph[..., None], s_n, p_normal))
    color = torch.where(is_sph[..., None], s_color, p_color)
    miss = t >= MISS
    normal = torch.where(miss[..., None], 0.0, normal)
    color = torch.where(miss[..., None], 0.0, color)
    shading = torch.where(miss, 0.0, normal[..., 0])
    point = o + d * t[..., None]
    light = torch.tensor(cfg.light_pos, dtype=o.dtype, device=o.device)
    vis = _visibility(sp, pl, point, light) if shadows else None
    spec = torch.tensor(cfg.object_specular_color, dtype=o.dtype, device=o.device)
    shaded = blinn_phong(color / 255.0, spec, point, _normalize(-d), normal, cfg, vis)
    rgb = torch.where(miss[..., None], 0.0, torch.clamp(shaded * 255.0, max=255.0))
    return rgb, normal, t, shading


def supersampled(cfg):
    ss = cfg.supersample
    if ss <= 1:
        return cfg
    return cfg.replace(width=cfg.width * ss, height=cfg.height * ss,
                       aspect_coeff=cfg.aspect_coeff / ss, supersample=1)


def render(scene: dict, pos: np.ndarray, rot: np.ndarray, cfg, device, dtype=torch.float32,
           shadows: bool | None = None):
    """The frame at cfg's size (not supersampled): dict of rgb [H, W, 3],
    normal [H, W, 3], depth [H, W], shading [H, W], hit [H, W] on `device`."""
    sp, pl = live_objects(scene, device, dtype)
    shadows = cfg.shadows if shadows is None else shadows
    H, W = cfg.height, cfg.width
    band = max(1, BAND_PIXELS // W)
    pos_t, rot_t = torch.from_numpy(np.asarray(pos, np.float32)), torch.from_numpy(
        np.asarray(rot, np.float32))
    parts = []
    with torch.no_grad():
        for r0 in range(0, H, band):
            n = min(band, H - r0)
            o, d = rays(pos_t, rot_t, cfg, r0, n, device=device, dtype=dtype)
            parts.append(_trace_band(sp, pl, o, d, cfg, shadows))
    rgb, normal, depth, shading = (torch.cat(x, 0) for x in zip(*parts))
    return {"rgb": rgb, "normal": normal, "depth": depth, "shading": shading,
            "hit": depth <= cfg.far}


def downsample(fb: dict, ss: int) -> dict:
    """Box filter to the cell grid: colour and shading averaged over the
    display-hit subsamples (misses black), normals over hits then
    renormalised, depth over hits; a cell hits when half its subsamples do;
    `coverage` keeps the fraction."""
    if ss <= 1:
        return {**fb, "coverage": fb["hit"].to(fb["depth"].dtype)}
    H, W = fb["depth"].shape
    h, w = H // ss, W // ss

    def pool(x):
        return x.reshape(h, ss, w, ss, *x.shape[2:]).mean(dim=(1, 3))

    hitf = pool(fb["hit"].to(fb["depth"].dtype))
    denom = torch.clamp(hitf, min=1.0 / (ss * ss))
    m = fb["hit"].to(fb["depth"].dtype)
    depth = torch.where(hitf > 0.0, pool(fb["depth"] * m) / denom, MISS)
    return {"rgb": pool(fb["rgb"] * m[..., None]),
            "normal": _safe_normalize(pool(fb["normal"] * m[..., None])),
            "depth": depth, "shading": pool(fb["shading"] * m), "hit": hitf >= 0.5,
            "coverage": hitf}
