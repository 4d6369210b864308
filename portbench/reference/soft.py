"""The differentiable renderer: a temperature-tau softmin over the objects
and the background, with soft shadows, in plain torch with autograd.

Each hard reject branch is a smooth depth penalty

    t_eff = clip(t, 0, far) + miss_penalty * sum_c softplus(-k x_c) / k

(dead pool slots get 1e7 more), the closest hit a softmax of -t_eff / tau
with the background at far; with shadows, one soft occlusion test per ray
at the blended hit point, each occluder's reject branches sigmoid steps of
sharpness soft_shadow_k and the visibility the product of the occluders'
transmittances, floored at 1e-7. A sphere's discriminant is 4 (r^2 - q.q)
with q the ray's closest approach to the centre. softplus is
logaddexp(x, 0). A frame is computed in row bands; `loss_and_grads`
takes a band's backward at a time, so the [rows, W, N] tensors of one band
are all that autograd holds.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from portbench.reference.camera import rays
from portbench.reference.hard import FLT_EPSILON, blinn_phong

INACTIVE = 1e7
TRANS_FLOOR = 1e-7
BAND_PIXELS = 1 << 17


def _max(x, c):
    return torch.maximum(x, x.new_tensor(c))


def _min(x, c):
    return torch.minimum(x, x.new_tensor(c))


def _clip(x, lo, hi):
    return _min(_max(x, lo), hi)


def _pen(x, k):
    z = -k * x
    return torch.logaddexp(z, torch.zeros_like(z)) / k


def _dot3(a, b):
    return a[..., None, 0] * b[:, 0] + a[..., None, 1] * b[:, 1] + a[..., None, 2] * b[:, 2]


def _safe_normalize(v, eps=1e-20):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps))


def _sphere_terms(o, d, sp, k, mp, far):
    oc = o - sp.center                                              # [N, 3]
    dx, dy, dz = (d[..., None, i] for i in range(3))
    h = dx * oc[:, 0] + dy * oc[:, 1] + dz * oc[:, 2]
    qx, qy, qz = oc[:, 0] - h * dx, oc[:, 1] - h * dy, oc[:, 2] - h * dz
    disc = 4.0 * (sp.radius * sp.radius - (qx * qx + qy * qy + qz * qz))
    sq = torch.sqrt(_max(disc, 1e-12))
    t2 = 0.5 * (-2.0 * h - sq)
    scale = 1.0 / _max(sp.radius, 1e-3)
    pen = mp * (_pen(disc * scale * scale, k) + _pen(t2, k)) + torch.where(
        sp.active > 0.5, 0.0, INACTIVE)
    t_clip = _clip(t2, 0.0, far)
    p = o + d[..., None, :] * t_clip[..., None]
    return t_clip + pen, t_clip, _safe_normalize(p - sp.center)


def _plane_terms(o, d, pl, k, mp, far):
    denom = _dot3(d, pl.normal)
    num = torch.sum((pl.center - o) * pl.normal, dim=-1)
    t = num / torch.where(denom.abs() < FLT_EPSILON, -FLT_EPSILON, denom)
    t_clip = _clip(t, 0.0, far)
    p = o + d[..., None, :] * t_clip[..., None]
    pen = mp * (_pen(-denom - FLT_EPSILON, k) + _pen(t, k)
                + _pen(pl.width * 0.5 - (p[..., 0] - pl.center[:, 0]).abs(), k)
                + _pen(pl.height * 0.5 - (p[..., 2] - pl.center[:, 2]).abs(), k)
                ) + torch.where(pl.active > 0.5, 0.0, INACTIVE)
    return t_clip + pen, t_clip, pl.normal.expand(p.shape)


def _visibility(sp, pl, point, cfg):
    ks = cfg.soft_shadow_k
    sig = torch.sigmoid
    light = torch.tensor(cfg.light_pos, dtype=point.dtype, device=point.device)
    to_light = light - point
    dist = torch.sqrt(_max(torch.sum(to_light * to_light, -1), 1e-12))
    d = to_light / dist[..., None]
    o = point + d * 1e-2
    oc = o[..., None, :] - sp.center
    b = 2.0 * torch.sum(d[..., None, :] * oc, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - sp.radius ** 2
    disc = b * b - 4.0 * c
    sq = torch.sqrt(_max(disc, 1e-12))
    t1, t2 = 0.5 * (-b + sq), 0.5 * (-b - sq)
    scale = 1.0 / _max(sp.radius, 1e-3)
    block_s = (sig(ks * disc * scale * scale) * sig(ks * t1) * sig(ks * t2)
               * sig(ks * (dist[..., None] - t2)) * torch.where(sp.active > 0.5, 1.0, 0.0))
    denom = torch.sum(d[..., None, :] * pl.normal, dim=-1)
    num = torch.sum((pl.center - o[..., None, :]) * pl.normal, dim=-1)
    t = num / torch.where(denom.abs() < FLT_EPSILON, -FLT_EPSILON, denom)
    p = o[..., None, :] + d[..., None, :] * t[..., None]
    block_p = (sig(ks * (-denom - FLT_EPSILON)) * sig(ks * t)
               * sig(ks * (pl.width * 0.5 - (p[..., 0] - pl.center[:, 0]).abs()))
               * sig(ks * (pl.height * 0.5 - (p[..., 2] - pl.center[:, 2]).abs()))
               * sig(ks * (dist[..., None] - t)) * torch.where(pl.active > 0.5, 1.0, 0.0))
    trans = _max(torch.cat([1.0 - block_s, 1.0 - block_p], dim=-1), TRANS_FLOOR)
    return torch.prod(trans, dim=-1)


def trace(sp, pl, o, d, cfg, tau: float, shadows: bool):
    """(rgb [..., 3] 0..255, depth [...], alpha [...]) of rays o + t d."""
    k, mp, far = cfg.soft_mask_k, cfg.soft_miss_penalty, cfg.far
    te_s, tc_s, n_s = _sphere_terms(o, d, sp, k, mp, far)
    te_p, tc_p, n_p = _plane_terms(o, d, pl, k, mp, far)
    t_eff = torch.cat([te_s, te_p], -1)
    t_clip = torch.cat([tc_s, tc_p], -1)
    normals = torch.cat([n_s, n_p], -2)
    colors = torch.cat([sp.color, pl.color], 0)
    logits = -t_eff / tau
    bg = torch.full(logits.shape[:-1], -far / tau, dtype=logits.dtype, device=logits.device)
    w = torch.softmax(torch.cat([logits, bg[..., None]], -1), -1)
    w_obj, w_bg = w[..., :-1], w[..., -1]
    point = o + d[..., None, :] * t_clip[..., None]
    vis = None
    if shadows:
        depth_blend = torch.sum(w_obj * t_clip, -1) + w_bg * far
        vis = _visibility(sp, pl, o + d * depth_blend[..., None], cfg)[..., None]
    spec = torch.tensor(cfg.object_specular_color, dtype=d.dtype, device=d.device)
    shaded = blinn_phong(colors / 255.0, spec, point, _safe_normalize(-d)[..., None, :],
                         normals, cfg, vis)
    rgb = torch.sum(w_obj[..., None] * _min(shaded * 255.0, 255.0), -2)
    depth = torch.sum(w_obj * t_clip, -1) + w_bg * far
    return rgb, depth, 1.0 - w_bg


def leaves(scene: dict, pos, rot, device, dtype, trained):
    """{name: tensor} of every float leaf of scene and camera on `device`,
    copied (the reference's Adam updates them in place, and the harness's
    arrays are both sides' inputs); the `trained` names require a gradient. Names: spheres.center, ...,
    planes.height, camera.pos, camera.rot."""
    out = {}
    for g in ("spheres", "planes"):
        for f, v in scene[g].items():
            out[f"{g}.{f}"] = torch.tensor(np.asarray(v), dtype=dtype, device=device)
    out["camera.pos"] = torch.tensor(np.asarray(pos, np.float32), dtype=dtype, device=device)
    out["camera.rot"] = torch.tensor(np.asarray(rot, np.float32), dtype=dtype, device=device)
    for name in trained:
        out[name].requires_grad_(True)
    return out


def _objects(lv):
    sp = types.SimpleNamespace(**{f: lv[f"spheres.{f}"] for f in
                                  ("center", "radius", "color", "active")})
    pl = types.SimpleNamespace(**{f: lv[f"planes.{f}"] for f in
                                  ("center", "normal", "color", "width", "height", "active")})
    return sp, pl


def _bands(cfg):
    step = max(1, BAND_PIXELS // cfg.width)
    return [(r0, min(step, cfg.height - r0)) for r0 in range(0, cfg.height, step)]


def render(lv, cfg, tau: float, shadows: bool):
    """(rgb [H, W, 3], alpha [H, W]) without autograd."""
    sp, pl = _objects(lv)
    rgbs, alphas = [], []
    with torch.no_grad():
        for r0, n in _bands(cfg):
            o, d = rays(lv["camera.pos"], lv["camera.rot"], cfg, r0, n, dtype=lv["camera.rot"].dtype)
            rgb, _, alpha = trace(sp, pl, o, d, cfg, tau, shadows)
            rgbs.append(rgb)
            alphas.append(alpha)
    return torch.cat(rgbs), torch.cat(alphas)


def loss_and_grads(lv, trained, cfg, tau: float, shadows: bool, target, target_a=None,
                   w_sil: float = 0.0):
    """(loss, {name: gradient}) of mean(((rgb - target) / 255)^2), plus
    w_sil (1 - IoU) of the soft alpha against target_a. A first pass sums
    the loss's terms over the bands; a second takes each band's backward
    of the loss linearised in those sums, which gives the exact gradient."""
    sp, pl = _objects(lv)
    dt = lv["camera.rot"].dtype
    n = 3.0 * cfg.height * cfg.width

    def band(r0, rows):
        o, d = rays(lv["camera.pos"], lv["camera.rot"], cfg, r0, rows, dtype=dt)
        rgb, _, alpha = trace(sp, pl, o, d, cfg, tau, shadows)
        mse = torch.sum(((rgb - target[r0:r0 + rows]) / 255.0) ** 2)
        if not w_sil:
            return mse, None, None
        ta = target_a[r0:r0 + rows]
        return mse, torch.sum(alpha * ta), torch.sum(alpha + ta - alpha * ta)

    with torch.no_grad():
        sums = [band(r0, rows) for r0, rows in _bands(cfg)]
    mse = sum(float(s[0]) for s in sums)
    loss = mse / n
    c_i = c_u = 0.0
    if w_sil:
        inter = sum(float(s[1]) for s in sums)
        union = max(sum(float(s[2]) for s in sums), 1e-6)
        loss += w_sil * (1.0 - inter / union)
        c_i, c_u = -w_sil / union, w_sil * inter / union ** 2
    for r0, rows in _bands(cfg):
        m, i, u = band(r0, rows)
        surrogate = m / n if not w_sil else m / n + c_i * i + c_u * u
        surrogate.backward()
    grads = {k: None if lv[k].grad is None else lv[k].grad.detach().clone() for k in trained}
    for k in trained:
        lv[k].grad = None
    return loss, grads


def needed_gates(lv, cfg, tau: float, lists, tile: int = 16):
    """int32 [T, 2, NS + NP]: row 0 marks, for each tile, the listed spheres
    and live planes whose softmin logit comes within 16 of the pixel's
    largest (the background's included) at some pixel of the tile; row 1
    (shadow occluders) is left empty. A soft kernel's cull takes at least
    these objects."""
    sp, pl = _objects(lv)
    ns, npl = sp.center.shape[0], pl.center.shape[0]
    Ti, Tj = (cfg.height + tile - 1) // tile, (cfg.width + tile - 1) // tile
    need = torch.zeros((Ti, Tj, ns + npl), dtype=torch.bool, device=sp.center.device)
    k, mp, far = cfg.soft_mask_k, cfg.soft_miss_penalty, cfg.far
    with torch.no_grad():
        for ti in range(Ti):
            r0 = ti * tile
            rows = min(tile, cfg.height - r0)
            o, d = rays(lv["camera.pos"], lv["camera.rot"], cfg, r0, rows,
                        dtype=lv["camera.rot"].dtype)
            logits = -torch.cat([_sphere_terms(o, d, sp, k, mp, far)[0],
                                 _plane_terms(o, d, pl, k, mp, far)[0]], -1) / tau
            top = torch.maximum(logits.amax(-1), logits.new_tensor(-far / tau))
            near = (logits - top[..., None]) > -16.0                  # [rows, W, O]
            pad = Tj * tile - cfg.width
            near = torch.nn.functional.pad(near, (0, 0, 0, pad))
            need[ti] = near.reshape(rows, Tj, tile, -1).any(dim=2).any(dim=0)
    need = need.reshape(Ti * Tj, -1)
    listed = torch.zeros((Ti * Tj, ns), dtype=torch.bool, device=need.device)
    n = lists[:, 0, 0].long()
    slots = torch.arange(ns, device=need.device)[None, :] < n[:, None]
    listed.scatter_(1, lists[:, 0, 1:].long(), slots)
    gates = torch.zeros((Ti * Tj, 2, ns + npl), dtype=torch.int32, device=need.device)
    gates[:, 0, :ns] = (need[:, :ns] & listed).int()
    gates[:, 0, ns:] = (need[:, ns:] & (pl.active > 0.5)[None, :]).int()
    return gates
