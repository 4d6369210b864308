"""Differentiable renderer: soft-min hit blending, in torch with autograd.

Counterpart: rtwc_tpu/render/softmin.py:40-231, formula for formula. Every
hard reject branch of the reference becomes a smooth depth penalty

    t_eff = clip(t, 0, far) + miss_penalty * sum_c softplus(-k * x_c) / k

and the closest hit a temperature-tau softmin over {objects, background at
far}. This module is the plain oracle of the soft kernels
(render/soft_kernel.py) and, with shadows on, of the shadowed kernels
(render/shadow_kernel.py): it materialises [H, W, N] tensors, so it is for
small images.

softplus is written as logaddexp(x, 0), as jax.nn.softplus is;
torch.nn.functional.softplus linearises above threshold=20 and would change
the penalty's value and gradient at large k*x. The JAX package's
HIGHEST-precision einsums are elementwise sums here: no matmul, no TF32.

A missed sphere whose penalised t_eff comes near `far` competes with the
background, and a sphere at whose silhouette the penalty competes with
the objects behind it decides a pixel's weights: there the penalty's
slope amplifies any rounding of the discriminant. So the rays and each
sphere's discriminant are computed in the soft kernels' op order
(render/soft_objects.py `raygen` and `sphere_solve`: 4 (r^2 - q . q) with
q the ray's closest approach to the centre, not b^2 - 4c, whose two terms
of about 4 |oc|^2 cancel there; the JAX package keeps b^2 - 4c). The
oracle and the kernels then agree on those bits on the CPU and on the
card, and differ only where the arithmetic is well conditioned. Run in
float64, the renderer shares no rounding with the kernels; chip_smoke.py
holds the kernel path against it there, on rays it builds from
camera_rays's formula. Its float64 rays use e1 and e2 rounded to float32,
the constants every float32 render receives; the JAX package's float64
rays (camera_rays under jax_enable_x64) round each pixel's cx * e1 and
cy * e2 to float32 instead (rtwc_tpu/camera/camera.py:103-108).
"""
from __future__ import annotations

import torch

from rtwc_tpu_torch.camera import Camera, basis
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.mathx import dot, safe_normalize
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.reference import (
    Framebuffer,
    _FLT_EPSILON,
    _dot3,
    blinn_phong,
    render_frame,
)

_INACTIVE_PENALTY = 1e7  # depth units; removes dead pool slots outright
_TRANS_FLOOR = 1e-7      # per-occluder shadow transmittance floor


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """jnp.maximum(x, c): torch.maximum splits the gradient at a tie as JAX
    does (torch.clamp would pass all of it)."""
    return torch.maximum(x, x.new_tensor(c))


def _min(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(c))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip = minimum(maximum(x, lo), hi), tie gradients included."""
    return _min(_max(x, lo), hi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as logaddexp(x, 0) (jax.nn.softplus)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _penalty(x: torch.Tensor, k: float) -> torch.Tensor:
    """Smooth hinge: ~|x| for x < 0, ~0 for x > 0, ln(2)/k at x = 0."""
    return softplus(-k * x) / k


def _soft_sphere_terms(origin, dirs, spheres, k: float, miss_penalty: float, far: float):
    """Soft sphere intersection: (t_eff [.., N], t_clip [.., N], normal [.., N, 3])."""
    oc = origin - spheres.center                        # [N, 3]
    h, _, _, _, disc = O.sphere_solve(*(dirs[..., None, i] for i in range(3)),
                                      *(oc[:, i] for i in range(3)), spheres.radius)
    b = 2.0 * h                                         # [..., N]
    sq = torch.sqrt(_max(disc, 1e-12))
    t2 = 0.5 * (-b - sq)
    # t1 = t2 + sq >= t2, so penalising t2 covers both hard root tests.
    scale = 1.0 / _max(spheres.radius, 1e-3)
    pen = miss_penalty * (_penalty(disc * scale * scale, k) + _penalty(t2, k)) + torch.where(
        spheres.active > 0.5, 0.0, _INACTIVE_PENALTY)
    t_clip = _clip(t2, 0.0, far)
    p = origin + dirs[..., None, :] * t_clip[..., None]
    n = safe_normalize(p - spheres.center)
    return t_clip + pen, t_clip, n


def _soft_plane_terms(origin, dirs, planes, k: float, miss_penalty: float, far: float):
    """Soft finite-plane intersection."""
    denom = _dot3(dirs, planes.normal)
    po = planes.center - origin
    num = dot(po, planes.normal)
    safe_denom = torch.where(denom.abs() < _FLT_EPSILON, -_FLT_EPSILON, denom)
    t = num / safe_denom
    t_clip = _clip(t, 0.0, far)
    p = origin + dirs[..., None, :] * t_clip[..., None]
    half_w = planes.width * 0.5
    half_h = planes.height * 0.5
    pen = miss_penalty * (
        _penalty(-denom - _FLT_EPSILON, k)
        + _penalty(t, k)
        + _penalty(half_w - (p[..., 0] - planes.center[:, 0]).abs(), k)
        + _penalty(half_h - (p[..., 2] - planes.center[:, 2]).abs(), k)
    ) + torch.where(planes.active > 0.5, 0.0, _INACTIVE_PENALTY)
    n = planes.normal.expand(p.shape)
    return t_clip + pen, t_clip, n


def _soft_shadow_visibility(scene, point, config: RenderConfig):
    """Soft light visibility at `point` [..., 3]: every hard shadow-ray
    reject branch is a sigmoid step of sharpness soft_shadow_k, and the
    any-occluder OR a product of per-occluder transmittances
    vis = prod_j max(1 - block_j, 1e-7), block_j = prod_c sigmoid(k x_c)."""
    ks = config.soft_shadow_k
    sig = torch.sigmoid
    light_pos = torch.tensor(config.light_pos, dtype=torch.float32, device=point.device)
    to_light = light_pos - point
    dist = torch.sqrt(_max(dot(to_light, to_light), 1e-12))
    d = to_light / dist[..., None]
    o = point + d * 1e-2  # self-intersection offset (the hard path uses 1e-3)

    sp = scene.spheres
    oc = o[..., None, :] - sp.center                                 # [..., N, 3]
    b = 2.0 * torch.sum(d[..., None, :] * oc, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - sp.radius ** 2
    disc = b * b - 4.0 * c
    sq = torch.sqrt(_max(disc, 1e-12))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    scale = 1.0 / _max(sp.radius, 1e-3)
    block_s = (sig(ks * disc * scale * scale) * sig(ks * t1) * sig(ks * t2)
               * sig(ks * (dist[..., None] - t2))
               * torch.where(sp.active > 0.5, 1.0, 0.0))

    pl = scene.planes
    denom = torch.sum(d[..., None, :] * pl.normal, dim=-1)           # [..., M]
    num = torch.sum((pl.center - o[..., None, :]) * pl.normal, dim=-1)
    safe_denom = torch.where(denom.abs() < _FLT_EPSILON, -_FLT_EPSILON, denom)
    t = num / safe_denom
    p = o[..., None, :] + d[..., None, :] * t[..., None]
    block_p = (sig(ks * (-denom - _FLT_EPSILON)) * sig(ks * t)
               * sig(ks * (pl.width * 0.5 - (p[..., 0] - pl.center[:, 0]).abs()))
               * sig(ks * (pl.height * 0.5 - (p[..., 2] - pl.center[:, 2]).abs()))
               * sig(ks * (dist[..., None] - t))
               * torch.where(pl.active > 0.5, 1.0, 0.0))

    trans = torch.cat([1.0 - block_s, 1.0 - block_p], dim=-1)
    # The floor keeps vis / trans_j finite in the kernels' closed-form replay.
    trans = _max(trans, _TRANS_FLOOR)
    return torch.prod(trans, dim=-1)


def trace_soft(scene, origin, dirs, config: RenderConfig, tau: float | None = None):
    """Soft closest hit + shading blend. Returns (rgb [.., 3] 0..255,
    depth [..], normal [.., 3], alpha [..]); alpha is 1 - background weight
    and depth blends to `far` for misses."""
    tau = config.soft_tau if tau is None else tau
    if tau <= 0.0:
        raise ValueError("trace_soft needs tau > 0; tau == 0 means the hard renderer (render_frame)")
    k = config.soft_mask_k
    mp = config.soft_miss_penalty
    te_s, tc_s, ns = _soft_sphere_terms(origin, dirs, scene.spheres, k, mp, config.far)
    te_p, tc_p, np_ = _soft_plane_terms(origin, dirs, scene.planes, k, mp, config.far)

    t_eff = torch.cat([te_s, te_p], dim=-1)                          # [..., O]
    t_clip = torch.cat([tc_s, tc_p], dim=-1)
    n_all = torch.cat([ns, np_], dim=-2)                             # [..., O, 3]
    color_all = torch.cat([scene.spheres.color, scene.planes.color], dim=0)

    logits = -t_eff / tau
    bg_logit = torch.full(logits.shape[:-1], -config.far / tau, dtype=logits.dtype,
                          device=logits.device)
    w = torch.softmax(torch.cat([logits, bg_logit[..., None]], dim=-1), dim=-1)
    w_obj, w_bg = w[..., :-1], w[..., -1]

    point = origin + dirs[..., None, :] * t_clip[..., None]          # [..., O, 3]
    view = safe_normalize(-dirs)[..., None, :]
    if config.shadows:
        # one soft occlusion test per ray at the softmin-blended hit point
        depth_blend = torch.sum(w_obj * t_clip, dim=-1) + w_bg * config.far
        point_blend = origin + dirs * depth_blend[..., None]
        vis = _soft_shadow_visibility(scene, point_blend, config)[..., None]
    else:
        vis = None
    ospec = torch.tensor(config.object_specular_color, dtype=torch.float32, device=dirs.device)
    shaded = blinn_phong(color_all / 255.0, ospec, point, view, n_all, config,
                         light_visibility=vis)
    rgb_obj = _min(shaded * 255.0, 255.0)                 # [..., O, 3]

    rgb = torch.sum(w_obj[..., None] * rgb_obj, dim=-2)              # bg adds 0
    depth = torch.sum(w_obj * t_clip, dim=-1) + w_bg * config.far
    normal = torch.sum(w_obj[..., None] * n_all, dim=-2)
    alpha = 1.0 - w_bg
    return rgb, depth, normal, alpha


def _soft_rays(camera: Camera, config: RenderConfig, device):
    """(origin [3], dirs [H, W, 3]): camera_rays's rays, differentiable in
    the pose, computed by the soft kernels' ray generation (module note)."""
    rot = camera.rot.to(device)
    right, up, fwd = basis(rot)
    H, W = config.height, config.width
    dtype = rot.dtype
    rowf = torch.arange(H, dtype=dtype, device=device)[:, None].expand(H, W)
    colf = torch.arange(W, dtype=dtype, device=device)[None, :].expand(H, W)
    c = O.SoftConsts.make(config, 1.0)
    cam9 = (right[0], right[1], right[2], up[0], up[1], up[2], fwd[0], fwd[1], fwd[2])
    dx, dy, dz = O.raygen(c, rowf, colf, cam9)[:3]
    return camera.pos.to(device), torch.stack([dx, dy, dz], dim=-1)


def render_frame_soft(scene, camera: Camera, config: RenderConfig, tau: float | None = None,
                      straight_through: bool = False) -> Framebuffer:
    """Differentiable frame render on the scene's device. With
    straight_through=True the forward pass is the hard reference image
    while gradients flow through the soft path (hard + soft - soft.detach())."""
    origin, dirs = _soft_rays(camera, config, scene.device)
    rgb, depth, normal, alpha = trace_soft(scene, origin, dirs, config, tau=tau)
    if straight_through:
        hard = render_frame(scene, camera, config)
        rgb = hard.rgb + (rgb - rgb.detach())
        depth = _min(hard.depth, config.far) + (depth - depth.detach())
        normal = hard.normal + (normal - normal.detach())
    hit = depth <= config.far * (1.0 - 1e-4)
    return Framebuffer(rgb=rgb, normal=normal, depth=depth, shading=normal[..., 0], hit=hit,
                       coverage=hit.float(), alpha=alpha)
