"""Plain torch reference renderer: the oracle for the kernel path and
`--renderer reference`.

Counterpart: rtwc_tpu/render/reference.py:26-323, formula for formula.
The whole (H, W) ray grid meets every object at once as [H, W, N]
tensors, so this renderer is for small images and tests; the display
path at large sizes runs the kernel (render/hard_kernel.py). The JAX
package's HIGHEST-precision einsums (reference.py:69, :94) are written as
elementwise sums here, so no matmul (and no TF32) is involved.
"""
from __future__ import annotations

import torch

from rtwc_tpu_torch.camera import Camera, camera_rays, projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.mathx import dot, normalize, safe_normalize, tensor_dataclass

# The reference's "no hit" sentinel (RayTracing.h:21); exactly 1e8 in f32.
MISS_DISTANCE = 99999999.0
# FloatEquals epsilon for the plane parallel-ray reject (MyMath.cu:44-47).
_FLT_EPSILON = 1.1920929e-07


@tensor_dataclass
class Framebuffer:
    """Per-pixel render products the heads consume (reference.py:32-56)."""

    rgb: torch.Tensor       # [H, W, 3] f32 0..255, 0 where no hit
    normal: torch.Tensor    # [H, W, 3] f32 unit normal, 0 where no hit
    depth: torch.Tensor     # [H, W] f32 ray t (MISS_DISTANCE on a miss)
    shading: torch.Tensor   # [H, W] f32 dot(normal, (1,0,0))
    hit: torch.Tensor       # [H, W] bool, depth <= far (the display-hit test)
    coverage: torch.Tensor  # [H, W] f32 hit fraction of the cell
    alpha: torch.Tensor     # [H, W] f32, hit as float on the hard paths


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[..., None, :] . b[N, :] -> [..., N] as an elementwise sum."""
    return (a[..., None, 0] * b[:, 0] + a[..., None, 1] * b[:, 1]
            + a[..., None, 2] * b[:, 2])


def intersect_spheres(origin, dirs, spheres):
    """Batched quadric intersection (Sphere.cu:30-68): (t, valid) [..., N]."""
    oc = origin - spheres.center
    a = dot(dirs, dirs)[..., None]
    b = 2.0 * _dot3(dirs, oc)
    c = dot(oc, oc) - spheres.radius ** 2
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv2a = 1.0 / (2.0 * a)
    t1 = (-b + sq) * inv2a
    t2 = (-b - sq) * inv2a
    valid = (disc >= 0.0) & (t1 >= 0.0) & (t2 >= 0.0) & (spheres.active > 0.5)
    t = torch.minimum(t1, t2)
    return torch.where(valid, t, MISS_DISTANCE), valid


def sphere_normals(origin, dirs, t, centers):
    """Outward unit normal at the hit point (Sphere.cu:67)."""
    p = origin + dirs * t[..., None]
    return normalize(p - centers)


def intersect_planes(origin, dirs, planes):
    """Batched finite-rectangle intersection (Plane.cu:38-73)."""
    denom = _dot3(dirs, planes.normal)
    po = planes.center - origin
    num = dot(po, planes.normal)
    safe_denom = torch.where(denom.abs() < _FLT_EPSILON, -1.0, denom)
    t = num / safe_denom
    p = origin + dirs[..., None, :] * t[..., None]
    half_w = planes.width * 0.5
    half_h = planes.height * 0.5
    in_rect = ((p[..., 0] - planes.center[:, 0]).abs() < half_w) & (
        (p[..., 2] - planes.center[:, 2]).abs() < half_h)
    valid = (denom < -_FLT_EPSILON) & (t > 0.0) & in_rect & (planes.active > 0.5)
    return torch.where(valid, t, MISS_DISTANCE), valid


def trace_hard(scene, origin, dirs):
    """Closest hit over all objects (RayTracing.cu:100-136), first index
    wins ties. Returns (t, normal, colour 0..255, shading)."""
    ts_t, _ = intersect_spheres(origin, dirs, scene.spheres)
    tp_t, _ = intersect_planes(origin, dirs, scene.planes)
    t_all = torch.cat([ts_t, tp_t], dim=-1)
    idx = torch.argmin(t_all, dim=-1)
    t = torch.gather(t_all, -1, idx[..., None])[..., 0]

    n_sph = scene.spheres.capacity
    is_sphere = idx < n_sph
    sph_idx = torch.where(is_sphere, idx, 0)
    pl_idx = torch.where(is_sphere, 0, idx - n_sph)

    sph_n = sphere_normals(origin, dirs, t, scene.spheres.center[sph_idx])
    pl_n = scene.planes.normal[pl_idx]
    normal = normalize(torch.where(is_sphere[..., None], sph_n, pl_n))
    color = torch.where(is_sphere[..., None], scene.spheres.color[sph_idx],
                        scene.planes.color[pl_idx])
    shading = normal[..., 0]

    miss = t >= MISS_DISTANCE
    normal = torch.where(miss[..., None], 0.0, normal)
    color = torch.where(miss[..., None], 0.0, color)
    shading = torch.where(miss, 0.0, shading)
    return t, normal, color, shading


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def blinn_phong(object_diffuse, object_specular, point, view_dir, normal,
                config: RenderConfig, light_visibility=None):
    """Blinn-Phong point light (RayTracing.cu:41-79): 1/d^2 attenuation,
    clamped N.L and N.H, shininess, ambient; `light_visibility` scales the
    direct terms."""
    light_dir = _vec(config.light_pos, point) - point
    inv_d2 = 1.0 / dot(light_dir, light_dir)
    light_dir = safe_normalize(light_dir)
    n = safe_normalize(normal)
    v = safe_normalize(view_dir)
    diffuse_i = torch.clamp(dot(n, light_dir), 0.0, 1.0)
    diffuse = _vec(config.light_diffuse_color, point) * (
        diffuse_i * config.light_diffuse_power * inv_d2)[..., None]
    h = safe_normalize(light_dir + v)
    spec_i = torch.clamp(dot(n, h), 0.0, 1.0) ** config.specular_hardness
    specular = _vec(config.light_specular_color, point) * (
        spec_i * config.light_specular_power * inv_d2)[..., None]
    if light_visibility is not None:
        diffuse = diffuse * light_visibility[..., None]
        specular = specular * light_visibility[..., None]
    ambient = config.ambient * object_diffuse
    return ambient + diffuse * object_diffuse + specular * object_specular


def _shadow_visibility(scene, point, config: RenderConfig):
    """Hard shadow: any occluder strictly between the point (offset 1e-3
    toward the light) and the light kills direct light (reference.py:190-224)."""
    to_light = _vec(config.light_pos, point) - point
    dist = torch.sqrt(dot(to_light, to_light))
    d = to_light / dist[..., None]
    o = point + d * 1e-3
    sp, pls = scene.spheres, scene.planes
    oc = o[..., None, :] - sp.center
    b = 2.0 * torch.sum(d[..., None, :] * oc, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - sp.radius ** 2
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b + sq) * 0.5
    t2 = (-b - sq) * 0.5
    s_valid = (disc >= 0.0) & (t1 >= 0.0) & (t2 >= 0.0) & (sp.active > 0.5)
    s_block = s_valid & (torch.minimum(t1, t2) < dist[..., None])

    denom = torch.sum(d[..., None, :] * pls.normal, dim=-1)
    po = pls.center - o[..., None, :]
    num = torch.sum(po * pls.normal, dim=-1)
    safe_denom = torch.where(denom.abs() < _FLT_EPSILON, -1.0, denom)
    pt = num / safe_denom
    pp = o[..., None, :] + d[..., None, :] * pt[..., None]
    in_rect = ((pp[..., 0] - pls.center[:, 0]).abs() < pls.width * 0.5) & (
        (pp[..., 2] - pls.center[:, 2]).abs() < pls.height * 0.5)
    p_block = ((denom < -_FLT_EPSILON) & (pt > 0.0) & in_rect & (pls.active > 0.5)
               & (pt < dist[..., None]))
    blocked = s_block.any(dim=-1) | p_block.any(dim=-1)
    return torch.where(blocked, 0.0, 1.0)


def shade(scene, origin, dirs, t, normal, color, config: RenderConfig):
    """Blinn-Phong and the 0..255 clamp (RayTracing.cu:143-157)."""
    point = origin + dirs * t[..., None]
    view_dir = normalize(-dirs)
    vis = _shadow_visibility(scene, point, config) if config.shadows else None
    shaded = blinn_phong(color / 255.0, _vec(config.object_specular_color, point),
                         point, view_dir, normal, config, light_visibility=vis)
    rgb = torch.clamp(shaded * 255.0, max=255.0)
    miss = t >= MISS_DISTANCE
    return torch.where(miss[..., None], 0.0, rgb)


def supersampled_config(config: RenderConfig) -> RenderConfig:
    """ss x the cell grid with the same frustum (reference.py:255-267)."""
    ss = config.supersample
    if ss <= 1:
        return config
    return config.replace(width=config.width * ss, height=config.height * ss,
                          aspect_coeff=config.aspect_coeff / ss, supersample=1)


def downsample_framebuffer(fb: Framebuffer, ss: int) -> Framebuffer:
    """Box-filter an ss-supersampled framebuffer to the cell grid
    (reference.py:270-306): colour and shading average over display-hit
    subsamples (misses black), normals over hits then renormalised, depth
    over hits only; a cell hits when at least half its subsamples do, and
    `coverage` keeps the exact fraction."""
    if ss <= 1:
        return fb
    H, W = fb.depth.shape
    h, w = H // ss, W // ss

    def pool(x):
        return x.reshape(h, ss, w, ss, *x.shape[2:]).mean(dim=(1, 3))

    hitf = pool(fb.hit.float())
    denom = torch.clamp(hitf, min=1.0 / (ss * ss))
    hit_mask = fb.hit.float()
    depth = torch.where(hitf > 0.0, pool(fb.depth * hit_mask) / denom, MISS_DISTANCE)
    return Framebuffer(
        rgb=pool(fb.rgb * hit_mask[..., None]),
        normal=safe_normalize(pool(fb.normal * hit_mask[..., None])),
        depth=depth,
        shading=pool(fb.shading * hit_mask),
        hit=hitf >= 0.5,
        coverage=hitf,
        alpha=pool(fb.alpha),
    )


def render_frame(scene, camera: Camera, config: RenderConfig) -> Framebuffer:
    """Ray generation -> closest hit -> shade, on the scene's device
    (reference.py:309-323)."""
    e1, e2 = projection_elements(config)
    origin, dirs = camera_rays(camera, config.width, config.height, e1, e2,
                               device=scene.device)
    t, normal, color, shading = trace_hard(scene, origin, dirs)
    rgb = shade(scene, origin, dirs, t, normal, color, config)
    hit = t <= config.far
    return Framebuffer(rgb=rgb, normal=normal, depth=t, shading=shading, hit=hit,
                       coverage=hit.float(), alpha=hit.float())
