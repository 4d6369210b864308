"""Per-object soft intersection + shading, shadow-occluder transmittances,
ray generation and two-float sums, with hand-written adjoints: the plain
torch twins of csrc/soft_common.cuh.

Counterpart: rtwc_tpu/render/pallas_soft.py `_make_object_fns` (:99-525,
the object and the shadow functions), `_make_raygen` (:527-554), the raygen
VJP (:1477-1493) and `_two_sum` / `_tf_combine` (:557-568). The JAX kernels
differentiate each object's function with jax.vjp inside the kernel
(:1418, :1446, :1578, :1599, :2286, :2313); CUDA has no autodiff, so
`sphere_f_vjp`, `plane_f_vjp`, `shadow_sphere_f_vjp` and
`shadow_plane_f_vjp` are the reverse sweeps written out, in the op order of
soft_common.cuh. They follow JAX's tie rules, which differ from torch's:
jnp.maximum / jnp.minimum split the gradient 0.5 / 0.5 at a tie, jnp.clip
is maximum-then-minimum, jnp.abs has gradient +1 at 0, rsqrt's derivative
is g * (-0.5 * ans / x) and sqrt's g * (0.5 / ans), and softplus =
logaddexp(z, 0) has derivative exp(z - softplus(z)). The shadow
transmittance's adjoint takes d block / d f_i = -block / f_i for the
product block = 1 / prod_i f_i, so a product that overflows to inf (5
saturated factors) gives block = 0 against finite factors and finite
gradients.

Every function takes tensors that broadcast against each other: an
object's parameters are 0-d tensors (planes) or per-pixel gathers (list
slots), the ray planes are [Hp, Wp]. Divisions are by tensors, not Python
scalars (torch turns `x / scalar` into a multiply by the reciprocal on
CUDA, which is not the kernel's IEEE division).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtwc_tpu_torch.camera import projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render.reference import _FLT_EPSILON


def f32(x: float) -> float:
    """x rounded to float32, as JAX rounds a Python constant in an f32 op."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SoftConsts:
    """The render constants of one soft launch, each rounded to f32 (the
    values the CUDA kernels receive in their params struct)."""

    far: float
    k: float
    mp: float
    light: tuple
    ldc: tuple
    lsc: tuple
    osc: tuple
    dpow: float
    spow: float
    hard: int
    amb: float
    inv_tau: float
    bg_logit: float
    width: int
    height: int
    e1: float
    e2: float
    ks: float        # soft_shadow_k
    sh_floor: float  # -16 / ks: the occluder gates' relevance floor

    @classmethod
    def make(cls, config: RenderConfig, tau: float) -> "SoftConsts":
        e1, e2 = projection_elements(config)
        v3 = lambda v: tuple(f32(x) for x in v)  # noqa: E731
        return cls(far=f32(config.far), k=f32(config.soft_mask_k),
                   mp=f32(config.soft_miss_penalty), light=v3(config.light_pos),
                   ldc=v3(config.light_diffuse_color), lsc=v3(config.light_specular_color),
                   osc=v3(config.object_specular_color),
                   dpow=f32(config.light_diffuse_power), spow=f32(config.light_specular_power),
                   hard=int(config.specular_hardness), amb=f32(config.ambient),
                   inv_tau=f32(1.0 / tau), bg_logit=f32(-config.far / tau),
                   width=int(config.width), height=int(config.height),
                   e1=f32(e1), e2=f32(e2), ks=f32(config.soft_shadow_k),
                   sh_floor=f32(-16.0 / config.soft_shadow_k))


EPS = f32(_FLT_EPSILON)
INV_255 = f32(1.0 / 255.0)
TRANS_FLOOR = f32(1e-7)   # per-occluder transmittance floor (pallas_soft.py:72)
SHADOW_OFFSET = f32(1e-2)  # the shadow ray's self-intersection offset


# -- elementwise pieces and JAX's tie rules ----------------------------------

def _t(like: torch.Tensor, v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def rsqrt(x):
    """1 / sqrt(x), correctly rounded (soft_common.cuh rsqrt_): the same bits
    on the CPU and the card, where torch.rsqrt is the hardware approximation."""
    return 1.0 / torch.sqrt(x)


def softplus(z):
    return torch.logaddexp(z, torch.zeros_like(z))


def pen(c: SoftConsts, x):
    """softplus(-k x) / k."""
    return softplus(-c.k * x) / _t(x, c.k)


def pen_vjp(c: SoftConsts, x, ct):
    """Cotangent of x from the cotangent of pen(x)."""
    z = -c.k * x
    return ct / _t(x, c.k) * torch.exp(z - softplus(z)) * (-c.k)


def max_grad(x, v: float):
    """d maximum(x, v) / dx: 1 above, 0.5 at the tie, 0 below."""
    return torch.where(x > v, 1.0, torch.where(x == v, 0.5, 0.0))


def min_grad(x, v: float):
    """d minimum(x, v) / dx."""
    return torch.where(x < v, 1.0, torch.where(x == v, 0.5, 0.0))


def clip_grad(x, lo: float, hi: float):
    """d clip(x, lo, hi) / dx with clip = minimum(maximum(x, lo), hi)."""
    return max_grad(x, lo) * min_grad(torch.clamp(x, min=lo), hi)


def abs_grad(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def clip(x, lo: float, hi: float):
    return torch.clamp(torch.clamp(x, min=lo), max=hi)


def pow_int(x, n: int):
    """x**n by repeated squaring (pallas_kernel.py:51-61)."""
    result = None
    bit = x
    while n:
        if n & 1:
            result = bit if result is None else result * bit
        n >>= 1
        if n:
            bit = bit * bit
    return result if result is not None else torch.ones_like(x)


def dpow_int(x, n: int):
    """d x**n / dx = n * x**(n-1)."""
    if n == 0:
        return torch.zeros_like(x)
    return pow_int(x, n - 1) * float(n)


# -- shading -----------------------------------------------------------------

def shade_terms(c: SoftConsts, px, py, pz, nx, ny, nz, dx, dy, dz):
    """(dterm, sterm): the colour-independent Blinn-Phong terms."""
    lx, ly, lz = c.light
    ldx0, ldy0, ldz0 = lx - px, ly - py, lz - pz
    d2 = ldx0 * ldx0 + ldy0 * ldy0 + ldz0 * ldz0
    il = rsqrt(torch.clamp(d2, min=1e-20))
    inv_d2 = il * il
    ldx, ldy, ldz = ldx0 * il, ldy0 * il, ldz0 * il
    di = clip(nx * ldx + ny * ldy + nz * ldz, 0.0, 1.0)
    dterm = di * c.dpow * inv_d2
    hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
    ih = rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    si = clip((nx * hx + ny * hy + nz * hz) * ih, 0.0, 1.0)
    sterm = pow_int(si, c.hard) * c.spow * inv_d2
    return dterm, sterm


def parts_from_terms(c: SoftConsts, dterm, sterm, cr, cg, cb):
    """((A_r, B_r), (A_g, B_g), (A_b, B_b)) in the 0..255 domain."""
    out = []
    for col, ld, ls, os_ in zip((cr, cg, cb), c.ldc, c.lsc, c.osc):
        cd = col * INV_255
        out.append((c.amb * cd * 255.0, (dterm * ld * cd + sterm * ls * os_) * 255.0))
    return tuple(out)


def shade(c: SoftConsts, cr, cg, cb, px, py, pz, nx, ny, nz, dx, dy, dz, vis=None):
    """min(255, A + B), or min(255, A + vis * B) with shadows."""
    dterm, sterm = shade_terms(c, px, py, pz, nx, ny, nz, dx, dy, dz)
    return tuple(torch.clamp(a + (b if vis is None else vis * b), max=255.0)
                 for a, b in parts_from_terms(c, dterm, sterm, cr, cg, cb))


def shade_vjp(c: SoftConsts, col, p, n, d, ct_rgb, vis=None):
    """Reverse of `shade`: returns (ct_col[3], ct_p[3], ct_n[3], ct_d[3]);
    vis is a constant here."""
    cr, cg, cb = col
    px, py, pz = p
    nx, ny, nz = n
    dx, dy, dz = d
    lx, ly, lz = c.light
    # forward, keeping the intermediates
    ldx0, ldy0, ldz0 = lx - px, ly - py, lz - pz
    d2 = ldx0 * ldx0 + ldy0 * ldy0 + ldz0 * ldz0
    d2m = torch.clamp(d2, min=1e-20)
    il = rsqrt(d2m)
    inv_d2 = il * il
    ldx, ldy, ldz = ldx0 * il, ldy0 * il, ldz0 * il
    ndl = nx * ldx + ny * ldy + nz * ldz
    di = clip(ndl, 0.0, 1.0)
    dterm = di * c.dpow * inv_d2
    hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
    hh = hx * hx + hy * hy + hz * hz
    hhm = torch.clamp(hh, min=1e-20)
    ih = rsqrt(hhm)
    q = nx * hx + ny * hy + nz * hz
    ndh = q * ih
    si = clip(ndh, 0.0, 1.0)
    pw = pow_int(si, c.hard)
    sterm = pw * c.spow * inv_d2
    # reverse of parts + the 255 clamp
    ct_dterm = torch.zeros_like(dterm)
    ct_sterm = torch.zeros_like(sterm)
    ct_col = []
    for colv, ld, ls, os_, ct in zip((cr, cg, cb), c.ldc, c.lsc, c.osc, ct_rgb):
        cd = colv * INV_255
        b = (dterm * ld * cd + sterm * ls * os_) * 255.0
        v = c.amb * cd * 255.0 + (b if vis is None else vis * b)
        g = ct * min_grad(v, 255.0)
        ct_bin = (g if vis is None else g * vis) * 255.0
        ct_dterm = ct_dterm + ct_bin * cd * ld
        ct_sterm = ct_sterm + ct_bin * os_ * ls
        ct_cd = g * 255.0 * c.amb + ct_bin * (dterm * ld)
        ct_col.append(ct_cd * INV_255)
    # reverse of shade_terms
    ct_inv_d2 = ct_sterm * (pw * c.spow)
    ct_si = ct_sterm * inv_d2 * c.spow * dpow_int(si, c.hard)
    ct_ndh = ct_si * clip_grad(ndh, 0.0, 1.0)
    ct_q = ct_ndh * ih
    ct_hh = ct_ndh * q * (-0.5 * (ih / hhm)) * max_grad(hh, 1e-20)
    ct_hx = ct_q * nx + ct_hh * hx * 2.0
    ct_hy = ct_q * ny + ct_hh * hy * 2.0
    ct_hz = ct_q * nz + ct_hh * hz * 2.0
    ct_inv_d2 = ct_inv_d2 + ct_dterm * (di * c.dpow)
    ct_ndl = ct_dterm * inv_d2 * c.dpow * clip_grad(ndl, 0.0, 1.0)
    ct_nx = ct_q * hx + ct_ndl * ldx
    ct_ny = ct_q * hy + ct_ndl * ldy
    ct_nz = ct_q * hz + ct_ndl * ldz
    ct_ldx = ct_hx + ct_ndl * nx
    ct_ldy = ct_hy + ct_ndl * ny
    ct_ldz = ct_hz + ct_ndl * nz
    ct_il = ct_ldx * ldx0 + ct_ldy * ldy0 + ct_ldz * ldz0 + ct_inv_d2 * il * 2.0
    ct_d2 = ct_il * (-0.5 * (il / d2m)) * max_grad(d2, 1e-20)
    ct_p = (-(ct_ldx * il + ct_d2 * ldx0 * 2.0),
            -(ct_ldy * il + ct_d2 * ldy0 * 2.0),
            -(ct_ldz * il + ct_d2 * ldz0 * 2.0))
    return tuple(ct_col), ct_p, (ct_nx, ct_ny, ct_nz), (-ct_hx, -ct_hy, -ct_hz)


# -- spheres -----------------------------------------------------------------

def sphere_solve(dx, dy, dz, ocx, ocy, ocz, r):
    """(h, qx, qy, qz, disc): h = d . oc, q = oc - h d and the discriminant
    4 (r^2 - q . q), free of b^2 - 4c's cancellation at silhouettes and near
    misses (soft_common.cuh `sphere_solve`)."""
    h = dx * ocx + dy * ocy + dz * ocz
    qx, qy, qz = ocx - h * dx, ocy - h * dy, ocz - h * dz
    return h, qx, qy, qz, 4.0 * (r * r - (qx * qx + qy * qy + qz * qz))


def sphere_lb_ex(c: SoftConsts, scx, scy, scz, r, dx, dy, dz, ox, oy, oz):
    """(lb, t2, dss): the culling lower bound on t_eff and the solve
    products sphere_f_post continues from."""
    h, _, _, _, disc = sphere_solve(dx, dy, dz, ox - scx, oy - scy, oz - scz, r)
    b = 2.0 * h
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t2 = 0.5 * (-b - sq)
    scale = 1.0 / torch.clamp(r, min=1e-3)
    dss = disc * scale * scale
    lb = clip(t2, 0.0, c.far) + c.mp * (torch.clamp(-dss, min=0.0) + torch.clamp(-t2, min=0.0))
    return lb, t2, dss


def sphere_geo_post(c: SoftConsts, scx, scy, scz, t2, dss, dx, dy, dz, ox, oy, oz):
    """(t_eff, t_clip, nx, ny, nz, px, py, pz) from the solve products."""
    p_ = c.mp * (pen(c, dss) + pen(c, t2))
    t_clip = clip(t2, 0.0, c.far)
    px, py, pz = ox + dx * t_clip, oy + dy * t_clip, oz + dz * t_clip
    nxr, nyr, nzr = px - scx, py - scy, pz - scz
    inn = rsqrt(torch.clamp(nxr * nxr + nyr * nyr + nzr * nzr, min=1e-20))
    return t_clip + p_, t_clip, nxr * inn, nyr * inn, nzr * inn, px, py, pz


def sphere_geo(c: SoftConsts, scx, scy, scz, r, dx, dy, dz, ox, oy, oz):
    _, t2, dss = sphere_lb_ex(c, scx, scy, scz, r, dx, dy, dz, ox, oy, oz)
    return sphere_geo_post(c, scx, scy, scz, t2, dss, dx, dy, dz, ox, oy, oz)


def sphere_f_post(c: SoftConsts, scx, scy, scz, t2, dss, cr, cg, cb, dx, dy, dz, ox, oy, oz,
                  vis=None):
    t_eff, t_clip, nx, ny, nz, px, py, pz = sphere_geo_post(
        c, scx, scy, scz, t2, dss, dx, dy, dz, ox, oy, oz)
    r_, g_, b_ = shade(c, cr, cg, cb, px, py, pz, nx, ny, nz, dx, dy, dz, vis)
    return t_eff, r_, g_, b_, t_clip, nx, ny, nz


def sphere_f(c: SoftConsts, scx, scy, scz, r, cr, cg, cb, dx, dy, dz, ox, oy, oz, vis=None):
    """(t_eff, r, g, b, t_clip, nx, ny, nz) of one sphere."""
    _, t2, dss = sphere_lb_ex(c, scx, scy, scz, r, dx, dy, dz, ox, oy, oz)
    return sphere_f_post(c, scx, scy, scz, t2, dss, cr, cg, cb, dx, dy, dz, ox, oy, oz, vis)


def sphere_f_vjp(c: SoftConsts, scx, scy, scz, r, cr, cg, cb, dx, dy, dz, ox, oy, oz, cts,
                 vis=None):
    """Cotangents of sphere_f's 13 inputs from the cotangents `cts` of its
    8 outputs (per pixel; scalar inputs are summed over pixels by the
    caller, as JAX's transpose of a broadcast does)."""
    ct_teff, ct_r, ct_g, ct_b, ct_tc, ct_nxo, ct_nyo, ct_nzo = cts
    ocx, ocy, ocz = ox - scx, oy - scy, oz - scz
    h, qx, qy, qz, disc = sphere_solve(dx, dy, dz, ocx, ocy, ocz, r)
    b = 2.0 * h
    dm = torch.clamp(disc, min=1e-12)
    sq = torch.sqrt(dm)
    t2 = 0.5 * (-b - sq)
    rm = torch.clamp(r, min=1e-3)
    scale = 1.0 / rm
    u = disc * scale
    dss = u * scale
    t_clip = clip(t2, 0.0, c.far)
    px, py, pz = ox + dx * t_clip, oy + dy * t_clip, oz + dz * t_clip
    nxr, nyr, nzr = px - scx, py - scy, pz - scz
    nn = nxr * nxr + nyr * nyr + nzr * nzr
    nnm = torch.clamp(nn, min=1e-20)
    inn = rsqrt(nnm)
    nx, ny, nz = nxr * inn, nyr * inn, nzr * inn

    ct_col, ct_p, ct_ns, ct_d = shade_vjp(c, (cr, cg, cb), (px, py, pz), (nx, ny, nz),
                                          (dx, dy, dz), (ct_r, ct_g, ct_b), vis)
    ct_nx, ct_ny, ct_nz = ct_nxo + ct_ns[0], ct_nyo + ct_ns[1], ct_nzo + ct_ns[2]
    ct_inn = ct_nx * nxr + ct_ny * nyr + ct_nz * nzr
    ct_nn = ct_inn * (-0.5 * (inn / nnm)) * max_grad(nn, 1e-20)
    ct_nxr = ct_nx * inn + ct_nn * nxr * 2.0
    ct_nyr = ct_ny * inn + ct_nn * nyr * 2.0
    ct_nzr = ct_nz * inn + ct_nn * nzr * 2.0
    ct_px, ct_py, ct_pz = ct_p[0] + ct_nxr, ct_p[1] + ct_nyr, ct_p[2] + ct_nzr
    ct_tclip = ct_teff + ct_tc + (ct_px * dx + ct_py * dy + ct_pz * dz)
    ct_t2 = ct_tclip * clip_grad(t2, 0.0, c.far)
    ct_pen = ct_teff * c.mp
    ct_dss = pen_vjp(c, dss, ct_pen)
    ct_t2 = ct_t2 + pen_vjp(c, t2, ct_pen)
    ct_u = ct_dss * scale
    ct_scale = ct_dss * u + ct_u * disc
    ct_r_ = -ct_scale / (rm * rm) * max_grad(r, 1e-3)
    ct_sq = -0.5 * ct_t2
    ct_disc = ct_u * scale + ct_sq * (0.5 / sq) * max_grad(disc, 1e-12)
    ct_w = 4.0 * ct_disc  # w = r^2 - q . q
    ct_r_ = ct_r_ + ct_w * r * 2.0
    ct_qx, ct_qy, ct_qz = -ct_w * qx * 2.0, -ct_w * qy * 2.0, -ct_w * qz * 2.0
    ct_h = 2.0 * (-0.5 * ct_t2) - (ct_qx * dx + ct_qy * dy + ct_qz * dz)
    ct_ocx = ct_h * dx + ct_qx
    ct_ocy = ct_h * dy + ct_qy
    ct_ocz = ct_h * dz + ct_qz
    return (-(ct_nxr + ct_ocx), -(ct_nyr + ct_ocy), -(ct_nzr + ct_ocz), ct_r_,
            ct_col[0], ct_col[1], ct_col[2],
            ct_d[0] + ct_px * t_clip + ct_h * ocx - ct_qx * h,
            ct_d[1] + ct_py * t_clip + ct_h * ocy - ct_qy * h,
            ct_d[2] + ct_pz * t_clip + ct_h * ocz - ct_qz * h,
            ct_px + ct_ocx, ct_py + ct_ocy, ct_pz + ct_ocz)


# -- planes ------------------------------------------------------------------

def plane_lb_ex(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, dx, dy, dz, ox, oy, oz):
    """(lb, t, denom, px, pz): the culling bound and the solve products."""
    denom = dx * pnx + dy * pny + dz * pnz
    num = (pcx - ox) * pnx + (pcy - oy) * pny + (pcz - oz) * pnz
    safe = torch.where(denom.abs() < EPS, -EPS, denom)
    t = num / safe
    t_clip = clip(t, 0.0, c.far)
    px = ox + dx * t_clip
    pz = oz + dz * t_clip
    lb = t_clip + c.mp * (torch.clamp(denom + EPS, min=0.0) + torch.clamp(-t, min=0.0)
                          + torch.clamp((px - pcx).abs() - hw, min=0.0)
                          + torch.clamp((pz - pcz).abs() - hh, min=0.0))
    return lb, t, denom, px, pz


def plane_unit_n(pnx, pny, pnz):
    pn_inv = rsqrt(torch.clamp(pnx * pnx + pny * pny + pnz * pnz, min=1e-20))
    return pnx * pn_inv, pny * pn_inv, pnz * pn_inv


def plane_geo_post(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom, px, pz,
                   dx, dy, dz, ox, oy, oz):
    """(t_eff, t_clip, nx, ny, nz, px, py, pz), with the raw plane normal
    (what the framebuffer blends; shading uses plane_unit_n)."""
    t_clip = clip(t, 0.0, c.far)
    py = oy + dy * t_clip
    p_ = c.mp * (pen(c, -denom - EPS) + pen(c, t) + pen(c, hw - (px - pcx).abs())
                 + pen(c, hh - (pz - pcz).abs()))
    zero = torch.zeros_like(t)
    return t_clip + p_, t_clip, pnx + zero, pny + zero, pnz + zero, px, py, pz


def plane_geo(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, dx, dy, dz, ox, oy, oz):
    _, t, denom, px, pz = plane_lb_ex(c, pcx, pcy, pcz, pnx, pny, pnz, hw, hh,
                                      dx, dy, dz, ox, oy, oz)
    return plane_geo_post(c, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom, px, pz,
                          dx, dy, dz, ox, oy, oz)


def plane_f_post(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom, px, pz,
                 cr, cg, cb, dx, dy, dz, ox, oy, oz, vis=None):
    t_eff, t_clip, nx, ny, nz, px, py, pz = plane_geo_post(
        c, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom, px, pz, dx, dy, dz, ox, oy, oz)
    ux, uy, uz = plane_unit_n(pnx, pny, pnz)
    r_, g_, b_ = shade(c, cr, cg, cb, px, py, pz, ux, uy, uz, dx, dy, dz, vis)
    return t_eff, r_, g_, b_, t_clip, nx, ny, nz


def plane_f(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, cr, cg, cb,
            dx, dy, dz, ox, oy, oz, vis=None):
    _, t, denom, px, pz = plane_lb_ex(c, pcx, pcy, pcz, pnx, pny, pnz, hw, hh,
                                      dx, dy, dz, ox, oy, oz)
    return plane_f_post(c, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, t, denom, px, pz,
                        cr, cg, cb, dx, dy, dz, ox, oy, oz, vis)


def plane_f_vjp(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, cr, cg, cb,
                dx, dy, dz, ox, oy, oz, cts, vis=None):
    """Cotangents of plane_f's 17 inputs from its 8 output cotangents."""
    ct_teff, ct_r, ct_g, ct_b, ct_tc, ct_nxo, ct_nyo, ct_nzo = cts
    denom = dx * pnx + dy * pny + dz * pnz
    wx, wy, wz = pcx - ox, pcy - oy, pcz - oz
    num = wx * pnx + wy * pny + wz * pnz
    small = denom.abs() < EPS
    safe = torch.where(small, -EPS, denom)
    t = num / safe
    t_clip = clip(t, 0.0, c.far)
    px, py, pz = ox + dx * t_clip, oy + dy * t_clip, oz + dz * t_clip
    a1 = -denom - EPS
    ex, ez = px - pcx, pz - pcz
    a3 = hw - ex.abs()
    a4 = hh - ez.abs()
    pn2 = pnx * pnx + pny * pny + pnz * pnz
    pn2m = torch.clamp(pn2, min=1e-20)
    pi = rsqrt(pn2m)
    ux, uy, uz = pnx * pi, pny * pi, pnz * pi

    ct_col, ct_p, ct_u, ct_d = shade_vjp(c, (cr, cg, cb), (px, py, pz), (ux, uy, uz),
                                         (dx, dy, dz), (ct_r, ct_g, ct_b), vis)
    ct_pi = ct_u[0] * pnx + ct_u[1] * pny + ct_u[2] * pnz
    ct_pn2 = ct_pi * (-0.5 * (pi / pn2m)) * max_grad(pn2, 1e-20)
    ct_pen = ct_teff * c.mp
    ct_a1 = pen_vjp(c, a1, ct_pen)
    ct_a3 = pen_vjp(c, a3, ct_pen)
    ct_a4 = pen_vjp(c, a4, ct_pen)
    ct_ex = -ct_a3 * abs_grad(ex)
    ct_ez = -ct_a4 * abs_grad(ez)
    ct_px = ct_p[0] + ct_ex
    ct_py = ct_p[1]
    ct_pz = ct_p[2] + ct_ez
    ct_tclip = ct_teff + ct_tc + (ct_px * dx + ct_py * dy + ct_pz * dz)
    ct_t = pen_vjp(c, t, ct_pen) + ct_tclip * clip_grad(t, 0.0, c.far)
    ct_num = ct_t / safe
    ct_safe = -ct_t * num / (safe * safe)
    ct_denom = torch.where(small, 0.0, ct_safe) - ct_a1
    return (ct_num * pnx - ct_ex, ct_num * pny, ct_num * pnz - ct_ez,
            ct_nxo + ct_u[0] * pi + ct_pn2 * pnx * 2.0 + ct_num * wx + ct_denom * dx,
            ct_nyo + ct_u[1] * pi + ct_pn2 * pny * 2.0 + ct_num * wy + ct_denom * dy,
            ct_nzo + ct_u[2] * pi + ct_pn2 * pnz * 2.0 + ct_num * wz + ct_denom * dz,
            ct_a3, ct_a4,
            ct_col[0], ct_col[1], ct_col[2],
            ct_d[0] + ct_px * t_clip + ct_denom * pnx,
            ct_d[1] + ct_py * t_clip + ct_denom * pny,
            ct_d[2] + ct_pz * t_clip + ct_denom * pnz,
            ct_px - ct_num * pnx, ct_py - ct_num * pny, ct_pz - ct_num * pnz)


# -- shadow occluders --------------------------------------------------------

def light_ray(c: SoftConsts, px, py, pz):
    """(sdx, sdy, sdz, dist, sox, soy, soz): the unit direction to the light,
    its distance and the offset shadow-ray origin at the hit point p."""
    lx, ly, lz = c.light
    tlx, tly, tlz = lx - px, ly - py, lz - pz
    d2 = torch.clamp(tlx * tlx + tly * tly + tlz * tlz, min=1e-12)
    inv = rsqrt(d2)
    sdx, sdy, sdz = tlx * inv, tly * inv, tlz * inv
    return (sdx, sdy, sdz, d2 * inv,
            px + sdx * SHADOW_OFFSET, py + sdy * SHADOW_OFFSET, pz + sdz * SHADOW_OFFSET)


def light_ray_vjp(c: SoftConsts, px, py, pz, ct_sd, ct_dist, ct_so):
    """Cotangent of the hit point from those of light_ray's sd, dist, so."""
    lx, ly, lz = c.light
    tlx, tly, tlz = lx - px, ly - py, lz - pz
    d2r = tlx * tlx + tly * tly + tlz * tlz
    d2 = torch.clamp(d2r, min=1e-12)
    inv = rsqrt(d2)
    cs = [a + b * SHADOW_OFFSET for a, b in zip(ct_sd, ct_so)]
    ct_inv = ct_dist * d2 + (cs[0] * tlx + cs[1] * tly + cs[2] * tlz)
    ct_d2r = (ct_dist * inv + ct_inv * (-0.5 * (inv / d2))) * max_grad(d2r, 1e-12)
    return tuple(so - (cv * inv + ct_d2r * tl * 2.0)
                 for so, cv, tl in zip(ct_so, cs, (tlx, tly, tlz)))


def blocked(c: SoftConsts, args):
    """prod_i sigmoid(ks a_i) = 1 / prod_i (1 + exp(min(-ks a_i, 20)))."""
    P = None
    for a in args:
        f = 1.0 + torch.exp(torch.clamp(-c.ks * a, max=20.0))
        P = f if P is None else P * f
    return 1.0 / P


def shadow_transmittance(c: SoftConsts, args):
    return torch.clamp(1.0 - blocked(c, args), min=TRANS_FLOOR)


def transmittance_vjp(c: SoftConsts, args, ct):
    """Cotangents of the sigmoid arguments from the transmittance's."""
    z = [-c.ks * a for a in args]
    e = [torch.exp(torch.clamp(zi, max=20.0)) for zi in z]
    f = [1.0 + ei for ei in e]
    P = f[0]
    for fi in f[1:]:
        P = P * fi
    block = 1.0 / P
    ct_block = -(ct * max_grad(1.0 - block, TRANS_FLOOR))
    return [-ct_block * block / fi * ei * min_grad(zi, 20.0) * (-c.ks)
            for zi, ei, fi in zip(z, e, f)]


def shadow_sphere_preA(c: SoftConsts, scx, scy, scz, r, lr):
    """Stage A of the split sphere gate, no root: (disc, dss, b, dist)."""
    sdx, sdy, sdz, dist, sox, soy, soz = lr
    ocx, ocy, ocz = sox - scx, soy - scy, soz - scz
    b = 2.0 * (sdx * ocx + sdy * ocy + sdz * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - 4.0 * cc
    scale = 1.0 / torch.clamp(r, min=1e-3)
    return disc, disc * scale * scale, b, dist


def shadow_sphere_preB(disc, dss, b, dist):
    """Stage B: (min_arg, the four sigmoid arguments)."""
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    args = (dss, t1, t2, dist - t2)
    return torch.minimum(torch.minimum(args[0], args[3]), torch.minimum(t1, t2)), args


def shadow_sphere_pre(c: SoftConsts, scx, scy, scz, r, lr):
    """The whole sphere solve, written out (preB of preA, op for op)."""
    sdx, sdy, sdz, dist, sox, soy, soz = lr
    ocx, ocy, ocz = sox - scx, soy - scy, soz - scz
    b = 2.0 * (sdx * ocx + sdy * ocy + sdz * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - 4.0 * cc
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    scale = 1.0 / torch.clamp(r, min=1e-3)
    args = (disc * scale * scale, t1, t2, dist - t2)
    return torch.minimum(torch.minimum(args[0], args[3]), torch.minimum(t1, t2)), args


def shadow_plane_pre(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, lr):
    """(min_arg, the five sigmoid arguments) of a plane occluder."""
    sdx, sdy, sdz, dist, sox, soy, soz = lr
    denom = sdx * pnx + sdy * pny + sdz * pnz
    num = (pcx - sox) * pnx + (pcy - soy) * pny + (pcz - soz) * pnz
    safe = torch.where(denom.abs() < EPS, -EPS, denom)
    t = num / safe
    ppx = sox + sdx * t
    ppz = soz + sdz * t
    args = (-denom - EPS, t, hw - (ppx - pcx).abs(), hh - (ppz - pcz).abs(), dist - t)
    return torch.minimum(torch.minimum(args[0], args[1]),
                         torch.minimum(torch.minimum(args[2], args[3]), args[4])), args


def shadow_sphere_f(c: SoftConsts, scx, scy, scz, r, px, py, pz):
    """Transmittance 1 - block in [TRANS_FLOOR, 1] of a sphere occluder at p."""
    return shadow_transmittance(c, shadow_sphere_pre(c, scx, scy, scz, r,
                                                     light_ray(c, px, py, pz))[1])


def shadow_plane_f(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, px, py, pz):
    return shadow_transmittance(c, shadow_plane_pre(c, pcx, pcy, pcz, pnx, pny, pnz, hw, hh,
                                                    light_ray(c, px, py, pz))[1])


def shadow_sphere_f_vjp(c: SoftConsts, scx, scy, scz, r, px, py, pz, ct):
    """Cotangents of shadow_sphere_f's 7 inputs (cx, cy, cz, r, px, py, pz)."""
    sdx, sdy, sdz, dist, sox, soy, soz = light_ray(c, px, py, pz)
    ocx, ocy, ocz = sox - scx, soy - scy, soz - scz
    b = 2.0 * (sdx * ocx + sdy * ocy + sdz * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - 4.0 * cc
    sq = torch.sqrt(torch.clamp(disc, min=1e-12))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    rm = torch.clamp(r, min=1e-3)
    scale = 1.0 / rm
    u = disc * scale
    ct_a = transmittance_vjp(c, (u * scale, t1, t2, dist - t2), ct)
    ct_t2 = ct_a[2] - ct_a[3]
    ct_u = ct_a[0] * scale
    ct_scale = ct_a[0] * u + ct_u * disc
    ct_r = -ct_scale / (rm * rm) * max_grad(r, 1e-3)
    ct_sq = 0.5 * ct_a[1] - 0.5 * ct_t2
    ct_disc = ct_u * scale + ct_sq * (0.5 / sq) * max_grad(disc, 1e-12)
    ct_b = (-0.5 * ct_a[1] - 0.5 * ct_t2) + ct_disc * b * 2.0
    ct_c = -4.0 * ct_disc
    ct_r = ct_r - ct_c * r * 2.0
    ct_dot = 2.0 * ct_b
    ct_oc = (ct_dot * sdx + ct_c * ocx * 2.0, ct_dot * sdy + ct_c * ocy * 2.0,
             ct_dot * sdz + ct_c * ocz * 2.0)
    ct_p = light_ray_vjp(c, px, py, pz, (ct_dot * ocx, ct_dot * ocy, ct_dot * ocz), ct_a[3],
                         ct_oc)
    return (-ct_oc[0], -ct_oc[1], -ct_oc[2], ct_r) + ct_p


def shadow_plane_f_vjp(c: SoftConsts, pcx, pcy, pcz, pnx, pny, pnz, hw, hh, px, py, pz, ct):
    """Cotangents of shadow_plane_f's 11 inputs (cx, cy, cz, nx, ny, nz, hw,
    hh, px, py, pz)."""
    sdx, sdy, sdz, dist, sox, soy, soz = light_ray(c, px, py, pz)
    denom = sdx * pnx + sdy * pny + sdz * pnz
    wx, wy, wz = pcx - sox, pcy - soy, pcz - soz
    num = wx * pnx + wy * pny + wz * pnz
    small = denom.abs() < EPS
    safe = torch.where(small, -EPS, denom)
    t = num / safe
    ex = sox + sdx * t - pcx
    ez = soz + sdz * t - pcz
    ct_a = transmittance_vjp(c, (-denom - EPS, t, hw - ex.abs(), hh - ez.abs(), dist - t), ct)
    ct_ex = -ct_a[2] * abs_grad(ex)
    ct_ez = -ct_a[3] * abs_grad(ez)
    ct_t = ct_a[1] - ct_a[4] + ct_ex * sdx + ct_ez * sdz
    ct_num = ct_t / safe
    ct_safe = -ct_t * num / (safe * safe)
    ct_denom = torch.where(small, 0.0, ct_safe) - ct_a[0]
    ct_p = light_ray_vjp(c, px, py, pz,
                         (ct_ex * t + ct_denom * pnx, ct_denom * pny, ct_ez * t + ct_denom * pnz),
                         ct_a[4], (ct_ex - ct_num * pnx, -ct_num * pny, ct_ez - ct_num * pnz))
    return (ct_num * pnx - ct_ex, ct_num * pny, ct_num * pnz - ct_ez,
            ct_num * wx + ct_denom * sdx, ct_num * wy + ct_denom * sdy,
            ct_num * wz + ct_denom * sdz, ct_a[2], ct_a[3]) + ct_p


# -- ray generation ----------------------------------------------------------

def raygen(c: SoftConsts, rowf, colf, cam9):
    """(dx, dy, dz, vx, vy, inv) for image rows / columns `rowf` / `colf`
    (f32 tensors) from the nine basis scalars (rx, ry, rz, ux, ..., fz)."""
    rx, ry, rz, ux, uy, uz, fx, fy, fz = cam9
    vx = (2.0 * colf - c.width) / _t(colf, c.width) * c.e1
    vy = (c.height - 2.0 * rowf) / _t(rowf, c.height) * c.e2
    dx = rx * vx + ry * vy + rz
    dy = ux * vx + uy * vy + uz
    dz = fx * vx + fy * vy + fz
    inv = rsqrt(dx * dx + dy * dy + dz * dz)
    return dx * inv, dy * inv, dz * inv, vx, vy, inv


def raygen_vjp(gdx, gdy, gdz, dx, dy, dz, vx, vy, inv):
    """Per-pixel cotangents of the nine basis scalars, in cam order
    (rx, ry, rz, ux, uy, uz, fx, fy, fz), from the ray cotangents:
    d = p * rsqrt(p.p) => dL/dp = inv * (g - (g.d) d), p = B v."""
    sd = gdx * dx + gdy * dy + gdz * dz
    out = []
    for g, d in ((gdx, dx), (gdy, dy), (gdz, dz)):
        gp = inv * (g - d * sd)
        out += [gp * vx, gp * vy, gp]
    return tuple(out)


# -- two-float arithmetic ----------------------------------------------------

def two_sum(a, b):
    """Knuth's error-free transformation: a + b = s + err exactly."""
    s = a + b
    bv = s - a
    av = s - bv
    return s, (a - av) + (b - bv)


def tf_combine(s1, e1, s2, e2):
    s, err = two_sum(s1, s2)
    return s, e1 + e2 + err
