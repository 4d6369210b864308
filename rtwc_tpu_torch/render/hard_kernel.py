"""K7, the hard display forward render: wrapper, plain version, frame entry.

Replaces rtwc_tpu/render/pallas_kernel.py::_ray_kernel_body (the Pallas
kernel at pallas_kernel.py:290, launched by `pallas_render_packed`). The
CUDA kernel is csrc/hard_render.cu (one thread per pixel, one block per
broad-phase tile); its source note says what bounds it and what its
design does about that. In short: each ray does O(list + planes) work,
plus with shadows O(the occluders its warp's shadow cull admits + planes),
and stores 32 B, so at display sizes the frame is bound by the host loop
and the torch ops around the kernel.

- `hard_render_packed` is the counterpart of `pallas_render_packed`: it
  takes packed tables and the broad-phase lists, checks them, and on a
  CUDA tensor launches the kernel (or raises); on a CPU tensor it runs
  `hard_render_plain`. There is no fallback from the card to the plain
  version.
- `hard_render_plain` is the same algorithm in torch ops, vectorised over
  pixels, looping in Python over list slots, planes and (with shadows)
  live spheres, each masked by the kernel's per-warp shadow cull
  (`shadow_occluders`). It never builds [H, W, NS] tensors. On the card
  the kernel's planes equal it bit for bit.
- `render_frame_kernel` is the counterpart of `render_frame_pallas`.
- `LAUNCHES` counts kernel launches (never plain runs).
"""
from __future__ import annotations

import ctypes

import torch

from rtwc_tpu_torch.camera import Camera, projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import _cuda
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render.broad_phase import round_up, tile_grid
from rtwc_tpu_torch.render.list_kernel import sphere_tile_lists
from rtwc_tpu_torch.render.reference import MISS_DISTANCE, Framebuffer, _FLT_EPSILON
from rtwc_tpu_torch.render.soft_objects import rsqrt, sphere_solve

O_R, O_G, O_B, O_DEPTH, O_NX, O_NY, O_NZ, O_SHADING = range(8)
N_OUT = 8
# Largest plane table the kernel stages in shared memory.
MAX_PLANES = 1024
# The kernel's largest block (one thread a pixel, whole warps) and its
# shadow cull (csrc/hard_render.cu K7_THREADS, OCC_CAP, CULL_REL, CULL_ABS,
# SHADOW_BIAS): each warp of a tile (32 pixels in the tile's row-major
# order) keeps an occluder list of OCC_CAP spheres, and admits a sphere
# when its centre lies within r + r_box + CULL_REL * (the scene's
# distances) + CULL_ABS of the segment from the light to the centre of its
# hit points' bounding box.
MAX_THREADS = 256
OCC_CAP = 64
CULL_REL, CULL_ABS = 1e-2, 2e-3
SHADOW_BIAS = 1e-3

# Number of CUDA launches of the K7 kernel in this process.
LAUNCHES = 0


class HardParams(ctypes.Structure):
    """Mirror of `struct HardParams` in csrc/hard_render.cu."""

    _fields_ = [
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("hp", ctypes.c_int), ("wp", ctypes.c_int),
        ("bh", ctypes.c_int), ("bw", ctypes.c_int),
        ("ns", ctypes.c_int), ("np", ctypes.c_int),
        ("list_stride", ctypes.c_int), ("shadows", ctypes.c_int),
        ("hardness", ctypes.c_int), ("device", ctypes.c_int),
        ("e1", ctypes.c_float), ("e2", ctypes.c_float),
        ("light", ctypes.c_float * 3),
        ("light_diffuse", ctypes.c_float * 3),
        ("light_specular", ctypes.c_float * 3),
        ("object_specular", ctypes.c_float * 3),
        ("diffuse_power", ctypes.c_float), ("specular_power", ctypes.c_float),
        ("ambient", ctypes.c_float),
    ]


def _kernel_fn():
    lib = _cuda.load("hard_render")
    fn = lib.rtwc_hard_render
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(HardParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _out_extent(config: RenderConfig, bh: int, bw: int, band_h: int | None):
    return (round_up(band_h if band_h is not None else config.height, bh),
            round_up(config.width, bw))


def _check_inputs(sph, pl, counts, cam, lists, config, bh, bw, band_h):
    dev = sph.device
    for name, t, dtype, ndim in (("sph", sph, torch.float32, 2), ("pl", pl, torch.float32, 2),
                                 ("counts", counts, torch.int32, 2),
                                 ("cam", cam, torch.float32, 2),
                                 ("lists", lists, torch.int32, 3)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, sph on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be {dtype} with {ndim} dims, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ns, npl = sph.shape[1], pl.shape[1]
    Hp, Wp = _out_extent(config, bh, bw, band_h)
    n_tiles = (Hp // bh) * (Wp // bw)
    if sph.shape[0] != P.SPH_ROWS or pl.shape[0] != P.PL_ROWS:
        raise ValueError(f"tables must be [8, NS] and [12, NP], got "
                         f"{tuple(sph.shape)} and {tuple(pl.shape)}")
    if tuple(counts.shape) != (1, 2) or tuple(cam.shape) != (1, P.CAM_LEN):
        raise ValueError(f"counts must be [1, 2] and cam [1, 16], got "
                         f"{tuple(counts.shape)} and {tuple(cam.shape)}")
    if tuple(lists.shape) != (n_tiles, 1, ns + 1):
        raise ValueError(f"lists must be [{n_tiles}, 1, {ns + 1}] for ({bh}, {bw}) "
                         f"tiles, got {tuple(lists.shape)}")
    if bh < 1 or bw < 1 or bh * bw > MAX_THREADS or (bh * bw) % 32:
        raise ValueError(f"tile ({bh}, {bw}) must hold a multiple of 32 pixels, at most "
                         f"{MAX_THREADS} (one thread each)")
    if npl > MAX_PLANES:
        raise ValueError(f"the kernel stages at most {MAX_PLANES} planes, got {npl}")
    return Hp, Wp


def hard_render_packed(sph, pl, counts, cam, lists, *, config: RenderConfig,
                       bh: int, bw: int, band_h: int | None = None) -> torch.Tensor:
    """Render from packed tables: sph [8, NS] f32, pl [12, NP] f32,
    counts [1, 2] i32, cam [1, 16] f32 (row cam[0, 14] starts the band),
    lists [T, 1, NS+1] i32 built for the same (bh, bw) tiles. Returns the
    [8, Hp, Wp] f32 plane stack (O_* order). band_h renders that many rows
    (default: the whole image height)."""
    global LAUNCHES
    Hp, Wp = _check_inputs(sph, pl, counts, cam, lists, config, bh, bw, band_h)
    if sph.device.type == "cpu":
        return hard_render_plain(sph, pl, counts, cam, lists, config=config,
                                 bh=bh, bw=bw, band_h=band_h)
    if sph.device.type != "cuda":
        raise ValueError(f"hard_render_packed runs on cuda or cpu, not {sph.device}")
    fn = _kernel_fn()
    out = torch.empty((N_OUT, Hp, Wp), dtype=torch.float32, device=sph.device)
    e1, e2 = projection_elements(config)
    prm = HardParams(
        width=config.width, height=config.height, hp=Hp, wp=Wp, bh=bh, bw=bw,
        ns=sph.shape[1], np=pl.shape[1], list_stride=lists.shape[2],
        shadows=int(bool(config.shadows)), hardness=int(config.specular_hardness),
        device=sph.device.index if sph.device.index is not None else torch.cuda.current_device(),
        e1=e1, e2=e2,
        light=(ctypes.c_float * 3)(*config.light_pos),
        light_diffuse=(ctypes.c_float * 3)(*config.light_diffuse_color),
        light_specular=(ctypes.c_float * 3)(*config.light_specular_color),
        object_specular=(ctypes.c_float * 3)(*config.object_specular_color),
        diffuse_power=config.light_diffuse_power,
        specular_power=config.light_specular_power, ambient=config.ambient,
    )
    stream = torch.cuda.current_stream(sph.device).cuda_stream
    rc = fn(cam.data_ptr(), sph.data_ptr(), pl.data_ptr(), counts.data_ptr(),
            lists.data_ptr(), out.data_ptr(), ctypes.byref(prm), stream)
    if rc != 0:
        raise RuntimeError(f"hard_render kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def _pow_int(x: torch.Tensor, n: int) -> torch.Tensor:
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


def _sphere_t(scx, scy, scz, r, o, d):
    """(t, valid) of the shadow ray o + t d against a sphere (hard_render.cu
    sphere_t): b^2 - 4c, as JAX's kernel; only the hit / miss decision is
    used."""
    ocx, ocy, ocz = o[0] - scx, o[1] - scy, o[2] - scz
    b = 2.0 * (d[0] * ocx + d[1] * ocy + d[2] * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - 4.0 * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    valid = (disc >= 0.0) & (t1 >= 0.0) & (t2 >= 0.0)
    return torch.minimum(t1, t2), valid


def _camera_sphere_t(scx, scy, scz, r, o, d):
    """(t, valid) of the camera ray o + t d against a sphere
    (hard_render.cu camera_sphere_t): the discriminant as 4 (r^2 - q . q),
    q = oc - (d . oc) d (soft_objects.sphere_solve). JAX's b^2 - 4c cancels
    at t ~ 90, putting t off by up to 6e-6 relative, and the normal, p - c,
    by that over r: up to 7e-4, which Blinn-Phong turns into 1e-2 of rgb
    (ROADMAP queue 3, K7 away from the default light)."""
    h, _, _, _, disc = sphere_solve(d[0], d[1], d[2], o[0] - scx, o[1] - scy, o[2] - scz, r)
    b = 2.0 * h
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = 0.5 * (-b + sq)
    t2 = 0.5 * (-b - sq)
    valid = (disc >= 0.0) & (t1 >= 0.0) & (t2 >= 0.0)
    return torch.minimum(t1, t2), valid


def _plane_t(pl, k, o, d):
    """(t, valid) of the ray o + t d against live plane k (hard_render.cu plane_t)."""
    pcx, pcy, pcz, pnx, pny, pnz, hw, hh = (pl[row, k] for row in range(8))
    denom = d[0] * pnx + d[1] * pny + d[2] * pnz
    num = (pcx - o[0]) * pnx + (pcy - o[1]) * pny + (pcz - o[2]) * pnz
    safe = torch.where(denom.abs() < _FLT_EPSILON, -1.0, denom)
    t = num / safe
    hx = o[0] + d[0] * t
    hz = o[2] + d[2] * t
    valid = ((denom < -_FLT_EPSILON) & (t > 0.0) & ((hx - pcx).abs() < hw)
             & ((hz - pcz).abs() < hh))
    return t, valid


def _trace(sph, pl, counts, cam, lists, config, bh, bw, band_h):
    """The kernel's ray generation and closest hit, vectorised over the
    [Hp, Wp] pixels: a Python loop over list slots k < max(count) gathers
    lists[tile(pixel), 1 + k] and masks k < count, then all live planes.
    Returns (o, d, t_best, (snx, sny, snz), (cr, cg, cb))."""
    dev = sph.device
    Hp, Wp = _out_extent(config, bh, bw, band_h)
    W, H = config.width, config.height
    e1, e2 = projection_elements(config)
    c = [float(v) for v in cam[0].tolist()]
    n_pl = int(counts.reshape(-1)[1])

    rows = torch.arange(Hp, device=dev)
    cols = torch.arange(Wp, device=dev)
    rowf = (cam[0, P.C_ROW0] + (rows // bh * bh).float() + (rows % bh).float())[:, None]
    colf = ((cols // bw * bw).float() + (cols % bw).float())[None, :]
    # Divide by a tensor: torch turns `x / python_scalar` into a multiply by
    # the reciprocal on CUDA, which is not the kernel's (IEEE) division.
    w_t = torch.tensor(float(W), dtype=torch.float32, device=dev)
    h_t = torch.tensor(float(H), dtype=torch.float32, device=dev)
    cx = (2.0 * colf - W) / w_t
    cy = (H - 2.0 * rowf) / h_t
    vx = (cx * e1).expand(Hp, Wp)
    vy = (cy * e2).expand(Hp, Wp)
    ox, oy, oz = c[P.C_POSX], c[P.C_POSY], c[P.C_POSZ]
    dx = c[P.C_RX] * vx + c[P.C_RY] * vy + c[P.C_RZ]
    dy = c[P.C_UX] * vx + c[P.C_UY] * vy + c[P.C_UZ]
    dz = c[P.C_FX] * vx + c[P.C_FY] * vy + c[P.C_FZ]
    inv_len = rsqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len

    o3, d3 = (ox, oy, oz), (dx, dy, dz)
    zeros = torch.zeros((Hp, Wp), dtype=torch.float32, device=dev)
    t_best = torch.full((Hp, Wp), MISS_DISTANCE, dtype=torch.float32, device=dev)
    snx, sny, snz, cr, cg, cb = (zeros.clone() for _ in range(6))

    tile = (rows // bh)[:, None] * (Wp // bw) + (cols // bw)[None, :]
    tab = lists[:, 0, :]
    cnt = tab[:, 0][tile]
    for kk in range(int(tab[:, 0].max().item()) if tab.shape[0] else 0):
        # slots past a tile's count hold anything on the card (the list kernel
        # writes the listed prefix only): gather sphere 0 there, masked below
        k = torch.where(kk < tab[:, 0], tab[:, 1 + kk], 0).long()[tile]
        scx, scy, scz, r = (sph[row][k] for row in (P.S_CX, P.S_CY, P.S_CZ, P.S_R))
        t, valid = _camera_sphere_t(scx, scy, scz, r, o3, d3)
        win = valid & (t < t_best) & (kk < cnt)
        t_best = torch.where(win, t, t_best)
        px = ox + dx * t - scx
        py = oy + dy * t - scy
        pz = oz + dz * t - scz
        n_inv = rsqrt(px * px + py * py + pz * pz)
        snx = torch.where(win, px * n_inv, snx)
        sny = torch.where(win, py * n_inv, sny)
        snz = torch.where(win, pz * n_inv, snz)
        cr = torch.where(win, sph[P.S_COLR][k], cr)
        cg = torch.where(win, sph[P.S_COLG][k], cg)
        cb = torch.where(win, sph[P.S_COLB][k], cb)
    for k in range(n_pl):
        t, valid = _plane_t(pl, k, o3, d3)
        win = valid & (t < t_best)
        t_best = torch.where(win, t, t_best)
        snx = torch.where(win, pl[P.P_NX, k], snx)
        sny = torch.where(win, pl[P.P_NY, k], sny)
        snz = torch.where(win, pl[P.P_NZ, k], snz)
        cr = torch.where(win, pl[P.P_COLR, k], cr)
        cg = torch.where(win, pl[P.P_COLG, k], cg)
        cb = torch.where(win, pl[P.P_COLB, k], cb)
    return o3, d3, t_best, (snx, sny, snz), (cr, cg, cb)


def _by_warp(x: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """[Hp, Wp] -> [G, 32], the kernel's warps: tile t = (row // bh) *
    (Wp // bw) + col // bw, its pixels in row-major order, 32 a warp; warp
    w of tile t is group t * (bh * bw // 32) + w."""
    Hp, Wp = x.shape
    return x.reshape(Hp // bh, bh, Wp // bw, bw).transpose(1, 2).reshape(-1, 32)


def _warp_of_pixel(Hp: int, Wp: int, bh: int, bw: int, device) -> torch.Tensor:
    """[Hp, Wp] int64: the `_by_warp` group of each pixel."""
    idx = torch.arange(Hp * Wp, device=device).reshape(Hp, Wp)
    group = torch.empty(Hp * Wp, dtype=torch.int64, device=device)
    group[_by_warp(idx, bh, bw).reshape(-1)] = torch.arange(
        Hp * Wp // 32, device=device).repeat_interleave(32)
    return group.reshape(Hp, Wp)


def shadow_occluders(p3, hit, sph, n_sph: int, light, bh: int, bw: int):
    """The kernel's shadow cull, warp by warp (`_by_warp`), in its
    operations: the bounding box of the warp's hit points p3 (where
    `hit`), then each live sphere's centre against the segment from the
    light to the box's centre (hard_render.cu). Returns (admit [G, n_sph]
    bool: the spheres the warp's shadow rays test, every live sphere for a
    warp that admits more than OCC_CAP; count [G]: the spheres admitted;
    any_hit [G]). A warp without a hit admits nothing."""
    dev = sph.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    mn = [_by_warp(torch.where(hit, v, inf), bh, bw).amin(1) for v in p3]
    mx = [_by_warp(torch.where(hit, v, -inf), bh, bw).amax(1) for v in p3]
    any_hit = _by_warp(hit, bh, bw).any(1)
    lx, ly, lz = (float(v) for v in light)
    bcx, bcy, bcz = (0.5 * (a + b) for a, b in zip(mn, mx))
    ex, ey, ez = (b - a for a, b in zip(mn, mx))
    r_box = (0.5 * torch.sqrt(ex * ex + ey * ey + ez * ez))[:, None]
    ux, uy, uz = ((bcx - lx)[:, None], (bcy - ly)[:, None], (bcz - lz)[:, None])
    uu = ux * ux + uy * uy + uz * uz
    u_len = torch.sqrt(uu)
    lt = torch.tensor([lx, ly, lz], dtype=torch.float32, device=dev)
    l_len = torch.sqrt(lt[0] * lt[0] + lt[1] * lt[1] + lt[2] * lt[2])
    scx, scy, scz, r = (sph[row, :n_sph][None, :] for row in (P.S_CX, P.S_CY, P.S_CZ, P.S_R))
    wx, wy, wz = scx - lx, scy - ly, scz - lz
    wu = wx * ux + wy * uy + wz * uz
    s = torch.clamp(torch.where(uu > 0.0, wu / uu, 0.0), 0.0, 1.0)
    qx, qy, qz = wx - s * ux, wy - s * uy, wz - s * uz
    q2 = qx * qx + qy * qy + qz * qz
    w_len = torch.sqrt(wx * wx + wy * wy + wz * wz)
    reach = r + r_box + (CULL_REL * (w_len + u_len + r_box + l_len) + CULL_ABS)
    admit = (q2 <= reach * reach) & any_hit[:, None]
    count = admit.sum(1)
    return admit | (count > OCC_CAP)[:, None], count, any_hit


def _light(config, o3, d3, t_best):
    """The hit points, the unit light directions and |light - p|^2."""
    lx, ly, lz = config.light_pos
    px = o3[0] + d3[0] * t_best
    py = o3[1] + d3[1] * t_best
    pz = o3[2] + d3[2] * t_best
    ldx, ldy, ldz = lx - px, ly - py, lz - pz
    d2 = ldx * ldx + ldy * ldy + ldz * ldz
    l_inv = rsqrt(torch.clamp(d2, min=1e-20))
    return (px, py, pz), (ldx * l_inv, ldy * l_inv, ldz * l_inv), d2


def hard_render_plain(sph, pl, counts, cam, lists, *, config: RenderConfig,
                      bh: int, bw: int, band_h: int | None = None) -> torch.Tensor:
    """The kernel's algorithm in torch ops on any device, same op order:
    `_trace`'s closest hit, then Blinn-Phong and, with shadows, each
    pixel's shadow ray against the spheres its warp's cull admits
    (`shadow_occluders`) and every live plane."""
    n_sph, n_pl = (int(v) for v in counts.reshape(-1).tolist())
    o3, d3, t_best, (snx, sny, snz), (cr, cg, cb) = _trace(
        sph, pl, counts, cam, lists, config, bh, bw, band_h)
    dx, dy, dz = d3
    hit = t_best < MISS_DISTANCE
    p3, (ldx, ldy, ldz), d2 = _light(config, o3, d3, t_best)
    inv_d2 = 1.0 / d2
    ndotl = torch.clamp(snx * ldx + sny * ldy + snz * ldz, 0.0, 1.0)

    light_vis = torch.ones_like(t_best)
    if config.shadows:
        admit = shadow_occluders(p3, hit, sph, n_sph, config.light_pos, bh, bw)[0]
        warp = _warp_of_pixel(*t_best.shape, bh, bw, t_best.device)
        so3 = tuple(p + ld * SHADOW_BIAS for p, ld in zip(p3, (ldx, ldy, ldz)))
        sd3 = (ldx, ldy, ldz)
        sh_t = torch.full_like(t_best, MISS_DISTANCE)
        for k in range(n_sph):
            t, valid = _sphere_t(sph[P.S_CX, k], sph[P.S_CY, k], sph[P.S_CZ, k],
                                 sph[P.S_R, k], so3, sd3)
            sh_t = torch.where(valid & admit[:, k][warp] & (t < sh_t), t, sh_t)
        for k in range(n_pl):
            t, valid = _plane_t(pl, k, so3, sd3)
            sh_t = torch.where(valid & (t < sh_t), t, sh_t)
        light_vis = torch.where(sh_t < torch.sqrt(d2), 0.0, 1.0)

    hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
    h_inv = rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-20))
    ndoth = torch.clamp(snx * hx * h_inv + sny * hy * h_inv + snz * hz * h_inv, 0.0, 1.0)
    spec_i = _pow_int(ndoth, int(config.specular_hardness))
    diff_term = config.light_diffuse_power * inv_d2 * ndotl * light_vis
    spec_term = config.light_specular_power * inv_d2 * spec_i * light_vis
    amb = config.ambient

    def shade_channel(col, ldc, lsc, osc):
        cd = col * (1.0 / 255.0)
        s = amb * cd + diff_term * ldc * cd + spec_term * lsc * osc
        return torch.where(hit, torch.clamp(s * 255.0, max=255.0), 0.0)

    ldcol, lscol, oscol = (config.light_diffuse_color, config.light_specular_color,
                           config.object_specular_color)
    return torch.stack([
        shade_channel(cr, ldcol[0], lscol[0], oscol[0]),
        shade_channel(cg, ldcol[1], lscol[1], oscol[1]),
        shade_channel(cb, ldcol[2], lscol[2], oscol[2]),
        t_best,
        torch.where(hit, snx, 0.0),
        torch.where(hit, sny, 0.0),
        torch.where(hit, snz, 0.0),
        torch.where(hit, snx, 0.0),
    ])


def planes_to_framebuffer(out: torch.Tensor, config: RenderConfig, height: int) -> Framebuffer:
    """Slice the padded [8, Hp, Wp] stack to (height, width) and build the
    Framebuffer (pallas_kernel.py:309-325). Keeps both hit tests: the
    kernel's `t < MISS` gates rgb / normals, `hit` here is depth <= far."""
    out = out[:, :height, :config.width]
    rgb = out[O_R:O_B + 1].permute(1, 2, 0)
    normal = out[O_NX:O_NZ + 1].permute(1, 2, 0)
    depth = out[O_DEPTH]
    hit = depth <= config.far
    return Framebuffer(rgb=rgb, normal=normal, depth=depth, shading=out[O_SHADING],
                       hit=hit, coverage=hit.float(), alpha=hit.float())


def tile_lists(sph, cam, config: RenderConfig, bh: int, bw: int, rows: int | None = None):
    """The hard broad-phase lists for (bh, bw) tiles over `rows` image rows
    (default: the whole height) starting at cam[0, C_ROW0]: the list kernel
    on the card (render/list_kernel.py), broad_phase.py on the CPU."""
    grid = tile_grid(rows if rows is not None else config.height, config.width, bh, bw)
    lists, _ = sphere_tile_lists(sph, cam, config, 0.0, bh, bw, grid, hard=True)
    return lists


def hard_band_packed(sph, pl, counts, cam, row0: int, *, config: RenderConfig,
                     band_h: int, bh: int = 16, bw: int = 16) -> torch.Tensor:
    """Render `band_h` rows starting at image row `row0` from packed tables
    (pallas_kernel.py:328-344); returns the [8, Hp, Wp] stack of the band."""
    cam = cam.clone()
    cam[:, P.C_ROW0].fill_(float(row0))  # a fill kernel: no copy from the host
    lists = tile_lists(sph, cam, config, bh, bw, rows=band_h)
    return hard_render_packed(sph, pl, counts.reshape(1, 2), cam, lists,
                              config=config, bh=bh, bw=bw, band_h=band_h)


def render_frame_kernel(scene, camera: Camera, config: RenderConfig,
                        bh: int = 16, bw: int = 16) -> Framebuffer:
    """Pack, broad phase, K7, framebuffer, on the scene's device
    (pallas_kernel.py:361-380). The same (bh, bw) feeds the broad phase and
    the launch, so the lists describe exactly the block's pixels."""
    return render_frame_packed(scene, P.pack_camera(camera, scene.device), config, bh, bw)


def render_planes_packed(scene, cam: torch.Tensor, config: RenderConfig,
                         bh: int = 16, bw: int = 16) -> torch.Tensor:
    """Pack, broad phase and K7 from the packed camera cam [1, 16] on the
    scene's device: the padded [8, Hp, Wp] plane stack. No host value is
    read, so the display step can be replayed as a CUDA graph
    (engine/engine.py)."""
    sph, pl, counts = P.pack_scene(scene)
    lists = tile_lists(sph, cam, config, bh, bw)
    return hard_render_packed(sph, pl, counts.reshape(1, 2), cam, lists,
                              config=config, bh=bh, bw=bw)


def render_frame_packed(scene, cam: torch.Tensor, config: RenderConfig,
                        bh: int = 16, bw: int = 16) -> Framebuffer:
    """render_frame_kernel from the packed camera cam [1, 16]:
    `render_planes_packed` and the framebuffer."""
    return planes_to_framebuffer(render_planes_packed(scene, cam, config, bh, bw),
                                 config, config.height)
