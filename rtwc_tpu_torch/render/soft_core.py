"""What the soft kernels share: render/soft_kernel.py (K1, K2, K3, the
reduction, the autograd Functions and entry points) and
render/shadow_kernel.py (K4, K5, K6, K4-stats) both import this module.

It holds the launch spec, the ctypes binding of the C entries and the
launch counter `LAUNCHES`, the argument checks, and the building blocks of
the plain versions, each in its kernel's op order: block sums, the ray
planes, the online-softmin step, the forward object sweep and the backward
sweep. Their CUDA counterparts are in csrc/soft_block.cuh and
csrc/soft_common.cuh.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import _cuda
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.broad_phase import round_up, tile_grid

(SO_R, SO_G, SO_B, SO_DEPTH, SO_NX, SO_NY, SO_NZ, SO_ALPHA, SO_M, SO_S) = range(10)
NTF = 13          # two-float partial slots: camera 0-11, loss 12
SLOT_LOSS = 12
CULL_LOG_EPS = -16.0
MAX_PLANES = 1024
MAX_THREADS = 256

LAUNCHES = {"soft_fwd": 0, "soft_bwd": 0, "soft_mse": 0, "soft_grad_reduce": 0,
            "soft_sh_fwd": 0, "soft_sh_bwd": 0, "soft_sh_mse": 0, "soft_sh_stats": 0,
            # fills of a [T NS] partial table on the card: a gradient kernel called
            # without the tables the entry-table launch zeroed (list_kernel.partial_tables)
            "partial_fill": 0}


@dataclasses.dataclass(frozen=True)
class SoftSpec:
    """What one soft launch is built for (the static arguments of JAX's
    `_build_soft_packed`). band_h renders that many image rows, starting at
    the row in cam[0, C_ROW0] (the tile sharding's band, dist/mesh.py); the
    ray generation keeps config.height, and the fused MSE is a mean over the
    band's rows."""

    config: RenderConfig
    tau: float
    bh: int = 16
    bw: int = 16
    cull: bool = True
    bwd_cull: bool = True
    band_h: int | None = None

    @property
    def rows(self) -> int:
        """Image rows of one launch: the band's, or the whole image's."""
        return self.config.height if self.band_h is None else self.band_h

    @property
    def extent(self):
        return (round_up(self.rows, self.bh), round_up(self.config.width, self.bw))

    @property
    def grid(self):
        return tile_grid(self.rows, self.config.width, self.bh, self.bw)

    @property
    def consts(self) -> O.SoftConsts:
        return O.SoftConsts.make(self.config, self.tau)


# -- ctypes binding -------------------------------------------------------------

class SoftParams(ctypes.Structure):
    """Mirror of `struct SoftParams` in csrc/soft_common.cuh."""

    _fields_ = [
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("hp", ctypes.c_int), ("wp", ctypes.c_int),
        ("bh", ctypes.c_int), ("bw", ctypes.c_int),
        ("ns", ctypes.c_int), ("np", ctypes.c_int),
        ("list_stride", ctypes.c_int), ("cull", ctypes.c_int),
        ("hardness", ctypes.c_int), ("device", ctypes.c_int),
        ("loss_h", ctypes.c_int), ("loss_w", ctypes.c_int),
        ("e1", ctypes.c_float), ("e2", ctypes.c_float),
        ("far", ctypes.c_float), ("k", ctypes.c_float), ("mp", ctypes.c_float),
        ("inv_tau", ctypes.c_float), ("bg_logit", ctypes.c_float),
        ("light", ctypes.c_float * 3), ("ldc", ctypes.c_float * 3),
        ("lsc", ctypes.c_float * 3), ("osc", ctypes.c_float * 3),
        ("dpow", ctypes.c_float), ("spow", ctypes.c_float), ("amb", ctypes.c_float),
        ("loss_scale", ctypes.c_float), ("ks", ctypes.c_float), ("sh_floor", ctypes.c_float),
    ]


class ReduceParams(ctypes.Structure):
    """Mirror of `struct ReduceParams` in csrc/soft_render.cu."""

    _fields_ = [("ns", ctypes.c_int), ("np", ctypes.c_int), ("n_entries", ctypes.c_int),
                ("n_tiles", ctypes.c_int), ("ntf", ctypes.c_int), ("device", ctypes.c_int),
                ("n_sh_entries", ctypes.c_int), ("n_wc", ctypes.c_int), ("tch", ctypes.c_int), ("n_tchunks", ctypes.c_int),
                ("n_schunks", ctypes.c_int)]


RED_CHUNK = 256        # sorted entries a first-pass sphere block sums (one a thread)
RED_TILE_CHUNKS = 256  # about this many first-pass blocks each for planes and camera
RED_WARP_CHUNKS = 2048  # at most this many warps count and scatter the sphere keys


def reduce_tile_chunk(n_tiles: int) -> int:
    """Tiles a first-pass plane or camera block of the reduction sums: a
    multiple of its 8 warps, so that about RED_TILE_CHUNKS blocks cover the
    tiles (a part of the sum order, which soft_grad_reduce_plain follows)."""
    return 8 * max(1, -(-n_tiles // (8 * RED_TILE_CHUNKS)))


def reduce_params(ns: int, npl: int, n: int, n_sh: int, n_tiles: int, ntf: int, device: int):
    """(ReduceParams, int workspace length, float workspace length) of one
    reduction over entry tables of capacities n (main) and n_sh (shadow);
    the real counts stay on the device. The C entry carves the workspaces
    as its comment says."""
    N = n + n_sh
    tch = reduce_tile_chunk(n_tiles)
    # warps of 256 keys each, RED_WARP_CHUNKS warps at most: the most any
    # real count takes (the kernels size each warp's keys from it)
    prm = ReduceParams(ns=ns, np=npl, n_entries=n, n_tiles=n_tiles, ntf=ntf, device=device,
                       n_sh_entries=n_sh, n_wc=max(1, min(RED_WARP_CHUNKS, -(-N // 256))),
                       tch=tch,
                       n_tchunks=max(1, -(-n_tiles // tch)),
                       n_schunks=max(1, -(-N // RED_CHUNK) + 2 * ns))
    n_count = -(-prm.n_wc // 8)  # blocks of 8 counting warps
    n_int = 2 * ns * n_count * 9 + 2 * ns + 2 * (2 * ns + 1) + N
    n_float = prm.n_schunks * 8 + prm.n_tchunks * (npl * P.PL_ROWS + ntf * 2)
    return prm, n_int, n_float


# C entry -> (library, number of pointer arguments)
_ENTRIES = {"rtwc_soft_fwd": ("soft_render", 6), "rtwc_soft_bwd": ("soft_render", 11),
            "rtwc_soft_mse": ("soft_render", 9), "rtwc_soft_grad_reduce": ("soft_render", 12),
            "rtwc_soft_sh_fwd": ("soft_shadow", 8), "rtwc_soft_sh_bwd": ("soft_shadow", 14),
            "rtwc_soft_sh_mse": ("soft_shadow", 14)}


def _fn(name: str):
    lib_name, argc = _ENTRIES[name]
    lib = _cuda.load(lib_name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        params = ReduceParams if name == "rtwc_soft_grad_reduce" else SoftParams
        fn.argtypes = [ctypes.c_void_p] * argc + [ctypes.POINTER(params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _params(spec: SoftSpec, sph, pl, lists) -> SoftParams:
    c = spec.consts
    Hp, Wp = spec.extent
    H, W = spec.config.height, spec.config.width
    rows = spec.rows
    return SoftParams(
        width=W, height=H, hp=Hp, wp=Wp, bh=spec.bh, bw=spec.bw,
        ns=sph.shape[1], np=pl.shape[1], list_stride=lists.shape[2], cull=0,
        hardness=c.hard, device=_device_index(sph), loss_h=rows, loss_w=W,
        e1=c.e1, e2=c.e2, far=c.far, k=c.k, mp=c.mp, inv_tau=c.inv_tau,
        bg_logit=c.bg_logit, light=(ctypes.c_float * 3)(*c.light),
        ldc=(ctypes.c_float * 3)(*c.ldc), lsc=(ctypes.c_float * 3)(*c.lsc),
        osc=(ctypes.c_float * 3)(*c.osc), dpow=c.dpow, spow=c.spow, amb=c.amb,
        loss_scale=O.f32(2.0 / (255.0 * 255.0 * 3.0 * rows * W)), ks=c.ks, sh_floor=c.sh_floor)


def _launch(name: str, key: str, tensors, prm, dev_t: torch.Tensor):
    """Launch C entry `name` on the current stream; None passes a null pointer."""
    stream = torch.cuda.current_stream(dev_t.device).cuda_stream
    rc = _fn(name)(*(None if t is None else t.data_ptr() for t in tensors), ctypes.byref(prm),
                   stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES[key] += 1


def _check(spec: SoftSpec, sph, pl, cam, lists, **extra):
    dev = sph.device
    named = dict(sph=(sph, torch.float32, 2), pl=(pl, torch.float32, 2),
                 cam=(cam, torch.float32, 2), lists=(lists, torch.int32, 3))
    named.update(extra)
    for name, (t, dtype, ndim) in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, sph on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be {dtype} with {ndim} dims, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if sph.shape[0] != P.SPH_ROWS or pl.shape[0] != P.PL_ROWS or tuple(cam.shape) != (1, P.CAM_LEN):
        raise ValueError(f"tables must be [8, NS], [12, NP], [1, 16]; got {tuple(sph.shape)}, "
                         f"{tuple(pl.shape)}, {tuple(cam.shape)}")
    Ti, Tj = spec.grid
    if tuple(lists.shape) != (Ti * Tj, 1, sph.shape[1] + 1):
        raise ValueError(f"lists must be [{Ti * Tj}, 1, {sph.shape[1] + 1}] for "
                         f"({spec.bh}, {spec.bw}) tiles, got {tuple(lists.shape)}")
    n = spec.bh * spec.bw
    if n > MAX_THREADS or n % 32:
        raise ValueError(f"tile ({spec.bh}, {spec.bw}) must hold a multiple of 32 pixels, "
                         f"at most {MAX_THREADS} (one thread each)")
    if pl.shape[1] > MAX_PLANES:
        raise ValueError(f"the kernels stage at most {MAX_PLANES} planes, got {pl.shape[1]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the soft kernels run on cuda or cpu, not {dev}")


def capacity(lists: torch.Tensor) -> int:
    """Entries a list table can hold: every tile listing every sphere
    (T NS, at least 1), the rows of the partial tables sized from it."""
    return max(1, lists.shape[0] * (lists.shape[2] - 1))


def partial_rows(lists, width: int, given, name: str, dev):
    """A gradient kernel's [T NS, width] partial table: `given` (from
    list_kernel.partial_tables, its rows below the counts zeroed by the
    entry-table launch), checked; or, when None, a zero-filled one
    (counted in LAUNCHES["partial_fill"])."""
    if given is None:
        LAUNCHES["partial_fill"] += 1
        return torch.zeros((capacity(lists), width), dtype=torch.float32, device=dev)
    if (given.device != dev or given.dtype != torch.float32 or not given.is_contiguous()
            or tuple(given.shape) != (capacity(lists), width)):
        raise ValueError(f"{name} must be a contiguous f32 [{capacity(lists)}, {width}] tensor "
                         f"on {dev}")
    return given


def _partials(spec: SoftSpec, sph, pl, lists, pvals=None):
    """The partial tables (pvals [T NS, 8], ppl [T, NP, 12], ptf [T, 13, 2]):
    pvals as `partial_rows` gives it, ppl and ptf zeroed."""
    T = spec.grid[0] * spec.grid[1]
    dev = sph.device
    return (partial_rows(lists, 8, pvals, "pvals", dev),
            torch.zeros((T, pl.shape[1], P.PL_ROWS), dtype=torch.float32, device=dev),
            torch.zeros((T, NTF, 2), dtype=torch.float32, device=dev))


def _packed(scene, camera):
    sph, pl, counts = P.pack_scene(scene)
    cam = P.with_counts(P.pack_camera(camera, scene.device), counts)
    return sph, pl, cam


def _spec(config: RenderConfig, tau, bh, bw, cull, bwd_cull, name, band_h=None) -> SoftSpec:
    tau = config.soft_tau if tau is None else tau
    if tau <= 0.0:
        raise ValueError(f"{name} needs tau > 0")
    if band_h is not None and not 0 < band_h <= config.height:
        raise ValueError(f"{name}: band_h {band_h} must lie in [1, {config.height}]")
    return SoftSpec(config=config, tau=float(tau), bh=bh, bw=bw, cull=cull, bwd_cull=bwd_cull,
                    band_h=band_h)


# -- the plain versions' building blocks ------------------------------------------

def tile_view(x: torch.Tensor, bh: int, bw: int) -> torch.Tensor:
    """[Hp, Wp] -> [T, bh*bw], each row a block's pixels in thread order
    (tid = ty * bw + tx), tiles row-major."""
    Hp, Wp = x.shape
    return x.reshape(Hp // bh, bh, Wp // bw, bw).permute(0, 2, 1, 3).reshape(-1, bh * bw)


def block_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """[T, n] -> [T]: the kernels' block sum (warp butterflies of
    __shfl_down_sync at 16, 8, 4, 2, 1, then the warps' sums in warp order)."""
    v = x.reshape(x.shape[0], -1, 32)
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    w = v[..., 0]
    s = w[:, 0]
    for i in range(1, w.shape[1]):
        s = s + w[:, i]
    return s


def block_tf_sum_plain(x: torch.Tensor):
    """[T, n] -> ([T], [T]): the two-float (hi, lo) block sum, with the
    same butterfly and warp order as block_sum_plain and every combine an
    error-free two_sum."""
    s = x.reshape(x.shape[0], -1, 32)
    e = torch.zeros_like(s)
    for off in (16, 8, 4, 2, 1):
        s, e = O.tf_combine(s[..., :off], e[..., :off], s[..., off:2 * off], e[..., off:2 * off])
    hs, he = s[..., 0], e[..., 0]
    s, e = hs[:, 0], he[:, 0]
    for i in range(1, hs.shape[1]):
        s, e = O.tf_combine(s, e, hs[:, i], he[:, i])
    return s, e


def _ray_planes(c: O.SoftConsts, cam, Hp: int, Wp: int, bh: int, bw: int):
    dev = cam.device
    rows = torch.arange(Hp, device=dev)
    cols = torch.arange(Wp, device=dev)
    rowf = (cam[0, P.C_ROW0] + (rows // bh * bh).float() + (rows % bh).float())[:, None]
    colf = ((cols // bw * bw).float() + (cols % bw).float())[None, :]
    rowf, colf = rowf.expand(Hp, Wp), colf.expand(Hp, Wp)
    cam9 = tuple(cam[0, i] for i in range(P.C_RX, P.C_FZ + 1))
    tile = (rows // bh)[:, None] * (Wp // bw) + (cols // bw)[None, :]
    return O.raygen(c, rowf, colf, cam9), tile


def _accumulate(c: O.SoftConsts, state, vals, upd):
    """One online-softmin step (pallas_soft.py:1236-1252) where `upd`."""
    m, s, acc = state
    t_eff = vals[0]
    logit = -t_eff * c.inv_tau
    m_new = torch.maximum(m, logit)
    e = torch.exp(-(logit - m).abs())
    up = logit > m
    alpha = torch.where(up, e, 1.0)
    p = torch.where(up, 1.0, e)
    s_new = s * alpha + p
    acc_new = tuple(a * alpha + p * v for a, v in zip(acc, vals[1:]))
    return (torch.where(upd, m_new, m), torch.where(upd, s_new, s),
            tuple(torch.where(upd, an, a) for an, a in zip(acc_new, acc)))


def _sphere_args(sph, k):
    return tuple(sph[row][k] for row in (P.S_CX, P.S_CY, P.S_CZ, P.S_R,
                                         P.S_COLR, P.S_COLG, P.S_COLB))


def _sphere_geo_args(sph, k):
    return tuple(sph[row][k] for row in (P.S_CX, P.S_CY, P.S_CZ, P.S_R))


def _sphere_cols(sph, k):
    return tuple(sph[row][k] for row in (P.S_COLR, P.S_COLG, P.S_COLB))


def _plane_args(pl, k: int):
    return tuple(pl[row, k] for row in range(P.P_COLB + 1))


def object_sweep(c, spec: SoftSpec, sph, pl, cam, lists, ray, tile, m_now, visit, gates=None):
    """The forward sweep of K1, K3, K4 and K6, and K4's exact re-walk
    (csrc/soft_block.cuh `forward_sweep`): the tile's sphere list, then
    every live plane. With culling, a tile takes an object when one of its
    pixels' lower bounds on the object's logit clears m_now() by
    CULL_LOG_EPS; the decisions go to gate row 0 where `gates` is given.
    Calls visit(rel [T], geo, col, col_t, sn) for every object: geo is the
    shading-free (t_eff, t_clip, nx, ny, nz, px, py, pz), col the colour
    per pixel, col_t per tile, sn the shading normal."""
    dx, dy, dz = ray[:3]
    ox, oy, oz = cam[0, 0], cam[0, 1], cam[0, 2]
    ns = sph.shape[1]
    T = lists.shape[0]
    tiles = torch.arange(T, device=cam.device)

    def taken(lb, live):
        pred = (-lb * c.inv_tau - m_now()) > CULL_LOG_EPS
        return live & tile_view(pred, spec.bh, spec.bw).any(dim=1)

    tab = lists[:, 0, :]
    cnt = tab[:, 0]
    for kk in range(int(cnt.max().item()) if T else 0):
        live = kk < cnt
        # slots past a tile's count hold anything on the card (the list kernel
        # writes the listed prefix only): gather sphere 0 there, masked by live
        kt = torch.where(live, tab[:, 1 + kk], 0).long()
        geo4 = _sphere_geo_args(sph, kt[tile])
        if spec.cull:
            lb, t2, dss = O.sphere_lb_ex(c, *geo4, dx, dy, dz, ox, oy, oz)
            rel = taken(lb, live)
            geo = O.sphere_geo_post(c, *geo4[:3], t2, dss, dx, dy, dz, ox, oy, oz)
        else:
            rel = live
            geo = O.sphere_geo(c, *geo4, dx, dy, dz, ox, oy, oz)
        if gates is not None:
            gates[tiles[live], 0, kt[live]] = rel[live].to(torch.int32)
        visit(rel, geo, _sphere_cols(sph, kt[tile]), _sphere_cols(sph, kt), geo[2:5])
    for k in range(int(cam[0, P.C_NPL].item())):
        args = _plane_args(pl, k)
        live = torch.ones(T, dtype=torch.bool, device=cam.device)
        if spec.cull:
            lb, t, denom, px, pz = O.plane_lb_ex(c, *args[:8], dx, dy, dz, ox, oy, oz)
            rel = taken(lb, live)
            geo = O.plane_geo_post(c, *args[:8], t, denom, px, pz, dx, dy, dz, ox, oy, oz)
        else:
            rel = live
            geo = O.plane_geo(c, *args[:8], dx, dy, dz, ox, oy, oz)
        if gates is not None:
            gates[:, 0, ns + k] = rel.to(torch.int32)
        visit(rel, geo, args[8:], tuple(x.expand(T) for x in args[8:]),
              O.plane_unit_n(*args[3:6]))


def _backward_sweep(c, spec: SoftSpec, sph, pl, cam, lists, offsets, gates, ray, tile,
                    m, inv_s, gv, S, vis=None, seed=None, ppl=None):
    """K2's sweep against the saved statistics (pallas_soft.py:1381-1493),
    shared by K3 and, shaded, by K5 / K6. gv: the seven output cotangent
    planes (r, g, b, depth, nx, ny, nz). Shaded (vis given): object colours
    are min(255, A + vis B), the ray cotangents start from seed = (gd, go)
    and each gated plane row adds to the shadow sweep's partial in ppl.
    Returns the partials (pvals, ppl, ptf)."""
    dx, dy, dz, vx, vy, rinv = ray
    ox, oy, oz = cam[0, 0], cam[0, 1], cam[0, 2]
    bh, bw = spec.bh, spec.bw
    dev = cam.device
    ns, npl = sph.shape[1], pl.shape[1]
    T = lists.shape[0]
    pvals = torch.zeros((capacity(lists), 8), dtype=torch.float32, device=dev)
    if ppl is None:
        ppl = torch.zeros((T, npl, P.PL_ROWS), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(m)
    gd, go = ([zero, zero, zero], [zero, zero, zero]) if seed is None else map(list, seed)

    def cotangents(vals):
        w = torch.exp(-vals[0] * c.inv_tau - m) * inv_s
        gdotv = gv[0] * vals[1]
        for i in range(1, 7):
            gdotv = gdotv + gv[i] * vals[1 + i]
        dlogit = w * (gdotv - S)
        return (-dlogit * c.inv_tau,) + tuple(w * g for g in gv)

    def tile_sums(x, upd):
        return block_sum_plain(tile_view(torch.where(upd, x, 0.0), bh, bw))

    tab = lists[:, 0, :]
    cnt = tab[:, 0]
    tiles = torch.arange(T, device=dev)
    for kk in range(int(cnt.max().item()) if T else 0):
        live = kk < cnt
        kt = torch.where(live, tab[:, 1 + kk], 0).long()  # past the count: anything
        rel = live & (gates[tiles, 0, kt] == 1) if spec.bwd_cull else live
        upd = rel[tile]
        args = _sphere_args(sph, kt[tile])
        vals = O.sphere_f(c, *args, dx, dy, dz, ox, oy, oz, vis)
        grads = O.sphere_f_vjp(c, *args, dx, dy, dz, ox, oy, oz, cotangents(vals), vis)
        rows = torch.stack([tile_sums(grads[r], upd) for r in range(7)], dim=1)   # [T, 7]
        pvals[(offsets.long() + kk)[live], :7] = rows[live]
        gd = [torch.where(upd, a + g, a) for a, g in zip(gd, grads[7:10])]
        go = [torch.where(upd, a + g, a) for a, g in zip(go, grads[10:13])]
    for k in range(int(cam[0, P.C_NPL].item())):
        rel = (gates[:, 0, ns + k] == 1) if spec.bwd_cull else torch.ones_like(cnt, dtype=torch.bool)
        upd = rel[tile]
        args = _plane_args(pl, k)
        vals = O.plane_f(c, *args, dx, dy, dz, ox, oy, oz, vis)
        grads = O.plane_f_vjp(c, *args, dx, dy, dz, ox, oy, oz, cotangents(vals), vis)
        rows = torch.stack([tile_sums(grads[r], upd) for r in range(11)], dim=1)
        ppl[:, k, :11] = rows if vis is None else torch.where(rel[:, None], ppl[:, k, :11] + rows,
                                                              ppl[:, k, :11])
        gd = [torch.where(upd, a + g, a) for a, g in zip(gd, grads[11:14])]
        go = [torch.where(upd, a + g, a) for a, g in zip(go, grads[14:17])]

    ptf = torch.zeros((T, NTF, 2), dtype=torch.float32, device=dev)
    per_pixel = list(go) + list(O.raygen_vjp(*gd, dx, dy, dz, vx, vy, rinv))
    for slot, x in enumerate(per_pixel):
        hi, lo = block_tf_sum_plain(tile_view(x, bh, bw))
        ptf[:, slot, 0], ptf[:, slot, 1] = hi, lo
    return pvals, ppl, ptf
