"""K1, K2, K3 and the cross-block gradient reduction: wrappers, plain
versions, autograd Functions and the soft train-path entry points.

Replaces the unshadowed custom-VJP kernels of
rtwc_tpu/render/pallas_soft.py: K1 `_soft_fwd_body` (pl.pallas_call at
:2434), K2 `_soft_bwd_body` (:2476), K3 the unshadowed branch of
`_soft_mse_fused_body` (:2526), and, as the reduction of the partials that
K2 and K3 leave, D3 `_twofloat_plane_sum` (tests/test_pallas_soft.py:283).
The CUDA kernels are csrc/soft_render.cu; their source note says what
bounds them. One thread traces one pixel, one block covers one
broad-phase tile of (bh, bw) pixels, 16x16 by default: the TPU's
(8, 128)-multiple tiles (`_pick_tiles`, :2630) are its vreg shape, while a
16x16 block is 256 threads (8 warps, enough blocks at 1080p to fill 132
SMs) and a near-square patch, which keeps the tile's ray cone and so its
broad-phase list small.

The TPU grid runs tiles one after another and adds every tile's gradients
into shared tables (pallas_soft.py:34-38). GPU blocks run at once, so K2
and K3 never add into a global table. Each block writes partials:
  - spheres: one [8] row per entry of its list (keyed by list slot, at
    offsets[tile] + slot in a compact [E, 8] table, E = the total list
    length), with `pidx` naming each entry's sphere; a dense [T, 8, NS]
    layout would be 265 MB at 3840x2160 with 256 spheres;
  - planes: [T, NP, 12];
  - two-float (hi, lo) pairs [T, 13, 2]: the camera position (0-2) and
    basis (3-11) cotangents, and the MSE loss (12). The basis sums cancel
    badly, so they stay two-float all the way (pallas_soft.py:573-577).
`soft_grad_reduce` then sums them in a fixed order (each of 256 threads
walks a fixed chunk in tile order, then a fixed tree), with no atomics:
two launches on the same inputs give bit-equal tables. Inside a block the
per-object sums are warp butterflies, then the warps' sums in warp order;
the plain versions below reproduce both orders.

Wrappers (`soft_fwd`, `soft_bwd`, `soft_mse`, `soft_grad_reduce`) run the
plain version for CPU tensors only; for CUDA tensors they launch the kernel
or raise. `LAUNCHES` counts kernel launches by name, never plain runs.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import _cuda
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.broad_phase import round_up, sphere_tile_lists, tile_grid
from rtwc_tpu_torch.render.reference import Framebuffer

(SO_R, SO_G, SO_B, SO_DEPTH, SO_NX, SO_NY, SO_NZ, SO_ALPHA, SO_M, SO_S) = range(10)
N_PLANES = 10
NTF = 13          # two-float partial slots: camera 0-11, loss 12
SLOT_LOSS = 12
RED_THREADS = 256  # threads of one soft_grad_reduce block
CULL_LOG_EPS = -16.0
MAX_PLANES = 1024
MAX_THREADS = 256

LAUNCHES = {"soft_fwd": 0, "soft_bwd": 0, "soft_mse": 0, "soft_grad_reduce": 0}


@dataclasses.dataclass(frozen=True)
class SoftSpec:
    """What one soft launch is built for (the static arguments of JAX's
    `_build_soft_packed`)."""

    config: RenderConfig
    tau: float
    bh: int = 16
    bw: int = 16
    cull: bool = True
    bwd_cull: bool = True

    @property
    def extent(self):
        return (round_up(self.config.height, self.bh), round_up(self.config.width, self.bw))

    @property
    def grid(self):
        return tile_grid(self.config.height, self.config.width, self.bh, self.bw)

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
        ("loss_scale", ctypes.c_float),
    ]


class ReduceParams(ctypes.Structure):
    """Mirror of `struct ReduceParams` in csrc/soft_render.cu."""

    _fields_ = [("ns", ctypes.c_int), ("np", ctypes.c_int), ("n_entries", ctypes.c_int),
                ("n_tiles", ctypes.c_int), ("ntf", ctypes.c_int), ("device", ctypes.c_int)]


_ARGC = {"rtwc_soft_fwd": 6, "rtwc_soft_bwd": 11, "rtwc_soft_mse": 9,
         "rtwc_soft_grad_reduce": 7}


def _fn(name: str):
    lib = _cuda.load("soft_render")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        params = ReduceParams if name == "rtwc_soft_grad_reduce" else SoftParams
        fn.argtypes = [ctypes.c_void_p] * _ARGC[name] + [ctypes.POINTER(params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _params(spec: SoftSpec, sph, pl, lists) -> SoftParams:
    c = spec.consts
    Hp, Wp = spec.extent
    H, W = spec.config.height, spec.config.width
    return SoftParams(
        width=W, height=H, hp=Hp, wp=Wp, bh=spec.bh, bw=spec.bw,
        ns=sph.shape[1], np=pl.shape[1], list_stride=lists.shape[2], cull=0,
        hardness=c.hard, device=_device_index(sph), loss_h=H, loss_w=W,
        e1=c.e1, e2=c.e2, far=c.far, k=c.k, mp=c.mp, inv_tau=c.inv_tau,
        bg_logit=c.bg_logit, light=(ctypes.c_float * 3)(*c.light),
        ldc=(ctypes.c_float * 3)(*c.ldc), lsc=(ctypes.c_float * 3)(*c.lsc),
        osc=(ctypes.c_float * 3)(*c.osc), dpow=c.dpow, spow=c.spow, amb=c.amb,
        loss_scale=O.f32(2.0 / (255.0 * 255.0 * 3.0 * H * W)))


def _launch(name: str, key: str, tensors, prm, dev_t: torch.Tensor):
    stream = torch.cuda.current_stream(dev_t.device).cuda_stream
    rc = _fn(name)(*(t.data_ptr() for t in tensors), ctypes.byref(prm), stream)
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


def _chunked(x: torch.Tensor, fill):
    """[n, ...] -> [RED_THREADS, chunk, ...]: thread j takes items
    j*chunk .. (j+1)*chunk - 1 (padding with `fill`)."""
    n = x.shape[0]
    chunk = max(1, -(-n // RED_THREADS))
    pad = RED_THREADS * chunk - n
    if pad:
        x = torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                     device=x.device)])
    return x.reshape(RED_THREADS, chunk, *x.shape[1:])


def _tree(acc: torch.Tensor, combine=None, err=None):
    """Fixed tree over dim 0 (RED_THREADS): s[i] += s[i + stride]."""
    stride = RED_THREADS // 2
    while stride:
        if combine is None:
            acc = acc[:stride] + acc[stride:2 * stride]
        else:
            acc, err = combine(acc[:stride], err[:stride], acc[stride:2 * stride],
                               err[stride:2 * stride])
        stride //= 2
    return acc[0] if combine is None else (acc[0], err[0])


def soft_grad_reduce_plain(pvals, pidx, ppl, ptf, ns: int):
    """The reduction kernel's sums in its order: returns dsph [8, NS],
    dpl [12, NP] and the two-float pairs [NTF, 2]."""
    dev = pvals.device
    vals = _chunked(pvals, 0.0)                                  # [R, C, 8]
    idx = _chunked(pidx, -1)                                     # [R, C]
    objs = torch.arange(ns, device=dev)
    acc = torch.zeros((RED_THREADS, ns, 8), dtype=torch.float32, device=dev)
    for j in range(vals.shape[1]):
        hit = (idx[:, j, None] == objs[None, :])[..., None]     # [R, NS, 1]
        acc = acc + torch.where(hit, vals[:, j, None, :], 0.0)
    dsph = _tree(acc).T.contiguous()                             # [8, NS]
    dsph[P.S_ACTIVE] = 0.0                                       # takes no gradient

    pv = _chunked(ppl, 0.0)                                      # [R, C, NP, 12]
    acc = torch.zeros((RED_THREADS,) + tuple(ppl.shape[1:]), dtype=torch.float32, device=dev)
    for j in range(pv.shape[1]):
        acc = acc + pv[:, j]
    dpl = _tree(acc).T.contiguous()                              # [12, NP]
    dpl[P.P_ACTIVE] = 0.0

    tv = _chunked(ptf, 0.0)                                      # [R, C, NTF, 2]
    s = torch.zeros((RED_THREADS, ptf.shape[1]), dtype=torch.float32, device=dev)
    e = torch.zeros_like(s)
    for j in range(tv.shape[1]):
        s, e = O.tf_combine(s, e, tv[:, j, :, 0], tv[:, j, :, 1])
    hi, lo = _tree(s, O.tf_combine, e)
    return dsph, dpl, torch.stack([hi, lo], dim=-1)


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


def _plane_args(pl, k: int):
    return tuple(pl[row, k] for row in range(P.P_COLB + 1))


def _forward_sweep(c, spec: SoftSpec, sph, pl, cam, lists, ray, tile, acc0, gates):
    """K1's sweep: the list's spheres, then every live plane. Fills
    `gates` and returns (m, s, acc)."""
    dx, dy, dz = ray[:3]
    ox, oy, oz = cam[0, 0], cam[0, 1], cam[0, 2]
    bh, bw = spec.bh, spec.bw
    ns = sph.shape[1]
    Hp, Wp = tile.shape
    m = torch.full((Hp, Wp), c.bg_logit, dtype=torch.float32, device=cam.device)
    state = (m, torch.ones_like(m), acc0)
    tab = lists[:, 0, :]
    cnt = tab[:, 0]
    tiles = torch.arange(tab.shape[0], device=cam.device)
    n_acc = len(acc0)

    def gate(pred, live):
        if not spec.cull:
            return live
        return live & tile_view(pred, bh, bw).any(dim=1)

    for kk in range(int(cnt.max().item()) if tab.shape[0] else 0):
        kt = tab[:, 1 + kk].long()
        live = kk < cnt
        args = _sphere_args(sph, kt[tile])
        if spec.cull:
            lb, t2, dss = O.sphere_lb_ex(c, *args[:4], dx, dy, dz, ox, oy, oz)
            rel = gate((-lb * c.inv_tau - state[0]) > CULL_LOG_EPS, live)
            vals = O.sphere_f_post(c, *args[:3], t2, dss, *args[4:], dx, dy, dz, ox, oy, oz)
        else:
            rel = live
            vals = O.sphere_f(c, *args, dx, dy, dz, ox, oy, oz)
        gates[tiles[live], 0, kt[live]] = rel[live].to(torch.int32)
        state = _accumulate(c, state, vals[:1 + n_acc], rel[tile])
    for k in range(int(cam[0, P.C_NPL].item())):
        args = _plane_args(pl, k)
        live = torch.ones_like(cnt, dtype=torch.bool)
        if spec.cull:
            lb, t, denom, px, pz = O.plane_lb_ex(c, *args[:8], dx, dy, dz, ox, oy, oz)
            rel = gate((-lb * c.inv_tau - state[0]) > CULL_LOG_EPS, live)
            vals = O.plane_f_post(c, *args[:8], t, denom, px, pz, *args[8:],
                                  dx, dy, dz, ox, oy, oz)
        else:
            rel = live
            vals = O.plane_f(c, *args, dx, dy, dz, ox, oy, oz)
        gates[:, 0, ns + k] = rel.to(torch.int32)
        state = _accumulate(c, state, vals[:1 + n_acc], rel[tile])
    return state


def _backward_sweep(c, spec: SoftSpec, sph, pl, cam, lists, offsets, gates, ray, tile,
                    m, inv_s, gv, S, n_entries: int):
    """K2's sweep against the saved statistics (pallas_soft.py:1381-1493),
    shared by K3. gv: the seven output cotangent planes (r, g, b, depth,
    nx, ny, nz). Returns the partials (pvals, ppl, ptf)."""
    dx, dy, dz, vx, vy, rinv = ray
    ox, oy, oz = cam[0, 0], cam[0, 1], cam[0, 2]
    bh, bw = spec.bh, spec.bw
    dev = cam.device
    ns, npl = sph.shape[1], pl.shape[1]
    T = lists.shape[0]
    pvals = torch.zeros((max(n_entries, 1), 8), dtype=torch.float32, device=dev)
    ppl = torch.zeros((T, npl, P.PL_ROWS), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(m)
    gd = [zero, zero, zero]
    go = [zero, zero, zero]

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
        kt = tab[:, 1 + kk].long()
        live = kk < cnt
        rel = live & (gates[tiles, 0, kt] == 1) if spec.bwd_cull else live
        upd = rel[tile]
        args = _sphere_args(sph, kt[tile])
        vals = O.sphere_f(c, *args, dx, dy, dz, ox, oy, oz)
        grads = O.sphere_f_vjp(c, *args, dx, dy, dz, ox, oy, oz, cotangents(vals))
        rows = torch.stack([tile_sums(grads[r], upd) for r in range(7)], dim=1)   # [T, 7]
        pvals[(offsets.long() + kk)[live], :7] = rows[live]
        gd = [torch.where(upd, a + g, a) for a, g in zip(gd, grads[7:10])]
        go = [torch.where(upd, a + g, a) for a, g in zip(go, grads[10:13])]
    for k in range(int(cam[0, P.C_NPL].item())):
        rel = (gates[:, 0, ns + k] == 1) if spec.bwd_cull else torch.ones_like(cnt, dtype=torch.bool)
        upd = rel[tile]
        args = _plane_args(pl, k)
        vals = O.plane_f(c, *args, dx, dy, dz, ox, oy, oz)
        grads = O.plane_f_vjp(c, *args, dx, dy, dz, ox, oy, oz, cotangents(vals))
        ppl[:, k, :11] = torch.stack([tile_sums(grads[r], upd) for r in range(11)], dim=1)
        gd = [torch.where(upd, a + g, a) for a, g in zip(gd, grads[11:14])]
        go = [torch.where(upd, a + g, a) for a, g in zip(go, grads[14:17])]

    ptf = torch.zeros((T, NTF, 2), dtype=torch.float32, device=dev)
    per_pixel = list(go) + list(O.raygen_vjp(*gd, dx, dy, dz, vx, vy, rinv))
    for slot, x in enumerate(per_pixel):
        hi, lo = block_tf_sum_plain(tile_view(x, bh, bw))
        ptf[:, slot, 0], ptf[:, slot, 1] = hi, lo
    return pvals, ppl, ptf


def soft_fwd_plain(sph, pl, cam, lists, *, spec: SoftSpec):
    """K1 in torch ops: returns (planes [10, Hp, Wp], gates [T, 2, NS+NP] i32)."""
    c = spec.consts
    Hp, Wp = spec.extent
    ray, tile = _ray_planes(c, cam, Hp, Wp, spec.bh, spec.bw)
    zero = torch.zeros((Hp, Wp), dtype=torch.float32, device=cam.device)
    acc0 = (zero, zero, zero, torch.full_like(zero, c.far), zero, zero, zero)
    gates = torch.zeros((lists.shape[0], 2, sph.shape[1] + pl.shape[1]), dtype=torch.int32,
                        device=cam.device)
    m, s, acc = _forward_sweep(c, spec, sph, pl, cam, lists, ray, tile, acc0, gates)
    inv_s = 1.0 / s
    alpha = 1.0 - torch.exp(c.bg_logit - m) * inv_s
    return torch.stack([a * inv_s for a in acc] + [alpha, m, s]), gates


def soft_bwd_plain(sph, pl, cam, lists, offsets, gates, sav, g, *, spec: SoftSpec,
                   n_entries: int):
    """K2 in torch ops: returns the partials (pvals [E, 8], ppl [T, NP, 12],
    ptf [T, 13, 2])."""
    c = spec.consts
    Hp, Wp = spec.extent
    ray, tile = _ray_planes(c, cam, Hp, Wp, spec.bh, spec.bw)
    m, s = sav[SO_M], sav[SO_S]
    inv_s = 1.0 / s
    w_bg = torch.exp(c.bg_logit - m) * inv_s
    gv = tuple(g[i] for i in range(SO_R, SO_NZ + 1))
    S = gv[0] * sav[SO_R]
    for i in range(1, 7):
        S = S + gv[i] * sav[SO_R + i]
    S = S - g[SO_ALPHA] * w_bg
    return _backward_sweep(c, spec, sph, pl, cam, lists, offsets, gates, ray, tile, m, inv_s,
                           gv, S, n_entries)


def soft_mse_plain(sph, pl, cam, lists, offsets, tgt, *, spec: SoftSpec, n_entries: int):
    """K3 in torch ops: the rgb-only forward sweep, the masked MSE and its
    cotangents, and K2's sweep at loss-cotangent 1. Returns the partials;
    the loss is two-float slot 12 (sum of squared differences / 255^2)."""
    c = spec.consts
    Hp, Wp = spec.extent
    ray, tile = _ray_planes(c, cam, Hp, Wp, spec.bh, spec.bw)
    zero = torch.zeros((Hp, Wp), dtype=torch.float32, device=cam.device)
    gates = torch.zeros((lists.shape[0], 2, sph.shape[1] + pl.shape[1]), dtype=torch.int32,
                        device=cam.device)
    m, s, acc = _forward_sweep(c, spec, sph, pl, cam, lists, ray, tile, (zero, zero, zero), gates)
    inv_s = 1.0 / s
    out = [a * inv_s for a in acc]
    H, W = spec.config.height, spec.config.width
    rows = torch.arange(Hp, device=cam.device)[:, None]
    cols = torch.arange(Wp, device=cam.device)[None, :]
    mask = ((rows < H) & (cols < W)).float()
    diff = [(out[ch] - tgt[ch]) * mask for ch in range(3)]
    scale = O.f32(2.0 / (255.0 * 255.0 * 3.0 * H * W))
    g_rgb = [scale * d for d in diff]
    S = g_rgb[0] * out[0] + g_rgb[1] * out[1] + g_rgb[2] * out[2]
    gv = tuple(g_rgb) + (zero, zero, zero, zero)
    spec_b = dataclasses.replace(spec, bwd_cull=spec.cull)
    pvals, ppl, ptf = _backward_sweep(c, spec_b, sph, pl, cam, lists, offsets, gates, ray, tile,
                                      m, inv_s, gv, S, n_entries)
    hi, lo = block_tf_sum_plain(tile_view(diff[0] * diff[0] + diff[1] * diff[1]
                                          + diff[2] * diff[2], spec.bh, spec.bw))
    ptf[:, SLOT_LOSS, 0], ptf[:, SLOT_LOSS, 1] = hi, lo
    return pvals, ppl, ptf


# -- wrappers ---------------------------------------------------------------------

def list_entries(lists: torch.Tensor):
    """(offsets [T] i32, pidx [E] i32): where each tile's slots start in the
    compact sphere partials, and the sphere of every entry (tile order,
    then slot order)."""
    cnt = lists[:, 0, 0]
    offsets = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    ns = lists.shape[2] - 1
    slot = torch.arange(ns, device=lists.device)[None, :] < cnt[:, None]
    return offsets.contiguous(), lists[:, 0, 1:][slot].to(torch.int32).contiguous()


def soft_fwd(sph, pl, cam, lists, *, spec: SoftSpec):
    """K1: (planes [10, Hp, Wp] f32, gates [T, 2, NS+NP] i32)."""
    _check(spec, sph, pl, cam, lists)
    if sph.device.type == "cpu":
        return soft_fwd_plain(sph, pl, cam, lists, spec=spec)
    Hp, Wp = spec.extent
    out = torch.empty((N_PLANES, Hp, Wp), dtype=torch.float32, device=sph.device)
    gates = torch.zeros((lists.shape[0], 2, sph.shape[1] + pl.shape[1]), dtype=torch.int32,
                        device=sph.device)
    prm = _params(spec, sph, pl, lists)
    prm.cull = int(spec.cull)
    _launch("rtwc_soft_fwd", "soft_fwd", (cam, sph, pl, lists, out, gates), prm, sph)
    return out, gates


def _partials(spec: SoftSpec, sph, pl, n_entries: int):
    T = spec.grid[0] * spec.grid[1]
    dev = sph.device
    return (torch.zeros((max(n_entries, 1), 8), dtype=torch.float32, device=dev),
            torch.zeros((T, pl.shape[1], P.PL_ROWS), dtype=torch.float32, device=dev),
            torch.zeros((T, NTF, 2), dtype=torch.float32, device=dev))


def soft_bwd(sph, pl, cam, lists, offsets, gates, sav, g, *, spec: SoftSpec, n_entries: int):
    """K2: the partials (pvals, ppl, ptf) for the cotangent planes g."""
    Hp, Wp = spec.extent
    _check(spec, sph, pl, cam, lists, offsets=(offsets, torch.int32, 1),
           gates=(gates, torch.int32, 3), sav=(sav, torch.float32, 3), g=(g, torch.float32, 3))
    if tuple(sav.shape) != (N_PLANES, Hp, Wp) or tuple(g.shape) != (N_PLANES, Hp, Wp):
        raise ValueError(f"saved planes and cotangents must be [10, {Hp}, {Wp}]")
    if sph.device.type == "cpu":
        return soft_bwd_plain(sph, pl, cam, lists, offsets, gates, sav, g, spec=spec,
                              n_entries=n_entries)
    pvals, ppl, ptf = _partials(spec, sph, pl, n_entries)
    prm = _params(spec, sph, pl, lists)
    prm.cull = int(spec.bwd_cull)
    _launch("rtwc_soft_bwd", "soft_bwd",
            (cam, sph, pl, lists, offsets, gates, sav, g, pvals, ppl, ptf), prm, sph)
    return pvals, ppl, ptf


def soft_mse(sph, pl, cam, lists, offsets, tgt, *, spec: SoftSpec, n_entries: int):
    """K3: the partials (pvals, ppl, ptf) of the fused MSE step at
    loss-cotangent 1; ptf's slot 12 holds the loss sum."""
    Hp, Wp = spec.extent
    _check(spec, sph, pl, cam, lists, offsets=(offsets, torch.int32, 1),
           tgt=(tgt, torch.float32, 3))
    if tuple(tgt.shape) != (3, Hp, Wp):
        raise ValueError(f"target must be [3, {Hp}, {Wp}], got {tuple(tgt.shape)}")
    if sph.device.type == "cpu":
        return soft_mse_plain(sph, pl, cam, lists, offsets, tgt, spec=spec, n_entries=n_entries)
    pvals, ppl, ptf = _partials(spec, sph, pl, n_entries)
    prm = _params(spec, sph, pl, lists)
    prm.cull = int(spec.cull)
    _launch("rtwc_soft_mse", "soft_mse",
            (cam, sph, pl, lists, offsets, tgt, pvals, ppl, ptf), prm, sph)
    return pvals, ppl, ptf


def soft_grad_reduce(pvals, pidx, ppl, ptf, ns: int):
    """Sum the partials in a fixed order: (dsph [8, NS], dpl [12, NP],
    two-float pairs [13, 2])."""
    dev = pvals.device
    for name, t, dtype, ndim in (("pvals", pvals, torch.float32, 2),
                                 ("pidx", pidx, torch.int32, 1),
                                 ("ppl", ppl, torch.float32, 3),
                                 ("ptf", ptf, torch.float32, 3)):
        if t.device != dev or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} tensor on {dev}")
    if pvals.shape[0] < pidx.shape[0] or pvals.shape[1] != 8 or ppl.shape[2] != P.PL_ROWS \
            or ptf.shape[2] != 2 or ppl.shape[0] != ptf.shape[0]:
        raise ValueError("partials do not fit together")
    n = pidx.shape[0]
    if dev.type == "cpu":
        return soft_grad_reduce_plain(pvals[:n], pidx, ppl, ptf, ns)
    if dev.type != "cuda":
        raise ValueError(f"soft_grad_reduce runs on cuda or cpu, not {dev}")
    npl = ppl.shape[1]
    dsph = torch.empty((P.SPH_ROWS, ns), dtype=torch.float32, device=dev)
    dpl = torch.empty((P.PL_ROWS, npl), dtype=torch.float32, device=dev)
    dtf = torch.empty((ptf.shape[1], 2), dtype=torch.float32, device=dev)
    prm = ReduceParams(ns=ns, np=npl, n_entries=n, n_tiles=ppl.shape[0], ntf=ptf.shape[1],
                       device=_device_index(pvals))
    _launch("rtwc_soft_grad_reduce", "soft_grad_reduce",
            (pvals, pidx, ppl, ptf, dsph, dpl, dtf), prm, pvals)
    return dsph, dpl, dtf


# -- autograd ---------------------------------------------------------------------

def build_lists(sph, cam, spec: SoftSpec, cull: bool):
    return sphere_tile_lists(sph, cam, spec.config, spec.tau, spec.bh, spec.bw, spec.grid,
                             disable=not cull)[0]


def _dcam(dtf: torch.Tensor) -> torch.Tensor:
    """[1, 16] camera cotangent from the two-float pairs (hi + lo)."""
    tot = dtf[:, 0] + dtf[:, 1]
    return torch.cat([tot[:P.C_NSPH], torch.zeros(P.CAM_LEN - P.C_NSPH, dtype=tot.dtype,
                                                  device=tot.device)])[None, :]


class SoftRender(torch.autograd.Function):
    """planes [10, Hp, Wp] = K1(sph, pl, cam); backward = K2 + the
    reduction (the counterpart of `soft_packed`, pallas_soft.py:2604-2622).
    Cotangents on the m / s planes are discarded: the closed-form softmax
    VJP already accounts for the normaliser."""

    @staticmethod
    def forward(ctx, sph, pl, cam, spec: SoftSpec):
        lists = build_lists(sph, cam, spec, spec.cull)
        out, gates = soft_fwd(sph, pl, cam, lists, spec=spec)
        ctx.spec = spec
        ctx.save_for_backward(sph, pl, cam, out, gates, lists)
        return out

    @staticmethod
    def backward(ctx, g):
        sph, pl, cam, out, gates, lists = ctx.saved_tensors
        spec = ctx.spec
        if spec.bwd_cull != spec.cull:
            lists = build_lists(sph, cam, spec, spec.bwd_cull)
        offsets, pidx = list_entries(lists)
        pvals, ppl, ptf = soft_bwd(sph, pl, cam, lists, offsets, gates, out, g.contiguous(),
                                   spec=spec, n_entries=pidx.shape[0])
        dsph, dpl, dtf = soft_grad_reduce(pvals, pidx, ppl, ptf, sph.shape[1])
        return dsph, dpl, _dcam(dtf), None


def _mse_via_k1(sph, pl, cam, tgt, spec: SoftSpec):
    """The un-differentiated loss: K1 and the mean in torch."""
    H, W = spec.config.height, spec.config.width
    out = soft_fwd(sph, pl, cam, build_lists(sph, cam, spec, spec.cull), spec=spec)[0]
    d = (out[SO_R:SO_B + 1, :H, :W] - tgt[:, :H, :W]) / torch.tensor(
        255.0, dtype=torch.float32, device=out.device)
    return torch.mean(d * d)


class SoftMSE(torch.autograd.Function):
    """loss = mean(((rgb - tgt) / 255)^2) over the image (the counterpart of
    `soft_mse`, pallas_soft.py:2571-2601). Under autograd the forward runs
    K3 at loss-cotangent 1 and keeps the tables, and the backward scales
    them by the incoming gradient; an un-differentiated call runs K1 and
    the loss in torch. The target's cotangent needs the rgb planes, which
    K3 never writes: it recomputes them with K1, only when asked."""

    @staticmethod
    def forward(ctx, sph, pl, cam, tgt, spec: SoftSpec):
        ctx.spec = spec
        if not any(ctx.needs_input_grad[:4]):
            return _mse_via_k1(sph, pl, cam, tgt, spec)
        H, W = spec.config.height, spec.config.width
        inv_n = 1.0 / (3.0 * H * W)
        lists = build_lists(sph, cam, spec, spec.cull)
        offsets, pidx = list_entries(lists)
        pvals, ppl, ptf = soft_mse(sph, pl, cam, lists, offsets, tgt, spec=spec,
                                   n_entries=pidx.shape[0])
        dsph, dpl, dtf = soft_grad_reduce(pvals, pidx, ppl, ptf, sph.shape[1])
        loss = (dtf[SLOT_LOSS, 0] + dtf[SLOT_LOSS, 1]) * O.f32(1.0 / 255.0 ** 2) * inv_n
        ctx.save_for_backward(dsph, dpl, _dcam(dtf), sph, pl, cam, tgt)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        dsph, dpl, dcam, sph, pl, cam, tgt = ctx.saved_tensors
        spec = ctx.spec
        dtgt = None
        if ctx.needs_input_grad[3]:
            H, W = spec.config.height, spec.config.width
            inv_n = 1.0 / (3.0 * H * W)
            lists = build_lists(sph, cam, spec, spec.cull)
            sav = soft_fwd(sph, pl, cam, lists, spec=spec)[0]
            dtgt = torch.zeros_like(tgt)
            dtgt[:, :H, :W] = -gbar * 2.0 * inv_n / (255.0 * 255.0) * (
                sav[SO_R:SO_B + 1, :H, :W] - tgt[:, :H, :W])
        return gbar * dsph, gbar * dpl, gbar * dcam, dtgt, None


# -- entry points -------------------------------------------------------------------

def _packed(scene, camera):
    sph, pl, counts = P.pack_scene(scene)
    cam = P.with_counts(P.pack_camera(camera, scene.device), counts)
    return sph, pl, cam


def _spec(config: RenderConfig, tau, bh, bw, cull, bwd_cull, name) -> SoftSpec:
    tau = config.soft_tau if tau is None else tau
    if tau <= 0.0:
        raise ValueError(f"{name} needs tau > 0")
    return SoftSpec(config=config, tau=float(tau), bh=bh, bw=bw, cull=cull, bwd_cull=bwd_cull)


def render_frame_soft_kernel(scene, camera, config: RenderConfig, tau: float | None = None,
                             bh: int = 16, bw: int = 16, cull: bool = True,
                             bwd_cull: bool = True) -> Framebuffer:
    """Differentiable frame render on K1 / K2 (pallas_soft.py:2764-2792):
    gradients reach scene geometry, colours and the camera pose through
    pack_scene / pack_camera. cull / bwd_cull switch off the two-level
    culling of the forward / backward kernel."""
    spec = _spec(config, tau, bh, bw, cull, bwd_cull, "render_frame_soft_kernel")
    out = SoftRender.apply(*_packed(scene, camera), spec)[:, :config.height, :config.width]
    rgb = out[SO_R:SO_B + 1].permute(1, 2, 0)
    normal = out[SO_NX:SO_NZ + 1].permute(1, 2, 0)
    depth = out[SO_DEPTH]
    hit = depth <= config.far * (1.0 - 1e-4)
    return Framebuffer(rgb=rgb, normal=normal, depth=depth, shading=normal[..., 0], hit=hit,
                       coverage=hit.float(), alpha=out[SO_ALPHA])


def render_soft_mse_loss(scene, camera, target, config: RenderConfig, tau: float | None = None,
                         bh: int = 16, bw: int = 16, cull: bool = True,
                         bwd_cull: bool = True) -> torch.Tensor:
    """mean(((rgb - target) / 255)^2) of the soft render, target [H, W, 3],
    differentiable in scene, camera and target, with the cotangents derived
    inside K3 (pallas_soft.py:2715-2737). K3 has one cull switch: both
    flags must be on for it to cull, as in JAX."""
    spec = _spec(config, tau, bh, bw, cull and bwd_cull, cull and bwd_cull,
                 "render_soft_mse_loss")
    Hp, Wp = spec.extent
    tgt = target.to(torch.float32).permute(2, 0, 1)
    tgt = torch.nn.functional.pad(tgt, (0, Wp - config.width, 0, Hp - config.height))
    sph, pl, cam = _packed(scene, camera)
    tgt = tgt.contiguous()
    if not torch.is_grad_enabled():  # SoftMSE would still see needs_input_grad
        return _mse_via_k1(sph, pl, cam, tgt, spec)
    return SoftMSE.apply(sph, pl, cam, tgt, spec)
