"""K4, K5, K6 and K4-stats (the shadowed soft train path): wrappers, plain
versions, and the cache diagnostics built on K4-stats.

Replaces the config.shadows branches of rtwc_tpu/render/pallas_soft.py:
K4 `_soft_sh_fwd_body` (:1727-1921, pl.pallas_call at :2434), K5
`_soft_sh_bwd_body` (:1496-1725, :2476), K6 the shadowed branch of
`_soft_mse_fused_body` (:1923-2347, :2526), and K4-stats
`_build_cache_stats` (:2796, :2822) with `soft_cache_stats` (:2851) and
`soft_tile_diagnostics` (:2874). The CUDA kernels are csrc/soft_shadow.cu;
their source note says what bounds them. The autograd Functions and entry
points of render/soft_kernel.py route here when `config.shadows` is on.

K4 writes 14 planes: K1's ten, the light visibility vis at the blended hit
point, and d(rgb)/d(vis) (the clamp-gated direct-light blend), from which
K5 forms dL/dvis. The clamp correction reads a per-pixel cache of NC = 8
slots (t_eff, dterm, sterm) filled in sweep-1 order; a tile with more
culled-in objects than NC takes the exact re-walk. JAX's 29 / 21 slots come
from the TPU's VMEM; `soft_cache_stats` reports NC in their place. On the
card K4 keeps that cache in shared memory, and stages the tile's two list
rows and their spheres' parameters there at block start
(`fwd_shared_bytes`), where JAX's kernels read the lists from SMEM by
scalar prefetch; the values and their order are the plain version's.

K6 splits its tiles in two classes (`tile_classes`): a tile whose view list
and shadow list are both empty is plane-only, and runs a variant of the
kernel with the sphere sweeps compiled out at higher occupancy; the others
run the full kernel. Each tile's partial rows are the same in either (the
plain version has one path), and the split is made on the card, into a
work buffer of `K6_WORK_HEADER + 2 T` ints the wrapper allocates. The
tiles each class ran are counted, as the telemetry counters
`k6.tiles_plane_only` and `k6.tiles_full`: on the card in one int64 [2]
buffer a device, which only `tile_counts()` (a source of
`utils/telemetry.counters()`) reads, never a step; for CPU tensors from
`tile_classes` on the host.

K5 and K6 write K2's partials plus a compact [E_sh, 4] table of shadow
occluder gradients keyed by shadow-list slot (`sh_offsets[tile] + slot`),
which `soft_grad_reduce` adds to the sphere rows; plane rows carry the
shadow sweep's partial plus the main sweep's. On the card their per-object
block sums go through a shared-memory slab of SLAB slots that is summed
once it is full or its sweep ends (csrc/soft_block.cuh `Slab`); the order
of the additions is block_sum_plain's, so the plain versions do not see it.

Wrappers (`soft_sh_fwd`, `soft_sh_stats`, `soft_sh_bwd`, `soft_sh_mse`) run
the plain version for CPU tensors only; for CUDA tensors they launch the
kernel or raise, and count launches in soft_kernel.LAUNCHES. The plain
versions repeat the kernels' arithmetic op for op, their block-uniform
gates and their summation trees.
"""
from __future__ import annotations

import dataclasses

import torch

from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render import soft_core as C
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.list_kernel import build_tile_lists
from rtwc_tpu_torch.utils.telemetry import add_source

(SO_VIS, SO_DVR, SO_DVG, SO_DVB) = range(10, 14)
N_PLANES_SH = 14
NC = 8                       # clamp-correction cache slots (csrc/soft_shadow.cu)
SLAB = 32                    # slab slots of the backward sweeps (csrc/soft_block.cuh SLAB_SLOTS)
STAGED = 7                   # parameters of a staged sphere (csrc/soft_block.cuh STAGED)
VIS_EARLY_OUT = O.f32(1e-7)  # the all-dark early-out threshold (pallas_soft.py:995)
ST_FIELDS = 27               # floats a thread of the stash (csrc/soft_block.cuh StashField)
K6_WORK_HEADER = 4           # K6's work buffer: the classes' counts and claim counters

# Tiles K6 ran by class, (plane-only, full): plain runs' on the host, and one
# int64 [2] buffer a card that K6's blocks add to.
_HOST_TILES = [0, 0]
_CARD_TILES: dict[torch.device, torch.Tensor] = {}


def fwd_shared_bytes(n_planes: int, list_stride: int) -> int:
    """Dynamic shared memory a K4 / K4-stats block takes (csrc/soft_shadow.cu
    `sh_fwd_smem`): the plane table, the cache colours, the list row and the
    shadow list row with their staged spheres, and the clamp cache."""
    return 4 * (P.PL_ROWS * n_planes + 3 * NC + 2 * list_stride + 2 * STAGED * (list_stride - 1)
                + 3 * NC * C.MAX_THREADS)


def k6_shared_bytes(n_spheres: int, n_planes: int, list_stride: int, plane_only: bool) -> int:
    """Dynamic shared memory a K6 block takes (csrc/soft_shadow.cu
    `k6_smem`): the plane table, the cache colours, both gate rows, the list
    rows with their staged spheres (not in the plane-only variant), and the
    clamp cache, whose space the backward's stash takes after the forward."""
    lists = 0 if plane_only else 2 * list_stride + 2 * STAGED * (list_stride - 1)
    return 4 * (P.PL_ROWS * n_planes + 3 * NC + 2 * (n_spheres + n_planes) + lists
                + max(3 * NC, ST_FIELDS) * C.MAX_THREADS)


def build_lists(sph, pl, cam, spec: C.SoftSpec, cull: bool):
    """(view lists, shadow lists), both [T, 1, NS+1] i32, from one cone
    computation."""
    return build_tile_lists(sph, pl, cam, spec.config, spec.tau, spec.bh, spec.bw, spec.grid,
                            True, disable=not cull)


def tile_classes(lists, shl):
    """K6's tile classes (csrc/soft_shadow.cu `soft_sh_mse_classify`):
    (plane-only tiles, the other tiles), int32 indices in tile order (the
    kernel's order differs between runs of 256 tiles; no sum depends on
    it). A tile is plane-only when its view list and its shadow list are
    both empty."""
    tiles = torch.arange(lists.shape[0], dtype=torch.int32, device=lists.device)
    po = (lists[:, 0, 0] == 0) & (shl[:, 0, 0] == 0)
    return tiles[po], tiles[~po]


def tile_counts() -> dict:
    """The tiles K6 ran in each class, over the process: the host's count
    and every card's buffer (read after a synchronise of its card)."""
    po, full = _HOST_TILES
    for dev, buf in _CARD_TILES.items():
        torch.cuda.synchronize(dev)
        a, b = buf.tolist()
        po, full = po + a, full + b
    return {"k6.tiles_plane_only": po, "k6.tiles_full": full}


add_source(tile_counts)


def _card_tiles(dev: torch.device) -> torch.Tensor:
    """The card's tile counters, made by the first call on it, which must
    not be a capture (a capture would zero them at each replay)."""
    buf = _CARD_TILES.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K6's tile counters are made by an eager call: call soft_sh_mse "
                               "once on this card before capturing it")
        buf = _CARD_TILES[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return buf


def _check(spec, sph, pl, cam, lists, shl, **extra):
    if tuple(shl.shape) != tuple(lists.shape):
        raise ValueError(f"shadow lists must be shaped like the view lists {tuple(lists.shape)}, "
                         f"got {tuple(shl.shape)}")
    C._check(spec, sph, pl, cam, lists, shl=(shl, torch.int32, 3), **extra)


# -- the plain versions' sweeps ---------------------------------------------------

def _tile_any(x, spec):
    return C.tile_view(x, spec.bh, spec.bw).any(dim=1)


def _tile_all(x, spec):
    return C.tile_view(x, spec.bh, spec.bw).all(dim=1)


def _sh_forward(c, spec: C.SoftSpec, sph, pl, cam, lists, shl, ray, tile, gates):
    """K4's forward (also K6's): fills both gate rows and returns the per
    pixel (m, s, inv_s, depth, normal[3], rgb[3], dv[3], vis) and the per
    tile (count, napp)."""
    dx, dy, dz = ray[:3]
    ox, oy, oz = cam[0, 0], cam[0, 1], cam[0, 2]
    dev = cam.device
    ns = sph.shape[1]
    Hp, Wp = tile.shape
    T = lists.shape[0]
    tiles = torch.arange(T, device=dev)
    zero = torch.zeros((Hp, Wp), dtype=torch.float32, device=dev)
    m = torch.full_like(zero, c.bg_logit)
    s = torch.ones_like(zero)
    acc = [torch.full_like(zero, c.far)] + [zero] * 9
    count = torch.zeros(T, dtype=torch.int64, device=dev)
    cache = [[zero] * 3 for _ in range(NC)]                # slot -> (t_eff, dterm, sterm)
    ccol = torch.zeros((T, NC, 3), dtype=torch.float32, device=dev)
    n_pl = int(cam[0, P.C_NPL].item())

    def fused_accumulate(rel_t, geo, col, col_t, sn):
        """One step of sweep 1 where rel_t [T]; col per pixel, col_t per tile."""
        nonlocal m, s, acc, count
        t_eff, t_clip, nx, ny, nz, px, py, pz = geo
        upd = rel_t[tile]
        dterm, sterm = O.shade_terms(c, px, py, pz, *sn, dx, dy, dz)
        (ar, br), (ag, bg), (ab, bb) = O.parts_from_terms(c, dterm, sterm, *col)
        logit = -t_eff * c.inv_tau
        m_new = torch.maximum(m, logit)
        e = torch.exp(-(logit - m).abs())
        up = logit > m
        alpha = torch.where(up, e, 1.0)
        pw = torch.where(up, 1.0, e)
        s = torch.where(upd, s * alpha + pw, s)
        vals = (t_clip, nx, ny, nz, ar, ag, ab, br, bg, bb)
        acc = [torch.where(upd, a * alpha + pw * v, a) for a, v in zip(acc, vals)]
        m = torch.where(upd, m_new, m)
        slot = count[tile]
        for j in range(NC):
            sel = upd & (slot == j)
            cache[j] = [torch.where(sel, v, old) for v, old in zip((t_eff, dterm, sterm), cache[j])]
        put = rel_t & (count < NC)
        ccol[tiles[put], count[put]] = torch.stack(col_t, dim=-1)[put]
        count = count + rel_t

    # ---- sweep 1
    C.object_sweep(c, spec, sph, pl, cam, lists, ray, tile, lambda: m, fused_accumulate, gates)
    inv_s = 1.0 / s
    depth = acc[0] * inv_s

    # ---- the shadow sweep: planes first, then the shadow list
    lr = O.light_ray(c, ox + dx * depth, oy + dy * depth, oz + dz * depth)
    vis = torch.ones_like(zero)
    dark = torch.zeros(T, dtype=torch.bool, device=dev)
    napp = torch.zeros(T, dtype=torch.int64, device=dev)

    def apply(rel_t, args):
        nonlocal vis, dark, napp
        vis = torch.where(rel_t[tile], vis * O.shadow_transmittance(c, args), vis)
        if spec.cull:
            dark = torch.where(rel_t, _tile_all(vis <= VIS_EARLY_OUT, spec), dark)
        napp = napp + rel_t

    for k in range(n_pl):
        min_arg, args = O.shadow_plane_pre(c, *C._plane_args(pl, k)[:8], lr)
        if spec.cull:
            rel_geo = _tile_any(min_arg > c.sh_floor, spec)
            gates[:, 1, ns + k] = rel_geo.to(torch.int32)
            rel = rel_geo & ~dark
        else:
            gates[:, 1, ns + k] = 1
            rel = torch.ones(T, dtype=torch.bool, device=dev)
        apply(rel, args)
    stab = shl[:, 0, :]
    scnt = stab[:, 0]
    for jj in range(int(scnt.max().item()) if T else 0):
        live = jj < scnt
        kt = torch.where(live, stab[:, 1 + jj], 0).long()  # past the count: anything
        disc, dss, b, dist = O.shadow_sphere_preA(c, *C._sphere_geo_args(sph, kt[tile]), lr)
        min_arg, args = O.shadow_sphere_preB(disc, dss, b, dist)
        if spec.cull:
            rel_a = live & _tile_any(dss > c.sh_floor, spec)
            rel_geo = rel_a & _tile_any(min_arg > c.sh_floor, spec)
            gates[tiles[live], 1, kt[live]] = rel_geo[live].to(torch.int32)
            rel = rel_geo & ~dark
        else:
            gates[tiles[live], 1, kt[live]] = 1
            rel = live
        apply(rel, args)

    # ---- the colour blend: the cache where it held every culled-in object
    use_cache = count <= NC
    corr = [zero] * 6
    for j in range(NC):
        valid = ((j < count) & use_cache)[tile]
        t_eff, dterm, sterm = cache[j]
        col = tuple(ccol[:, j, ch][tile] for ch in range(3))
        parts = O.parts_from_terms(c, dterm, sterm, *col)
        w = torch.exp(-t_eff * c.inv_tau - m) * inv_s
        for ch in range(3):
            a, bb = parts[ch]
            val = a + vis * bb
            over = val >= 255.0
            corr[ch] = torch.where(valid, corr[ch] + w * torch.where(over, val - 255.0, 0.0),
                                   corr[ch])
            corr[3 + ch] = torch.where(valid, corr[3 + ch] + w * torch.where(over, bb, 0.0),
                                       corr[3 + ch])
    rgb, dv = [], []
    for ch in range(3):
        a, bb = acc[4 + ch] * inv_s, acc[7 + ch] * inv_s
        rgb.append(a + vis * bb - corr[ch])
        dv.append(bb - corr[3 + ch])
    if not bool(use_cache.all()):
        fb = _rewalk(c, spec, sph, pl, cam, lists, ray, tile, m, inv_s, vis)
        keep = use_cache[tile]
        rgb = [torch.where(keep, a, b) for a, b in zip(rgb, fb[:3])]
        dv = [torch.where(keep, a, b) for a, b in zip(dv, fb[3:])]
    normal = [acc[1 + ch] * inv_s for ch in range(3)]
    return (m, s, inv_s, depth, normal, rgb, dv, vis), (count, napp)


def _rewalk(c, spec, sph, pl, cam, lists, ray, tile, m, inv_s, vis):
    """The exact re-walk (pallas_soft.py:1145-1208), gated on the final m:
    returns (r, g, b, dvr, dvg, dvb)."""
    dx, dy, dz = ray[:3]
    out = [torch.zeros_like(m)] * 6

    def shade_accumulate(rel_t, geo, col, col_t, sn):
        upd = rel_t[tile]
        t_eff, _, _, _, _, px, py, pz = geo
        w = torch.exp(-t_eff * c.inv_tau - m) * inv_s
        dterm, sterm = O.shade_terms(c, px, py, pz, *sn, dx, dy, dz)
        parts = O.parts_from_terms(c, dterm, sterm, *col)
        for ch in range(3):
            a, b = parts[ch]
            val = a + vis * b
            gate = (val < 255.0).to(torch.float32)
            out[ch] = torch.where(upd, out[ch] + w * torch.clamp(val, max=255.0), out[ch])
            out[3 + ch] = torch.where(upd, out[3 + ch] + w * b * gate, out[3 + ch])

    C.object_sweep(c, spec, sph, pl, cam, lists, ray, tile, lambda: m, shade_accumulate)
    return out


def _sh_backward(c, spec: C.SoftSpec, sph, pl, cam, lists, shl, offsets, sh_offsets, gates, ray,
                 tile, m, inv_s, vis, depth, out_rgb, out_n, g_rgb, g_n, g_depth0, g_alpha, w_bg,
                 g_vis):
    """K5's sweeps (also K6's backward): the shadow sweep's adjoint at the
    blended hit point, then K2's sweep shaded and seeded. Returns the
    partials (pvals, psh, ppl, ptf)."""
    dx, dy, dz = ray[:3]
    ox, oy, oz = cam[0, 0], cam[0, 1], cam[0, 2]
    dev = cam.device
    ns, npl = sph.shape[1], pl.shape[1]
    T = lists.shape[0]
    tiles = torch.arange(T, device=dev)
    pb = (ox + dx * depth, oy + dy * depth, oz + dz * depth)
    ct_vis = g_vis * vis
    psh = torch.zeros((C.capacity(shl), 4), dtype=torch.float32, device=dev)
    ppl = torch.zeros((T, npl, P.PL_ROWS), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(m)
    ctp = [zero, zero, zero]

    def tile_sums(x, upd):
        return C.block_sum_plain(C.tile_view(torch.where(upd, x, 0.0), spec.bh, spec.bw))

    stab = shl[:, 0, :]
    scnt = stab[:, 0]
    for jj in range(int(scnt.max().item()) if T else 0):
        live = jj < scnt
        kt = torch.where(live, stab[:, 1 + jj], 0).long()  # past the count: anything
        rel = live & (gates[tiles, 1, kt] == 1) if spec.bwd_cull else live
        upd = rel[tile]
        geo4 = C._sphere_geo_args(sph, kt[tile])
        f = O.shadow_sphere_f(c, *geo4, *pb)
        grads = O.shadow_sphere_f_vjp(c, *geo4, *pb, ct_vis / f)
        rows = torch.stack([tile_sums(grads[r], upd) for r in range(4)], dim=1)
        psh[(sh_offsets.long() + jj)[rel]] = rows[rel]
        ctp = [torch.where(upd, a + g, a) for a, g in zip(ctp, grads[4:7])]
    for k in range(int(cam[0, P.C_NPL].item())):
        rel = (gates[:, 1, ns + k] == 1) if spec.bwd_cull else torch.ones(T, dtype=torch.bool,
                                                                          device=dev)
        upd = rel[tile]
        args = C._plane_args(pl, k)[:8]
        f = O.shadow_plane_f(c, *args, *pb)
        grads = O.shadow_plane_f_vjp(c, *args, *pb, ct_vis / f)
        ppl[:, k, :8] = torch.stack([tile_sums(grads[r], upd) for r in range(8)], dim=1)
        ctp = [torch.where(upd, a + g, a) for a, g in zip(ctp, grads[8:11])]
    g_depth = g_depth0 + (ctp[0] * dx + ctp[1] * dy + ctp[2] * dz)
    S = g_rgb[0] * out_rgb[0]
    S = S + g_rgb[1] * out_rgb[1]
    S = S + g_rgb[2] * out_rgb[2]
    S = S + g_depth * depth
    for i in range(3):
        S = S + g_n[i] * out_n[i]
    S = S - g_alpha * w_bg
    gv = tuple(g_rgb) + (g_depth,) + tuple(g_n)
    seed = ([a * depth for a in ctp], ctp)
    pvals, ppl, ptf = C._backward_sweep(c, spec, sph, pl, cam, lists, offsets, gates, ray, tile,
                                         m, inv_s, gv, S, vis=vis, seed=seed, ppl=ppl)
    return pvals, psh, ppl, ptf


# -- the plain versions --------------------------------------------------------------

def _fwd_plain(sph, pl, cam, lists, shl, spec):
    c = spec.consts
    Hp, Wp = spec.extent
    ray, tile = C._ray_planes(c, cam, Hp, Wp, spec.bh, spec.bw)
    gates = torch.zeros((lists.shape[0], 2, sph.shape[1] + pl.shape[1]), dtype=torch.int32,
                        device=cam.device)
    (m, s, inv_s, depth, n, rgb, dv, vis), (count, napp) = _sh_forward(
        c, spec, sph, pl, cam, lists, shl, ray, tile, gates)
    alpha = 1.0 - torch.exp(c.bg_logit - m) * inv_s
    out = torch.stack(rgb + [depth] + n + [alpha, m, s, vis] + dv)
    return out, gates, torch.stack([count, napp], dim=1).to(torch.int32)


def soft_sh_fwd_plain(sph, pl, cam, lists, shl, *, spec: C.SoftSpec):
    """K4 in torch ops: (planes [14, Hp, Wp], gates [T, 2, NS+NP] i32)."""
    return _fwd_plain(sph, pl, cam, lists, shl, spec)[:2]


def soft_sh_stats_plain(sph, pl, cam, lists, shl, *, spec: C.SoftSpec):
    """K4-stats in torch ops: (planes, gates, counts [T, 2] i32: culled-in
    main objects, applied occluders)."""
    return _fwd_plain(sph, pl, cam, lists, shl, spec)


def soft_sh_bwd_plain(sph, pl, cam, lists, shl, offsets, sh_offsets, gates, sav, g, *,
                      spec: C.SoftSpec):
    """K5 in torch ops: the partials (pvals [T NS, 8], psh [T NS, 4],
    ppl [T, NP, 12], ptf [T, 13, 2])."""
    c = spec.consts
    Hp, Wp = spec.extent
    ray, tile = C._ray_planes(c, cam, Hp, Wp, spec.bh, spec.bw)
    m = sav[C.SO_M]
    inv_s = 1.0 / sav[C.SO_S]
    w_bg = torch.exp(c.bg_logit - m) * inv_s
    g_vis = g[C.SO_R] * sav[SO_DVR] + g[C.SO_G] * sav[SO_DVG] + g[C.SO_B] * sav[SO_DVB]
    return _sh_backward(c, spec, sph, pl, cam, lists, shl, offsets, sh_offsets, gates, ray, tile,
                        m, inv_s, sav[SO_VIS], sav[C.SO_DEPTH], sav[0:3], sav[4:7], g[0:3],
                        g[4:7], g[C.SO_DEPTH], g[C.SO_ALPHA], w_bg, g_vis)


def soft_sh_mse_plain(sph, pl, cam, lists, shl, offsets, sh_offsets, tgt, *, spec: C.SoftSpec):
    """K6 in torch ops: K4's forward, the masked MSE and its cotangents,
    K5's sweeps at loss-cotangent 1. Returns the partials; ptf's slot 12
    holds the loss sum."""
    c = spec.consts
    Hp, Wp = spec.extent
    dev = cam.device
    ray, tile = C._ray_planes(c, cam, Hp, Wp, spec.bh, spec.bw)
    gates = torch.zeros((lists.shape[0], 2, sph.shape[1] + pl.shape[1]), dtype=torch.int32,
                        device=dev)
    (m, _, inv_s, depth, n, rgb, dv, vis), _ = _sh_forward(c, spec, sph, pl, cam, lists, shl,
                                                           ray, tile, gates)
    H, W = spec.rows, spec.config.width
    rows = torch.arange(Hp, device=dev)[:, None]
    cols = torch.arange(Wp, device=dev)[None, :]
    mask = ((rows < H) & (cols < W)).float()
    diff = [(rgb[ch] - tgt[ch]) * mask for ch in range(3)]
    scale = O.f32(2.0 / (255.0 * 255.0 * 3.0 * H * W))
    g_rgb = [scale * d for d in diff]
    g_vis = g_rgb[0] * dv[0] + g_rgb[1] * dv[1] + g_rgb[2] * dv[2]
    zero = torch.zeros_like(m)
    spec_b = dataclasses.replace(spec, bwd_cull=spec.cull)
    pvals, psh, ppl, ptf = _sh_backward(c, spec_b, sph, pl, cam, lists, shl, offsets, sh_offsets,
                                        gates, ray, tile, m, inv_s, vis, depth, rgb, n, g_rgb,
                                        (zero, zero, zero), zero, zero, zero, g_vis)
    hi, lo = C.block_tf_sum_plain(C.tile_view(diff[0] * diff[0] + diff[1] * diff[1]
                                                + diff[2] * diff[2], spec.bh, spec.bw))
    ptf[:, C.SLOT_LOSS, 0], ptf[:, C.SLOT_LOSS, 1] = hi, lo
    return pvals, psh, ppl, ptf


# -- wrappers -----------------------------------------------------------------------

def _require_shadows(spec: C.SoftSpec):
    if not spec.config.shadows:
        raise ValueError("the shadowed kernels need config.shadows=True")


def _fwd(sph, pl, cam, lists, shl, spec, stats: bool):
    _require_shadows(spec)
    _check(spec, sph, pl, cam, lists, shl)
    if sph.device.type == "cpu":
        res = _fwd_plain(sph, pl, cam, lists, shl, spec)
        return res if stats else res[:2]
    Hp, Wp = spec.extent
    T = lists.shape[0]
    out = torch.empty((N_PLANES_SH, Hp, Wp), dtype=torch.float32, device=sph.device)
    gates = torch.zeros((T, 2, sph.shape[1] + pl.shape[1]), dtype=torch.int32, device=sph.device)
    counts = torch.zeros((T, 2), dtype=torch.int32, device=sph.device) if stats else None
    prm = C._params(spec, sph, pl, lists)
    prm.cull = int(spec.cull)
    C._launch("rtwc_soft_sh_fwd", "soft_sh_stats" if stats else "soft_sh_fwd",
               (cam, sph, pl, lists, shl, out, gates, counts), prm, sph)
    return (out, gates, counts) if stats else (out, gates)


def soft_sh_fwd(sph, pl, cam, lists, shl, *, spec: C.SoftSpec):
    """K4: (planes [14, Hp, Wp] f32, gates [T, 2, NS+NP] i32)."""
    return _fwd(sph, pl, cam, lists, shl, spec, stats=False)


def soft_sh_stats(sph, pl, cam, lists, shl, *, spec: C.SoftSpec):
    """K4-stats: K4's outputs and counts [T, 2] i32 (the culled-in main
    count, i.e. the cache demand, and the applied occluder count)."""
    return _fwd(sph, pl, cam, lists, shl, spec, stats=True)


def _partials(spec, sph, pl, lists, shl, pvals=None, psh=None):
    pvals, ppl, ptf = C._partials(spec, sph, pl, lists, pvals)
    return pvals, C.partial_rows(shl, 4, psh, "psh", sph.device), ppl, ptf


def soft_sh_bwd(sph, pl, cam, lists, shl, offsets, sh_offsets, gates, sav, g, *,
                spec: C.SoftSpec, pvals=None, psh=None):
    """K5: the partials (pvals, psh, ppl, ptf) for the cotangent planes g;
    pvals / psh: list_kernel.partial_tables' tables, zeroed below the
    counts by entry_tables (None: zero-filled here)."""
    _require_shadows(spec)
    Hp, Wp = spec.extent
    _check(spec, sph, pl, cam, lists, shl, offsets=(offsets, torch.int32, 1),
           sh_offsets=(sh_offsets, torch.int32, 1), gates=(gates, torch.int32, 3),
           sav=(sav, torch.float32, 3), g=(g, torch.float32, 3))
    if tuple(sav.shape) != (N_PLANES_SH, Hp, Wp) or tuple(g.shape) != (N_PLANES_SH, Hp, Wp):
        raise ValueError(f"saved planes and cotangents must be [14, {Hp}, {Wp}]")
    if sph.device.type == "cpu":
        return soft_sh_bwd_plain(sph, pl, cam, lists, shl, offsets, sh_offsets, gates, sav, g,
                                 spec=spec)
    parts = _partials(spec, sph, pl, lists, shl, pvals, psh)
    prm = C._params(spec, sph, pl, lists)
    prm.cull = int(spec.bwd_cull)
    C._launch("rtwc_soft_sh_bwd", "soft_sh_bwd",
               (cam, sph, pl, lists, shl, offsets, sh_offsets, gates, sav, g) + parts, prm, sph)
    return parts


def soft_sh_mse(sph, pl, cam, lists, shl, offsets, sh_offsets, tgt, *, spec: C.SoftSpec,
                pvals=None, psh=None):
    """K6: the partials (pvals, psh, ppl, ptf) of the fused shadowed MSE step
    at loss-cotangent 1; ptf's slot 12 holds the loss sum. pvals / psh as
    soft_sh_bwd takes them."""
    _require_shadows(spec)
    Hp, Wp = spec.extent
    _check(spec, sph, pl, cam, lists, shl, offsets=(offsets, torch.int32, 1),
           sh_offsets=(sh_offsets, torch.int32, 1), tgt=(tgt, torch.float32, 3))
    if tuple(tgt.shape) != (3, Hp, Wp):
        raise ValueError(f"target must be [3, {Hp}, {Wp}], got {tuple(tgt.shape)}")
    if sph.device.type == "cpu":
        po, full = tile_classes(lists, shl)
        _HOST_TILES[0] += po.numel()
        _HOST_TILES[1] += full.numel()
        return soft_sh_mse_plain(sph, pl, cam, lists, shl, offsets, sh_offsets, tgt, spec=spec)
    parts = _partials(spec, sph, pl, lists, shl, pvals, psh)
    prm = C._params(spec, sph, pl, lists)
    prm.cull = int(spec.cull)
    work = torch.empty(K6_WORK_HEADER + 2 * lists.shape[0], dtype=torch.int32, device=sph.device)
    C._launch("rtwc_soft_sh_mse", "soft_sh_mse",
               (cam, sph, pl, lists, shl, offsets, sh_offsets, tgt) + parts
               + (work, _card_tiles(sph.device)), prm, sph)
    return parts


# -- the cache diagnostics (pallas_soft.py:2851-2906) ----------------------------------

def _stats_call(scene, camera, config, tau, bh: int, bw: int):
    spec = C._spec(config, tau, bh, bw, True, True, "soft_cache_stats")
    _require_shadows(spec)
    sph, pl, cam = C._packed(scene, camera)
    lists, shl = build_lists(sph, pl, cam, spec, True)
    _, _, counts = soft_sh_stats(sph, pl, cam, lists, shl, spec=spec)
    return spec, counts, lists, shl, cam


def soft_cache_stats(scene, camera, config, tau: float | None = None, bh: int = 16,
                     bw: int = 16):
    """Per-tile clamp-cache demand of the shadowed forward: (counts [T] i32
    of culled-in objects per tile, forward cache slots, fused cache slots).
    A tile takes the exact re-walk iff its count exceeds the slots; K4 and K6
    both have NC slots."""
    _, counts, _, _, _ = _stats_call(scene, camera, config, tau, bh, bw)
    return counts[:, 0], NC, NC


def soft_tile_diagnostics(scene, camera, config, tau: float | None = None, bh: int = 16,
                          bw: int = 16) -> dict:
    """Per-tile work profile of the shadowed kernels: `main_applied`
    (objects through the heavy intersect + shade and the backward replay),
    `shadow_applied` (occluders whose transmittance ran), `list_len` /
    `shadow_list_len` (broad-phase list lengths), plus bh, bw, n_planes."""
    spec, counts, lists, shl, cam = _stats_call(scene, camera, config, tau, bh, bw)
    return {
        "main_applied": counts[:, 0].cpu().numpy(),
        "shadow_applied": counts[:, 1].cpu().numpy(),
        "list_len": lists[:, 0, 0].cpu().numpy(),
        "shadow_list_len": shl[:, 0, 0].cpu().numpy(),
        "bh": spec.bh, "bw": spec.bw,
        "n_planes": int(cam[0, P.C_NPL].item()),
    }
