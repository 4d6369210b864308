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
`soft_grad_reduce` then sums them in a fixed order (the entries grouped by
sphere with a counting sort, chunks of them and of the tiles summed by
blocks, then the chunks in order), with no float atomics: two launches on
the same inputs give bit-equal tables. Inside a block the per-object sums
are warp butterflies, then the warps' sums in warp order; the plain
versions below reproduce both orders.

Wrappers (`soft_fwd`, `soft_bwd`, `soft_mse`, `soft_grad_reduce`) run the
plain version for CPU tensors only; for CUDA tensors they launch the kernel
or raise. `LAUNCHES` (render/soft_core.py) counts kernel launches by name,
never plain runs, the shadowed kernels' too.

The autograd Functions `SoftRender` / `SoftMSE` and the entry points
`render_frame_soft_kernel` / `render_soft_mse_loss`, and for the row-band
sharding of dist/mesh.py `soft_band_packed` / `soft_band_mse_loss`
(pallas_soft.py:2661-2695), are here, and only here does `config.shadows`
choose: K1 + K2 or K3 without shadows, the shadowed
kernels of render/shadow_kernel.py (K4 + K5 or K6) with them, and the
reduction after either.
"""
from __future__ import annotations

import dataclasses

import torch

from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render import shadow_kernel as SH
from rtwc_tpu_torch.render import soft_core as C
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.list_kernel import (Entries, entry_tables, partial_tables,
                                               sphere_tile_lists)
from rtwc_tpu_torch.render.reference import Framebuffer
from rtwc_tpu_torch.render.soft_core import (  # noqa: F401 (LAUNCHES, NTF: shared names)
    LAUNCHES, NTF, SLOT_LOSS, SO_ALPHA, SO_B, SO_DEPTH, SO_M, SO_NX, SO_NZ, SO_R, SO_S,
    SoftSpec, _accumulate, _backward_sweep, _check, _device_index, _launch, _packed, _params,
    _partials, _ray_planes, _spec, block_sum_plain, block_tf_sum_plain, capacity,
    object_sweep, tile_view)

N_PLANES = 10


# -- the reduction's plain version ------------------------------------------------

def _warp_passes(x: torch.Tensor, combine=None, err=None):
    """The last pass over the first-pass chunks (dim 0), per column: lane l
    of a warp sums chunks l, l + 32, ... in order, then the warp butterfly
    (csrc/soft_render.cu soft_grad_reduce_final). combine / err: the
    two-float version."""
    pad = -x.shape[0] % 32
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        if err is not None:
            err = torch.cat([err, err.new_zeros((pad,) + tuple(err.shape[1:]))])
    x = x.reshape(x.shape[0] // 32, 32, *x.shape[1:])
    acc = torch.zeros_like(x[0])
    if err is None:
        for i in range(x.shape[0]):
            acc = acc + x[i]
        for off in (16, 8, 4, 2, 1):
            acc = acc[:off] + acc[off:2 * off]
        return acc[0]
    err = err.reshape(x.shape)
    acc_e = torch.zeros_like(acc)
    for i in range(x.shape[0]):
        acc, acc_e = combine(acc, acc_e, x[i], err[i])
    for off in (16, 8, 4, 2, 1):
        acc, acc_e = combine(acc[:off], acc_e[:off], acc[off:2 * off], acc_e[off:2 * off])
    return acc[0], acc_e[0]


def _tile_passes(x: torch.Tensor, combine=None, err=None):
    """The first pass over the tiles (dim 0): a block sums tch tiles, warp w
    tiles w, w + 8, ... in order, then its 8 warps in order. Returns the
    chunks' sums [n_tchunks, ...] (two-float, with combine and err: sums
    and errors)."""
    T = x.shape[0]
    tch = C.reduce_tile_chunk(T)
    n_ch = max(1, -(-T // tch))

    def chunks(t):  # tile c*tch + i*8 + w at [c, i, w]
        t = torch.cat([t, t.new_zeros((n_ch * tch - T,) + tuple(t.shape[1:]))])
        return t.reshape(n_ch, tch // 8, 8, *t.shape[1:])

    x = chunks(x)
    acc = torch.zeros_like(x[:, 0])
    if combine is None:
        for i in range(x.shape[1]):
            acc = acc + x[:, i]
        out = acc[:, 0]
        for w in range(1, 8):
            out = out + acc[:, w]
        return out
    e = chunks(err)
    acc_e = torch.zeros_like(acc)
    for i in range(x.shape[1]):
        acc, acc_e = combine(acc, acc_e, x[:, i], e[:, i])
    out, out_e = acc[:, 0], acc_e[:, 0]
    for w in range(1, 8):
        out, out_e = combine(out, out_e, acc[:, w], acc_e[:, w])
    return out, out_e


def soft_grad_reduce_plain(pvals, pidx, ppl, ptf, ns: int, psh=None, pshidx=None, counts=None):
    """The reduction kernels' sums in their order (csrc/soft_render.cu):
    returns dsph [8, NS], dpl [12, NP] and the two-float pairs [NTF, 2].
    psh [E_sh, 4] / pshidx: the shadowed kernels' occluder partials, added
    to rows 0-3 after a sphere's main entries. counts [2] i32: the real
    main and shadow entries, the first of each table (the kernels read them
    from device memory); None: every entry of pidx and pshidx is real. Entries are grouped by
    sphere, main list first, in tile order within a sphere (a stable sort);
    a first pass sums each group's chunks of RED_CHUNK entries as a block
    sum, the last sums a group's chunks as a warp does (_warp_passes) and
    adds a sphere's shadow sums to rows 0-3 of its main ones. The plane
    rows and camera pairs are summed over chunks of tiles, then over the
    chunks (_tile_passes, _warp_passes). Entries whose sphere index lies
    outside [0, ns) are dropped."""
    dev = pvals.device
    n = pidx.shape[0]

    def real(idx, which):
        ok = (idx >= 0) & (idx < ns)
        if counts is None:
            return ok
        return ok & (torch.arange(idx.shape[0], device=dev) < counts[which])

    keys, vals = [pidx.long()], [pvals[:n]]
    if pshidx is not None and pshidx.shape[0]:
        keys.append(pshidx.long() + ns)
        vals.append(torch.nn.functional.pad(psh[:pshidx.shape[0], :4], (0, 4)))
        ok = torch.cat([real(pidx, 0), real(pshidx, 1)])
    else:
        ok = real(pidx, 0)
    key, val = torch.cat(keys)[ok], torch.cat(vals)[ok]
    order = torch.sort(key, stable=True).indices
    key, val = key[order], val[order]
    cnt = torch.bincount(key, minlength=2 * ns)
    start = torch.cumsum(cnt, 0) - cnt
    nch = -(-cnt // C.RED_CHUNK)
    cbase = torch.cumsum(nch, 0) - nch
    pos = torch.arange(key.shape[0], device=dev) - start[key]
    table = torch.zeros((int(nch.sum()), C.RED_CHUNK, 8), dtype=torch.float32, device=dev)
    table[cbase[key] + pos // C.RED_CHUNK, pos % C.RED_CHUNK] = val
    part = (block_sum_plain(table.permute(0, 2, 1).reshape(-1, C.RED_CHUNK)).reshape(-1, 8)
            if table.shape[0] else table[:, 0])
    # a key's chunks in a warp's order: chunk j of key k at [j, k]
    rounds = -(-int(nch.max()) // 32) if ns else 0
    by_key = torch.zeros((32 * max(rounds, 1), 2 * ns, 8), dtype=torch.float32, device=dev)
    owner = torch.repeat_interleave(torch.arange(2 * ns, device=dev), nch)
    by_key[torch.arange(part.shape[0], device=dev) - cbase[owner], owner] = part
    sums = _warp_passes(by_key)                                  # [2 NS, 8]
    dsph = torch.zeros((8, ns), dtype=torch.float32, device=dev)  # S_ACTIVE takes no gradient
    dsph[:4] = (sums[:ns, :4] + sums[ns:, :4]).T                 # main, then shadow rows
    dsph[4:7] = sums[:ns, 4:7].T

    T, npl = ppl.shape[0], ppl.shape[1]
    dpl = _warp_passes(_tile_passes(ppl.reshape(T, npl * P.PL_ROWS)))
    dpl = dpl.reshape(npl, P.PL_ROWS).T.contiguous()            # [12, NP]
    dpl[P.P_ACTIVE] = 0.0
    s, e = _tile_passes(ptf[..., 0], O.tf_combine, ptf[..., 1])
    hi, lo = _warp_passes(s, O.tf_combine, e)
    return dsph, dpl, torch.stack([hi, lo], dim=-1)


def _forward_sweep(c, spec: SoftSpec, sph, pl, cam, lists, ray, tile, acc0, gates):
    """K1's sweep (also K3's): the online softmin over the objects of
    `object_sweep`, accumulating acc0 (the first len(acc0) of rgb, t_clip,
    normal). Fills gate row 0 and returns (m, s, acc)."""
    dx, dy, dz = ray[:3]
    m = torch.full(tile.shape, c.bg_logit, dtype=torch.float32, device=cam.device)
    state = (m, torch.ones_like(m), acc0)
    n_acc = len(acc0)

    def visit(rel, geo, col, col_t, sn):
        nonlocal state
        t_eff, t_clip, nx, ny, nz, px, py, pz = geo
        rgb = O.shade(c, *col, px, py, pz, *sn, dx, dy, dz)
        vals = (t_eff,) + rgb + (t_clip, nx, ny, nz)
        state = _accumulate(c, state, vals[:1 + n_acc], rel[tile])

    object_sweep(c, spec, sph, pl, cam, lists, ray, tile, lambda: state[0], visit, gates)
    return state


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


def soft_bwd_plain(sph, pl, cam, lists, offsets, gates, sav, g, *, spec: SoftSpec):
    """K2 in torch ops: returns the partials (pvals [T NS, 8], ppl [T, NP, 12],
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
                           gv, S)


def soft_mse_plain(sph, pl, cam, lists, offsets, tgt, *, spec: SoftSpec):
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
    H, W = spec.rows, spec.config.width
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
                                      m, inv_s, gv, S)
    hi, lo = block_tf_sum_plain(tile_view(diff[0] * diff[0] + diff[1] * diff[1]
                                          + diff[2] * diff[2], spec.bh, spec.bw))
    ptf[:, SLOT_LOSS, 0], ptf[:, SLOT_LOSS, 1] = hi, lo
    return pvals, ppl, ptf


# -- wrappers ---------------------------------------------------------------------

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


def soft_bwd(sph, pl, cam, lists, offsets, gates, sav, g, *, spec: SoftSpec, pvals=None):
    """K2: the partials (pvals, ppl, ptf) for the cotangent planes g; pvals
    holds capacity(lists) rows, a tile's entries at offsets[tile] + slot.
    pvals: list_kernel.partial_tables' table, zeroed below the count by
    entry_tables (None: zero-filled here)."""
    Hp, Wp = spec.extent
    _check(spec, sph, pl, cam, lists, offsets=(offsets, torch.int32, 1),
           gates=(gates, torch.int32, 3), sav=(sav, torch.float32, 3), g=(g, torch.float32, 3))
    if tuple(sav.shape) != (N_PLANES, Hp, Wp) or tuple(g.shape) != (N_PLANES, Hp, Wp):
        raise ValueError(f"saved planes and cotangents must be [10, {Hp}, {Wp}]")
    if sph.device.type == "cpu":
        return soft_bwd_plain(sph, pl, cam, lists, offsets, gates, sav, g, spec=spec)
    pvals, ppl, ptf = _partials(spec, sph, pl, lists, pvals)
    prm = _params(spec, sph, pl, lists)
    prm.cull = int(spec.bwd_cull)
    _launch("rtwc_soft_bwd", "soft_bwd",
            (cam, sph, pl, lists, offsets, gates, sav, g, pvals, ppl, ptf), prm, sph)
    return pvals, ppl, ptf


def soft_mse(sph, pl, cam, lists, offsets, tgt, *, spec: SoftSpec, pvals=None):
    """K3: the partials (pvals, ppl, ptf) of the fused MSE step at
    loss-cotangent 1; ptf's slot 12 holds the loss sum. pvals as soft_bwd
    takes it."""
    Hp, Wp = spec.extent
    _check(spec, sph, pl, cam, lists, offsets=(offsets, torch.int32, 1),
           tgt=(tgt, torch.float32, 3))
    if tuple(tgt.shape) != (3, Hp, Wp):
        raise ValueError(f"target must be [3, {Hp}, {Wp}], got {tuple(tgt.shape)}")
    if sph.device.type == "cpu":
        return soft_mse_plain(sph, pl, cam, lists, offsets, tgt, spec=spec)
    pvals, ppl, ptf = _partials(spec, sph, pl, lists, pvals)
    prm = _params(spec, sph, pl, lists)
    prm.cull = int(spec.cull)
    _launch("rtwc_soft_mse", "soft_mse",
            (cam, sph, pl, lists, offsets, tgt, pvals, ppl, ptf), prm, sph)
    return pvals, ppl, ptf


def soft_grad_reduce(pvals, pidx, ppl, ptf, ns: int, psh=None, pshidx=None, counts=None):
    """Sum the partials in a fixed order: (dsph [8, NS], dpl [12, NP],
    two-float pairs [13, 2]). psh [E_sh, 4] and pshidx [E_sh] are the
    shadowed kernels' occluder partials (K5, K6), keyed by shadow-list slot.
    counts [2] i32 on the tables' device: how many of pidx's and pshidx's
    entries are real (entry_tables' counts; the kernels read them there, so
    the host never waits); None: all of them."""
    dev = pvals.device
    named = [("pvals", pvals, torch.float32, 2), ("pidx", pidx, torch.int32, 1),
             ("ppl", ppl, torch.float32, 3), ("ptf", ptf, torch.float32, 3)]
    if (psh is None) != (pshidx is None):
        raise ValueError("psh and pshidx go together")
    if psh is not None:
        named += [("psh", psh, torch.float32, 2), ("pshidx", pshidx, torch.int32, 1)]
        if psh.shape[0] < pshidx.shape[0] or psh.shape[1] != 4:
            raise ValueError("psh must be [E_sh, 4] with E_sh >= len(pshidx)")
    for name, t, dtype, ndim in named:
        if t.device != dev or t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} tensor on {dev}")
    if pvals.shape[0] < pidx.shape[0] or pvals.shape[1] != 8 or ppl.shape[2] != P.PL_ROWS \
            or ptf.shape[2] != 2 or ppl.shape[0] != ptf.shape[0]:
        raise ValueError("partials do not fit together")
    n = pidx.shape[0]
    n_sh = 0 if pshidx is None else pshidx.shape[0]
    if counts is not None and (counts.device != dev or counts.dtype != torch.int32
                               or tuple(counts.shape) != (2,)):
        raise ValueError(f"counts must be i32 [2] on {dev}")
    if dev.type == "cpu":
        return soft_grad_reduce_plain(pvals[:n], pidx, ppl, ptf, ns,
                                      None if psh is None else psh[:n_sh], pshidx, counts)
    if dev.type != "cuda":
        raise ValueError(f"soft_grad_reduce runs on cuda or cpu, not {dev}")
    if counts is None:  # every entry is real: two fills, no copy from the host
        counts = torch.empty(2, dtype=torch.int32, device=dev)
        counts[0] = n
        counts[1] = n_sh
    for name, t in (("pvals", pvals), ("psh", psh), ("ptf", ptf)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (vector loads)")
    npl = ppl.shape[1]
    dsph = torch.empty((P.SPH_ROWS, ns), dtype=torch.float32, device=dev)
    dpl = torch.empty((P.PL_ROWS, npl), dtype=torch.float32, device=dev)
    dtf = torch.empty((ptf.shape[1], 2), dtype=torch.float32, device=dev)
    prm, n_int, n_float = C.reduce_params(ns, npl, n, n_sh, ppl.shape[0], ptf.shape[1],
                                          _device_index(pvals))
    iws = torch.empty(n_int, dtype=torch.int32, device=dev)
    fws = torch.empty(n_float, dtype=torch.float32, device=dev)
    _launch("rtwc_soft_grad_reduce", "soft_grad_reduce",
            (pvals, pidx, psh, pshidx, counts, ppl, ptf, dsph, dpl, dtf, iws, fws), prm, pvals)
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


def _lists(sph, pl, cam, spec: SoftSpec, cull: bool):
    """(view lists, shadow lists or None) for spec's config."""
    if spec.config.shadows:
        return SH.build_lists(sph, pl, cam, spec, cull)
    return build_lists(sph, cam, spec, cull), None


def _forward_planes(sph, pl, cam, spec: SoftSpec):
    """(planes, gates, view lists, shadow lists): K4 with shadows, else K1."""
    lists, shl = _lists(sph, pl, cam, spec, spec.cull)
    if shl is not None:
        return SH.soft_sh_fwd(sph, pl, cam, lists, shl, spec=spec) + (lists, shl)
    return soft_fwd(sph, pl, cam, lists, spec=spec) + (lists, shl)


def _entries(lists, shl):
    """(entry tables, (pvals, psh)): the partial tables of the gradient
    kernels, their rows below the counts zeroed by the entry-table launch
    (no fill of the [T NS] tables on the card)."""
    tables = partial_tables(lists, shl)
    return entry_tables(lists, shl, *tables), tables


def _reduce(sph, ent: Entries, parts):
    """soft_grad_reduce over K2 / K3 partials (no shadow entries), or K5 /
    K6 partials with their shadow-occluder table."""
    if ent.pshidx is None:
        pvals, ppl, ptf = parts
        return soft_grad_reduce(pvals, ent.pidx, ppl, ptf, sph.shape[1], counts=ent.counts)
    pvals, psh, ppl, ptf = parts
    return soft_grad_reduce(pvals, ent.pidx, ppl, ptf, sph.shape[1], psh=psh,
                            pshidx=ent.pshidx, counts=ent.counts)


class SoftRender(torch.autograd.Function):
    """planes = K1(sph, pl, cam) ([10, Hp, Wp]), or K4 with shadows
    ([14, Hp, Wp]); backward = K2 or K5, then the reduction (the counterpart
    of `soft_packed`, pallas_soft.py:2604-2622). Cotangents on the m / s
    (and vis / d(rgb)/d(vis)) planes are discarded: the closed-form softmax
    VJP already accounts for the normaliser, and K5 takes the value path
    through vis from the saved planes."""

    @staticmethod
    def forward(ctx, sph, pl, cam, spec: SoftSpec):
        out, gates, lists, shl = _forward_planes(sph, pl, cam, spec)
        ctx.spec = spec
        ctx.save_for_backward(sph, pl, cam, out, gates, lists, *(() if shl is None else (shl,)))
        return out

    @staticmethod
    def backward(ctx, g):
        sph, pl, cam, out, gates, lists, *shl = ctx.saved_tensors
        shl = shl[0] if shl else None
        spec = ctx.spec
        if spec.bwd_cull != spec.cull:
            lists, shl = _lists(sph, pl, cam, spec, spec.bwd_cull)
        ent, tables = _entries(lists, shl)
        g = g.contiguous()
        if shl is None:
            parts = soft_bwd(sph, pl, cam, lists, ent.offsets, gates, out, g, spec=spec,
                             pvals=tables[0])
        else:
            parts = SH.soft_sh_bwd(sph, pl, cam, lists, shl, ent.offsets, ent.sh_offsets, gates,
                                   out, g, spec=spec, pvals=tables[0], psh=tables[1])
        dsph, dpl, dtf = _reduce(sph, ent, parts)
        return dsph, dpl, _dcam(dtf), None


def _mse_via_forward(sph, pl, cam, tgt, spec: SoftSpec):
    """The un-differentiated loss: the forward kernel (K1, or K4 with
    shadows) and the mean in torch."""
    H, W = spec.rows, spec.config.width
    out = _forward_planes(sph, pl, cam, spec)[0]
    d = (out[SO_R:SO_B + 1, :H, :W] - tgt[:, :H, :W]) / torch.full(
        (), 255.0, dtype=torch.float32, device=out.device)
    return torch.mean(d * d)


class SoftMSE(torch.autograd.Function):
    """loss = mean(((rgb - tgt) / 255)^2) over the image (the counterpart of
    `soft_mse`, pallas_soft.py:2571-2601). Under autograd the forward runs
    K3 (K6 with shadows) at loss-cotangent 1 and keeps the tables, and the
    backward scales them by the incoming gradient; an un-differentiated
    call runs K1 (K4) and the loss in torch. The target's cotangent needs
    the rgb planes, which K3 / K6 never write: it recomputes them with K1
    (K4), only when asked."""

    @staticmethod
    def forward(ctx, sph, pl, cam, tgt, spec: SoftSpec):
        ctx.spec = spec
        if not any(ctx.needs_input_grad[:4]):
            return _mse_via_forward(sph, pl, cam, tgt, spec)
        H, W = spec.rows, spec.config.width
        inv_n = 1.0 / (3.0 * H * W)
        lists, shl = _lists(sph, pl, cam, spec, spec.cull)
        ent, tables = _entries(lists, shl)
        if shl is None:
            parts = soft_mse(sph, pl, cam, lists, ent.offsets, tgt, spec=spec, pvals=tables[0])
        else:
            parts = SH.soft_sh_mse(sph, pl, cam, lists, shl, ent.offsets, ent.sh_offsets, tgt,
                                   spec=spec, pvals=tables[0], psh=tables[1])
        dsph, dpl, dtf = _reduce(sph, ent, parts)
        loss = (dtf[SLOT_LOSS, 0] + dtf[SLOT_LOSS, 1]) * O.f32(1.0 / 255.0 ** 2) * inv_n
        ctx.save_for_backward(dsph, dpl, _dcam(dtf), sph, pl, cam, tgt)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        dsph, dpl, dcam, sph, pl, cam, tgt = ctx.saved_tensors
        spec = ctx.spec
        dtgt = None
        if ctx.needs_input_grad[3]:
            H, W = spec.rows, spec.config.width
            inv_n = 1.0 / (3.0 * H * W)
            sav = _forward_planes(sph, pl, cam, spec)[0]
            dtgt = torch.zeros_like(tgt)
            dtgt[:, :H, :W] = -gbar * 2.0 * inv_n / (255.0 * 255.0) * (
                sav[SO_R:SO_B + 1, :H, :W] - tgt[:, :H, :W])
        return gbar * dsph, gbar * dpl, gbar * dcam, dtgt, None


# -- entry points -------------------------------------------------------------------

def render_frame_soft_kernel(scene, camera, config: RenderConfig, tau: float | None = None,
                             bh: int = 16, bw: int = 16, cull: bool = True,
                             bwd_cull: bool = True) -> Framebuffer:
    """Differentiable frame render on K1 / K2, or K4 / K5 when
    config.shadows is on (pallas_soft.py:2764-2792): gradients reach scene
    geometry, colours and the camera pose through pack_scene / pack_camera,
    and with shadows reach occluders through their shadows alone. cull /
    bwd_cull switch off the two-level culling of the forward / backward
    kernel."""
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
    inside K3, or K6 when config.shadows is on (pallas_soft.py:2715-2737).
    K3 / K6 have one cull switch: both flags must be on for it to cull, as
    in JAX."""
    spec = _spec(config, tau, bh, bw, cull and bwd_cull, cull and bwd_cull,
                 "render_soft_mse_loss")
    return _mse_loss(*_packed(scene, camera), target, spec)


def _mse_loss(sph, pl, cam, target, spec: SoftSpec) -> torch.Tensor:
    """SoftMSE of the launch's rows against target [rows, W, 3], padded to
    the tiles; without autograd, K1 (K4) and the loss in torch."""
    Hp, Wp = spec.extent
    tgt = target.to(torch.float32).permute(2, 0, 1)
    tgt = torch.nn.functional.pad(tgt, (0, Wp - spec.config.width, 0, Hp - spec.rows))
    tgt = tgt.contiguous()
    if not torch.is_grad_enabled():  # SoftMSE would still see needs_input_grad
        return _mse_via_forward(sph, pl, cam, tgt, spec)
    return SoftMSE.apply(sph, pl, cam, tgt, spec)


def _at_row(cam: torch.Tensor, row0: int) -> torch.Tensor:
    """cam with the band's first image row in C_ROW0 (differentiable in the
    other slots)."""
    cam = cam.clone()
    cam[:, P.C_ROW0].fill_(float(row0))  # a fill kernel: no copy from the host
    return cam


def soft_band_packed(sph, pl, cam, row0: int, *, config: RenderConfig, tau: float,
                     band_h: int, bh: int = 16, bw: int = 16) -> torch.Tensor:
    """Render `band_h` image rows starting at image row `row0` from packed
    tables (cam carries the live counts in C_NSPH / C_NPL) on K1 / K2, or
    K4 / K5 with config.shadows: the [10, band_h, W] plane stack (SO_*; 14
    planes with shadows, as in JAX), differentiable in sph, pl and cam
    (pallas_soft.py:2661-2674). The band's padded rows take no cotangent.
    Used by the tile-sharded train step (dist/mesh.py)."""
    spec = _spec(config, tau, bh, bw, True, True, "soft_band_packed", band_h=band_h)
    return SoftRender.apply(sph, pl, _at_row(cam, row0), spec)[:, :band_h, :config.width]


def soft_band_mse_loss(sph, pl, cam, row0: int, tgt_band, *, config: RenderConfig,
                       tau: float, band_h: int, bh: int = 16, bw: int = 16) -> torch.Tensor:
    """mean(((rgb - tgt_band) / 255)^2) over a band of `band_h` image rows
    starting at image row `row0`, from packed tables (soft_band_packed's
    contract), with the cotangents derived inside K3, or K6 with
    config.shadows (pallas_soft.py:2677-2695). tgt_band is [band_h, W, 3].
    The per-band means of equal bands average to the image's mean."""
    spec = _spec(config, tau, bh, bw, True, True, "soft_band_mse_loss", band_h=band_h)
    return _mse_loss(sph, pl, _at_row(cam, row0), tgt_band, spec)
