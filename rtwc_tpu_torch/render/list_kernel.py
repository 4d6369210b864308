"""The broad phase on the card: wrappers of csrc/broad_phase.cu.

Counterpart: rtwc_tpu/render/pallas_soft.py:619-982 (`_build_tile_lists`
at :968), which JAX compiles with the train step into one device program.
The plain version is render/broad_phase.py (torch ops); on the card the
kernel's tables are `torch.equal` to it in what any consumer reads: slot 0
(the count), the listed prefix, and the aux planes. The kernel writes no
slot past a row's count (the plain versions' excluded tail): the CUDA
consumers read a row up to its count, and the plain kernels mask those
slots (they gather sphere 0 there).

- `sphere_tile_lists` / `build_tile_lists` (broad_phase.py's names) build
  the view lists (and their aux planes) and, with shadows, the
  shadow-occluder lists in one launch of `tile_lists_kernel`: warps that
  walk tiles over spheres staged once a block; `tile_lists_with_aux`
  returns all three, to compare them.
- `entry_tables` turns the lists into the compact entry tables of the soft
  kernels' partials in one launch of `entry_tables_kernel`, which scans
  the counts itself: each tile's offset, the sphere of every entry in a
  [T NS] table (the exact worst case: no entry is ever dropped, and the
  partial tables sized from it need no count from the device), and the
  totals [2] (main, shadow) in device memory. Given the partial tables
  (`partial_tables`: [T NS, 8] and [T NS, 4], uninitialised on the card),
  the same launch zeroes their rows below the totals, the rows the
  gradient kernels and the reduction use. On the card nothing past the
  totals is written: the reduction reads the entries below the counts
  only. The plain version (`entry_tables_plain`, which the CPU runs) puts
  -1 in every slot past the total. Nothing reads the host, so a step that
  uses them runs under `torch.cuda.set_sync_debug_mode("error")` and
  inside a CUDA graph; the launch's scratch (per-block totals, made once
  a device, outside any capture) needs no reset between launches.

Each wrapper runs the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises, and counts the launch in `LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from rtwc_tpu_torch.camera import projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import _cuda
from rtwc_tpu_torch.render import broad_phase as BP
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render.reference import _FLT_EPSILON
from rtwc_tpu_torch.render.soft_core import capacity

LAUNCHES = {"tile_lists": 0, "entry_tables": 0}
LIST_WARPS = 8       # csrc/broad_phase.cu: warps a tile_lists block
SPHERE_BYTES = 52    # csrc/broad_phase.cu: shared memory a staged sphere takes
QUEUE = 64           # csrc/broad_phase.cu: a warp's queue for the exact occluder test
# Spheres a tile_lists block stages (csrc/broad_phase.cu list_smem within 227 KB):
# the engine grows a scene to EngineConfig.max_grow_spheres = 4096 slots
MAX_SPHERES = 4096
ENTRY_THREADS = 256  # csrc/broad_phase.cu: tiles (threads) an entry_tables block
ENTRY_MAX_BLOCKS = 1024  # csrc/broad_phase.cu: a list's entry_tables blocks at most
NB = BP._NB          # balls of the truncated view cone (csrc/broad_phase.cu NB)


class ListParams(ctypes.Structure):
    """Mirror of `struct ListParams` in csrc/broad_phase.cu."""

    _fields_ = [
        ("ns", ctypes.c_int), ("np", ctypes.c_int), ("ti", ctypes.c_int), ("tj", ctypes.c_int),
        ("bh", ctypes.c_int), ("bw", ctypes.c_int), ("width", ctypes.c_int),
        ("height", ctypes.c_int), ("disable", ctypes.c_int), ("device", ctypes.c_int),
        ("e1", ctypes.c_float), ("e2", ctypes.c_float),
        ("inv_w", ctypes.c_float), ("inv_h", ctypes.c_float),
        ("r_scale", ctypes.c_float), ("reach", ctypes.c_float),
        ("r_scale40", ctypes.c_float), ("reach40", ctypes.c_float),
        ("far", ctypes.c_float), ("light", ctypes.c_float * 3),
        ("sub", ctypes.c_float), ("sky_m", ctypes.c_float),
        ("neg_k", ctypes.c_float), ("inv_k", ctypes.c_float),
        ("mp", ctypes.c_float), ("flt_eps", ctypes.c_float),
        ("cover_lim", ctypes.c_float), ("keep_s", ctypes.c_float), ("keep_c", ctypes.c_float),
    ]


class EntryParams(ctypes.Structure):
    """Mirror of `struct EntryParams` in csrc/broad_phase.cu."""

    _fields_ = [("n_tiles", ctypes.c_int), ("ns", ctypes.c_int), ("n_lists", ctypes.c_int),
                ("device", ctypes.c_int)]


class Entries(NamedTuple):
    """The soft kernels' entry tables: offsets [T] i32 (where each tile's
    slots start), pidx [T NS] i32 (the sphere of each entry in tile then
    slot order; past the total -1 in the plain version, unwritten on the
    card), the same two for the shadow lists (None without them), and
    counts [2] i32 (the main and shadow totals; shadow 0 without shadow
    lists)."""

    offsets: torch.Tensor
    pidx: torch.Tensor
    sh_offsets: torch.Tensor | None
    pshidx: torch.Tensor | None
    counts: torch.Tensor


def _f32_sqrt(x: float) -> float:
    """sqrt of x rounded to f32, in f32 (broad_phase._f32_sqrt's value)."""
    return float(np.sqrt(np.float32(x)))


def _f32_inv(x: float) -> float:
    """1 / x in f32, as torch's CUDA division by a Python scalar computes
    the reciprocal it multiplies by."""
    return float(np.float32(1.0) / np.float32(x))


def list_params(config: RenderConfig, tau: float, bh: int, bw: int, grid, ns: int, npl: int,
                hard: bool, disable: bool, device: int) -> ListParams:
    """The kernel's constants, each as broad_phase.py forms it in Python and
    torch rounds it to f32 on the card."""
    e1, e2 = projection_elements(config)
    far, mp = config.far, config.soft_miss_penalty
    sub = (far + 16.0 * tau) / mp
    sky_m = (far + 40.0 * tau) / mp
    ks = config.soft_shadow_k
    return ListParams(
        ns=ns, np=npl, ti=grid[0], tj=grid[1], bh=bh, bw=bw, width=config.width,
        height=config.height, disable=int(disable), device=device, e1=e1, e2=e2,
        inv_w=_f32_inv(config.width), inv_h=_f32_inv(config.height),
        r_scale=1.0 if hard else _f32_sqrt(1.0 + sub), reach=0.0 if hard else sub,
        r_scale40=_f32_sqrt(1.0 + sky_m), reach40=sky_m, far=far,
        light=(ctypes.c_float * 3)(*config.light_pos), sub=sub, sky_m=sky_m,
        neg_k=-config.soft_mask_k, inv_k=_f32_inv(config.soft_mask_k), mp=mp,
        flt_eps=_FLT_EPSILON, cover_lim=far - 16.0 * tau - 1.0,
        keep_s=_f32_sqrt(1.0 + 16.0 / ks), keep_c=16.0 / ks)


def _fn(name: str, argc: int, params):
    fn = getattr(_cuda.load("broad_phase"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * argc + [ctypes.POINTER(params), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _call(name: str, argc: int, params, tensors, dev: torch.device):
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _fn(name, argc, type(params))(*(None if t is None else t.data_ptr() for t in tensors),
                                        ctypes.byref(params), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _check(sph, pl, cam):
    dev = sph.device
    for name, t, rows in (("sph", sph, P.SPH_ROWS), ("pl", pl, P.PL_ROWS), ("cam", cam, 1)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} must be an f32 [{rows}, N] tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if cam.shape[1] != P.CAM_LEN:
        raise ValueError(f"cam must be [1, {P.CAM_LEN}], got {tuple(cam.shape)}")
    if sph.shape[1] > MAX_SPHERES:
        raise ValueError(f"the list kernel stages at most {MAX_SPHERES} spheres a block, "
                         f"got {sph.shape[1]}")
    if dev.type != "cuda":
        raise ValueError(f"the list kernel runs on cuda (plain version on cpu), not {dev}")


@torch.no_grad()
def _launch_lists(sph, pl, cam, config, tau, bh, bw, grid, shadows, hard, disable):
    if pl is None:  # the view lists alone never read the planes
        pl = torch.empty((P.PL_ROWS, 0), dtype=torch.float32, device=sph.device)
    sph, pl, cam = (t.detach().contiguous() for t in (sph, pl, cam))
    _check(sph, pl, cam)
    dev = sph.device
    Ti, Tj = grid
    ns = sph.shape[1]
    lists = torch.empty((Ti * Tj, 1, ns + 1), dtype=torch.int32, device=dev)
    shl = torch.empty_like(lists) if shadows else None
    aux = None if disable else (torch.empty((Ti, Tj), dtype=torch.float32, device=dev),
                                torch.empty((Ti, Tj), dtype=torch.bool, device=dev))
    prm = list_params(config, tau, bh, bw, grid, ns, pl.shape[1], hard, disable,
                      _device_index(sph))
    _call("rtwc_tile_lists", 7, prm,
          (cam, sph, pl, lists) + ((None, None) if aux is None else aux) + (shl,), dev)
    LAUNCHES["tile_lists"] += 1
    return lists, shl, aux


def sphere_tile_lists(sph, cam, config: RenderConfig, tau: float, bh: int, bw: int, grid,
                      hard: bool = False, disable: bool = False):
    """broad_phase.sphere_tile_lists: (table [T, 1, NS+1] i32, aux) with aux
    = (t_hi_sph [Ti, Tj] f32, sky_sph [Ti, Tj] bool), None with disable."""
    if sph.device.type == "cpu":
        return BP.sphere_tile_lists(sph, cam, config, tau, bh, bw, grid, hard=hard,
                                    disable=disable)
    lists, _, aux = _launch_lists(sph, None, cam, config, tau, bh, bw, grid, False, hard,
                                  disable)
    return lists, aux


def build_tile_lists(sph, pl, cam, config: RenderConfig, tau: float, bh: int, bw: int, grid,
                     shadows: bool, disable: bool = False):
    """broad_phase.build_tile_lists: (view table, shadow table or None)."""
    if sph.device.type == "cpu":
        return BP.build_tile_lists(sph, pl, cam, config, tau, bh, bw, grid, shadows,
                                   disable=disable)
    lists, shl, _ = _launch_lists(sph, pl, cam, config, tau, bh, bw, grid, shadows, False,
                                  disable)
    return lists, shl


@torch.no_grad()
def tile_lists_plain(sph, pl, cam, config: RenderConfig, tau: float, bh: int, bw: int, grid,
                     shadows: bool, hard: bool = False, disable: bool = False):
    """The plain version of tile_lists_kernel, on the tables' device: (view
    table, shadow table or None, aux or None) from broad_phase.py."""
    cones = None if disable else BP._tile_cones(cam.detach(), config, bh, bw, grid)
    lists, aux = BP.sphere_tile_lists(sph, cam, config, tau, bh, bw, grid, hard=hard,
                                      disable=disable, cones=cones)
    shl = (BP.shadow_tile_lists(sph, pl, cam, config, tau, bh, bw, grid, view_aux=aux,
                                disable=disable, cones=cones) if shadows else None)
    return lists, shl, aux


def tile_lists_with_aux(sph, pl, cam, config: RenderConfig, tau: float, bh: int, bw: int, grid,
                        shadows: bool, hard: bool = False, disable: bool = False):
    """(view table, shadow table or None, aux or None): the kernel's every
    output, or on the CPU the plain version's, for comparing the two."""
    if sph.device.type == "cpu":
        return tile_lists_plain(sph, pl, cam, config, tau, bh, bw, grid, shadows, hard, disable)
    return _launch_lists(sph, pl, cam, config, tau, bh, bw, grid, shadows, hard, disable)


# -- the entry tables -----------------------------------------------------------------

def partial_tables(lists: torch.Tensor, shl: torch.Tensor | None = None):
    """(pvals [T NS, 8], psh [T NS, 4] or None) f32: the partial tables the
    gradient kernels fill, for `entry_tables` to zero below the counts. On
    the card they are allocated and not filled (the entry-table launch
    zeroes the rows that are read); on the CPU they are zeros."""
    make = torch.empty if lists.device.type == "cuda" else torch.zeros
    pvals = make((capacity(lists), 8), dtype=torch.float32, device=lists.device)
    psh = None if shl is None else make((capacity(shl), 4), dtype=torch.float32,
                                        device=lists.device)
    return pvals, psh


def _entries_plain(lists: torch.Tensor):
    T, ns = lists.shape[0], lists.shape[2] - 1
    cnt = lists[:, 0, 0]
    end = torch.cumsum(cnt, 0, dtype=torch.int32)
    off = end - cnt
    slot = torch.arange(ns, device=lists.device, dtype=torch.int32)
    valid = slot[None, :] < cnt[:, None]
    dest = torch.where(valid, off[:, None] + slot[None, :], T * ns).reshape(-1).long()
    pidx = torch.full((T * ns + 1,), -1, dtype=torch.int32, device=lists.device)
    pidx.scatter_(0, dest, torch.where(valid, lists[:, 0, 1:], -1).reshape(-1))
    total = end[-1:] if T else torch.zeros(1, dtype=torch.int32, device=lists.device)
    return off.contiguous(), pidx[:T * ns].contiguous(), total


def _zero_below(rows: torch.Tensor | None, n: torch.Tensor) -> None:
    """Zero rows [0, n) of a partial table in place, n on the table's device."""
    if rows is not None:
        below = torch.arange(rows.shape[0], device=rows.device) < n
        rows.masked_fill_(below[:, None], 0.0)


def entry_tables_plain(lists: torch.Tensor, shl: torch.Tensor | None = None,
                       pvals: torch.Tensor | None = None,
                       psh: torch.Tensor | None = None) -> Entries:
    """The entry tables in torch ops, with no boolean mask: a scatter of
    every listed slot to its tile's offset plus its slot, the rest to a
    spare slot that is cut off (-1 past the total); pvals' and psh's rows
    below the main and shadow totals zeroed in place."""
    off, pidx, n = _entries_plain(lists)
    _zero_below(pvals, n)
    if shl is None:
        return Entries(off, pidx, None, None, torch.cat([n, torch.zeros_like(n)]))
    sh_off, pshidx, n_sh = _entries_plain(shl)
    _zero_below(psh, n_sh)
    return Entries(off, pidx, sh_off, pshidx, torch.cat([n, n_sh]))


_SCRATCH: dict = {}


def _scratch(lists: torch.Tensor) -> torch.Tensor:
    """The entry-table launch's scratch on the lists' card: each list's
    per-block totals (tagged with the launch) and the epoch and block
    counters, zeroed once, outside any CUDA graph capture (a step's eager
    warm-up makes it)."""
    key = _device_index(lists)
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("entry_tables: call it once outside the CUDA graph capture first "
                               "(it makes its scratch then)")
        buf = _SCRATCH[key] = torch.zeros(2 * ENTRY_MAX_BLOCKS + 1, dtype=torch.int64,
                                          device=lists.device)
    return buf


@torch.no_grad()
def entry_tables(lists: torch.Tensor, shl: torch.Tensor | None = None,
                 pvals: torch.Tensor | None = None, psh: torch.Tensor | None = None) -> Entries:
    """The soft kernels' entry tables of the view lists and, when given,
    the shadow lists (see `Entries`); pvals / psh (`partial_tables`), when
    given, get their rows below the main / shadow totals zeroed by the same
    launch."""
    if lists.dtype != torch.int32 or lists.dim() != 3 or lists.shape[1] != 1:
        raise ValueError(f"lists must be i32 [T, 1, NS+1], got {lists.dtype} "
                         f"{tuple(lists.shape)}")
    if shl is not None and (shl.shape != lists.shape or shl.dtype != lists.dtype
                            or shl.device != lists.device):
        raise ValueError("shadow lists must match the view lists")
    if psh is not None and shl is None:
        raise ValueError("psh goes with the shadow lists")
    for name, t, width, lst in (("pvals", pvals, 8, lists), ("psh", psh, 4, shl)):
        if t is not None and (t.device != lists.device or t.dtype != torch.float32
                              or tuple(t.shape) != (capacity(lst), width)
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 [{capacity(lst)}, {width}] "
                             f"tensor on {lists.device}")
    dev = lists.device
    if dev.type == "cpu":
        return entry_tables_plain(lists, shl, pvals, psh)
    if dev.type != "cuda":
        raise ValueError(f"entry_tables runs on cuda or cpu, not {dev}")
    ls = [lists.contiguous()] + ([] if shl is None else [shl.contiguous()])
    T, ns = lists.shape[0], lists.shape[2] - 1
    if T > ENTRY_THREADS * ENTRY_MAX_BLOCKS:
        raise ValueError(f"entry_tables takes at most {ENTRY_THREADS * ENTRY_MAX_BLOCKS} tiles, "
                         f"got {T}")
    offsets = torch.empty((len(ls), T), dtype=torch.int32, device=dev)
    pidx = torch.empty((len(ls), T * ns), dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    prm = EntryParams(n_tiles=T, ns=ns, n_lists=len(ls), device=_device_index(lists))
    if T:
        _call("rtwc_entry_tables", 8, prm,
              (ls[0], ls[-1], offsets, pidx, counts, pvals, psh, _scratch(lists)), dev)
        LAUNCHES["entry_tables"] += 1
    else:
        counts.zero_()
    sh = len(ls) == 2
    return Entries(offsets[0], pidx[0], offsets[1] if sh else None, pidx[1] if sh else None,
                   counts)
