"""Calibrated roofline of the port's soft kernels on one NVIDIA H100.

Port of rtwc_tpu/utils/roofline.py. The per-ray work of the soft kernels
(csrc/soft_common.cuh, csrc/soft_shadow.cu) is counted from their plain torch
twins in render/soft_objects.py, which run the kernels' op order, with the
hand-written adjoints in place of jax.vjp: `count_ops` runs a model function
on 0-d float32 tensors under a TorchDispatchMode and weights every aten op by
its MEASURED marginal cost on the card, in FMA slots.

Machine constants: measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power
limit (1980 MHz maximum SM clock), 2026-10-16, by `utils/calibrate.calibrate`
as `python3 chip_smoke.py` (phase 6b) runs it (csrc/calibrate.cu; NCHAIN = 4
chains a thread, 270336 threads, slopes between 2048 and 8192 iterations).
The card sustains 3.197e13 FMA element-ops/s, 96 % of 132 SMs x 128 lanes x
1.98 GHz. An op's weight is its marginal slowdown of an FMA chain, in FMA
slots. On this card the weights track the op's SASS instruction count (a
scheduler starts one warp instruction a clock, the FMA rate): add / mul /
max about 1, compare-select 1.5, abs and negation 0.02 (operand modifiers),
exp 8.4, IEEE sqrt 11.2, IEEE division 16.3, the correctly rounded
1 / sqrt 24.1, log 25.5, log1p 24.3, tanh 17.6. `culled_step_model` takes a
calibration of its own run in place of these (chip_smoke.py prices its
floors with the run's phase 6b).

The model excludes loop and gate bookkeeping, shared-memory object loads and
the per-object block sums of the backward kernels, and credits every shared
subexpression once (the CSE of `count_ops`): all in the direction of a floor.

Device memory: 2.955e12 B/s, read + write of a 256 MB device-to-device copy
(the data sheet's 3.35 TB/s is the peak).
"""
from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.broad_phase import round_up

# ---------------------------------------------------------------------------
# Machine constants (NVIDIA H100 80GB HBM3, 700.00 W, measured 2026-10-16 by
# chip_smoke.py phase 6b; see the module docstring).
FMA_PER_S = 3.197e13        # sustained FMA element-ops / s (1 slot = 1 FMA)
HBM_BYTES_PER_S = 2.955e12  # measured device-to-device copy, read + write

# Measured marginal cost of each calibration body, in FMA slots ("slots" of
# the calibration's JSON).
SLOTS = {
    "mul": 0.980, "add": 0.984, "max": 1.109, "abs": 0.022, "select": 1.472,
    "exp": 8.44, "log": 25.46, "log1p": 24.32, "rsqrt": 24.12, "sqrt": 11.24,
    "div": 16.26, "logistic": 24.17, "tanh": 17.59,
}
# The calibration body that prices each aten op. Any aten op this does not
# name is priced at the cheap-op class (one add). Shape, view and
# constant-creation ops are free.
_ATEN_BODY = {
    "mul": "mul", "add": "add", "sub": "add", "rsub": "add",
    "maximum": "max", "minimum": "max", "clamp_min": "max", "clamp_max": "max",
    "abs": "abs", "neg": "abs",
    "gt": "select", "ge": "select", "lt": "select", "le": "select", "eq": "select",
    "ne": "select", "where": "select", "bitwise_and": "select", "bitwise_or": "select",
    "bitwise_not": "select", "logical_and": "select", "logical_or": "select",
    "logical_not": "select",
    "exp": "exp", "log": "log", "log1p": "log1p", "sqrt": "sqrt", "rsqrt": "rsqrt",
    "div": "div", "reciprocal": "div", "sigmoid": "logistic", "tanh": "tanh",
}


def weights_from_slots(slots: dict) -> dict:
    """The aten-op weight table of a calibration's slot weights (SLOTS'
    keys, as `utils/calibrate.calibrate` returns them under "slots")."""
    return {aten: float(slots[body]) for aten, body in _ATEN_BODY.items()}


_WEIGHTS = weights_from_slots(SLOTS)
_CHEAP = _WEIGHTS["add"]
# Ops the kernels run as a sequence: softplus = logaddexp(z, 0) is
# max(z, 0) + log1p(exp(-|z|)) (soft_common.cuh `softplus`).
_COMPOSITE = {"logaddexp": ("maximum", "abs", "neg", "exp", "log1p", "add")}
# Output aliases its first tensor input.
_VIEW = {"alias", "view", "_unsafe_view", "expand", "reshape", "clone", "detach", "_to_copy",
         "contiguous", "lift_fresh", "lift_fresh_copy", "squeeze", "unsqueeze", "permute", "t",
         "transpose", "copy", "expand_as", "view_as", "to"}
# Constants: keyed by value.
_CREATE = {"zeros_like", "ones_like", "full_like", "empty_like", "scalar_tensor", "zeros", "ones",
           "full", "empty", "new_zeros", "new_ones", "new_full", "new_empty", "arange", "fill"}
_FREE = {"stack", "cat", "select", "slice", "index", "unbind", "split", "gather", "index_select",
         "_local_scalar_dense", "item", "split_with_sizes", "narrow", "diagonal", "flip"}
_REDUCE = {"sum", "amax", "amin", "max", "min", "mean", "prod", "any", "all", "argmax", "argmin",
           "logsumexp", "norm", "cumsum", "var", "std"}


class _OpCounter(TorchDispatchMode):
    """Weighted count of the aten ops run under it, with CSE: an op whose
    (overload, canonical inputs, arguments) repeats an earlier one is free,
    and its outputs stand for the earlier outputs; an op whose tensor inputs
    are all constants is folded, as nvcc folds it. `weights` is an aten-op
    table (weights_from_slots); None prices with the pinned one."""

    def __init__(self, leaves, weights=None):
        super().__init__()
        self.w = _WEIGHTS if weights is None else weights
        self.cheap = _CHEAP if weights is None else weights["add"]
        self.total = 0.0
        self._canon: dict = {}   # id(tensor) -> canonical key
        self._keep: list = []    # every tensor seen, so no id is reused
        self._seen: dict = {}    # CSE key -> canonical keys of its outputs
        self._made_by: dict = {}  # canonical key -> name of the op that made it
        self._n = 0
        for i, t in enumerate(leaves):
            self._set(t, ("in", i))

    def _set(self, t, key):
        self._canon[id(t)] = key
        self._keep.append(t)

    def _fresh(self):
        self._n += 1
        return ("v", self._n)

    @staticmethod
    def _const(t: torch.Tensor):
        if t.numel() <= 16:
            return ("const", str(t.dtype), tuple(t.shape), tuple(t.reshape(-1).tolist()))
        return ("const", id(t))

    def _key(self, a):
        if isinstance(a, torch.Tensor):
            k = self._canon.get(id(a))
            if k is None:  # made outside the counted function: a constant
                k = self._const(a)
                self._set(a, k)
            return k
        if isinstance(a, (list, tuple)):
            return tuple(self._key(x) for x in a)
        if isinstance(a, (bool, int, float)):
            return ("lit", type(a).__name__, a)
        return ("lit", repr(a))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        flat = [a for a in args if isinstance(a, torch.Tensor)]
        flat += [t for a in args if isinstance(a, (list, tuple)) for t in a
                 if isinstance(t, torch.Tensor)]
        in_keys = (self._key(list(args)),
                   tuple((k, self._key(v)) for k, v in sorted(kwargs.items())))
        if name in _VIEW and flat:
            for o in outs:
                self._set(o, self._key(flat[0]))
            return out
        if name in _CREATE or (flat and all(self._key(t)[0] == "const" for t in flat)
                               and name not in _FREE):
            for o in outs:
                self._set(o, self._const(o))
            return out
        if name in _FREE:
            for o in outs:
                self._set(o, self._fresh())
            return out
        key = (str(func), in_keys)
        if key in self._seen:
            for o, k in zip(outs, self._seen[key]):
                self._set(o, k)
            return out
        keys = [self._fresh() for _ in outs]
        self._seen[key] = keys
        for o, k in zip(outs, keys):
            self._set(o, k)
            self._made_by[k] = name
        if name == "reciprocal" and self._made_by.get(self._key(flat[0])) == "sqrt":
            # 1 / sqrtf is one measured body (the kernels' rsqrt_), not sqrt + div
            self.total += (self.w["rsqrt"] - self.w["sqrt"]) * outs[0].numel()
        else:
            self.total += self._price(func, name, args, kwargs, flat, outs)
        return out

    def _weight(self, name: str) -> float:
        if name in _COMPOSITE:
            return sum(self.w.get(part, self.cheap) for part in _COMPOSITE[name])
        return self.w.get(name, self.cheap)

    def _price(self, func, name, args, kwargs, flat, outs) -> float:
        if name == "mul" and any(isinstance(a, float) and a == 1.0 for a in args[1:]):
            return 0.0  # x * 1.0: torch's 1.0 / x is reciprocal(x) * 1.0, one division
        if name in _REDUCE and not (name in ("max", "min") and func._overloadname == "other"):
            return self.cheap * max((t.numel() for t in flat), default=1)
        if name in ("max", "min"):
            w = self.w["maximum"]
        elif name == "clamp":
            bounds = list(args[1:3]) + [kwargs.get("min"), kwargs.get("max")]
            w = self.w["maximum"] * max(1, sum(b is not None for b in bounds))
        else:
            w = self._weight(name)
        return w * max((o.numel() for o in outs), default=1)


def count_ops(fn: Callable, *args, weights: dict | None = None) -> float:
    """Weighted FMA-slot count of one call fn(*args); args are the inputs
    (tensors made inside fn are constants). Each op is charged its weight
    times its output's element count, a reduction its input's. `weights` is
    an aten-op table (weights_from_slots); None uses the pinned one."""
    counter = _OpCounter(args, weights)
    with torch.no_grad(), counter:
        fn(*args)
    return counter.total


# ---------------------------------------------------------------------------
# Per-ray models of the soft kernels (csrc/soft_render.cu K1-K3,
# csrc/soft_shadow.cu K4-K6). Every value a kernel reads or computes is an
# input of the counted function, so nothing folds that the kernel computes.

def _s(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _scalar_inputs(n_sph: int, n_pl: int):
    """JAX's model inputs (roofline.py:177-185) as 0-d float32 tensors."""
    sph = [tuple(_s(v) for v in (0.1 * k, 1.0, 5.0 + k, 1.0, 200.0, 90.0, 30.0))
           for k in range(n_sph)]
    pl_ = [tuple(_s(v) for v in (0.0, -2.0, 5.0 + k, 0.0, 1.0, 0.0, 10.0, 10.0, 120.0, 120.0, 120.0))
           for k in range(n_pl)]
    d = tuple(_s(v) for v in (0.1, -0.2, 0.97))
    o = tuple(_s(v) for v in (0.0, 0.5, -3.0))
    return sph, pl_, d, o


def _flat(*groups):
    out = []
    for g in groups:
        if isinstance(g, torch.Tensor):
            out.append(g)
        else:
            out.extend(_flat(*g))
    return out


def _count(fn: Callable, *inputs, weights: dict | None = None) -> float:
    """count_ops of the closure fn() with every tensor of `inputs` an input."""
    return count_ops(lambda *_: fn(), *_flat(*inputs), weights=weights)


def _accumulate(c: O.SoftConsts, state, t_eff, values):
    """The kernels' online-softmin step (soft_core._accumulate without the
    per-pixel select: the kernels branch on the block-uniform gate)."""
    m, s, acc = state
    logit = -t_eff * c.inv_tau
    m_new = torch.maximum(m, logit)
    e = torch.exp(-(logit - m).abs())
    up = logit > m
    alpha = torch.where(up, e, 1.0)
    p = torch.where(up, 1.0, e)
    return m_new, s * alpha + p, tuple(a * alpha + p * v for a, v in zip(acc, values))


def _ray_inputs():
    rowf, colf = _s(3.0), _s(5.0)
    cam9 = tuple(_s(v) for v in (1, 0, 0, 0, 1, 0, 0.1, 0.0, 1.0))
    return rowf, colf, cam9


def _raygen_ops(c: O.SoftConsts, weights: dict | None = None) -> float:
    rowf, colf, cam9 = _ray_inputs()
    return _count(lambda: O.raygen(c, rowf, colf, cam9), rowf, colf, cam9, weights=weights)


def _raygen_vjp_ops(c: O.SoftConsts, weights: dict | None = None) -> float:
    rowf, colf, cam9 = _ray_inputs()
    g = tuple(_s(1.0) for _ in range(3))

    def f():
        dx, dy, dz, vx, vy, inv = O.raygen(c, rowf, colf, cam9)
        return O.raygen_vjp(*g, dx, dy, dz, vx, vy, inv)

    return _count(f, rowf, colf, cam9, g, weights=weights)


def _cotangents(c, vals, gv, S, m, inv_s):
    """The backward sweep's closed-form softmax cotangents
    (soft_core._backward_sweep `cotangents`)."""
    w = torch.exp(-vals[0] * c.inv_tau - m) * inv_s
    gdotv = gv[0] * vals[1]
    for i in range(1, 7):
        gdotv = gdotv + gv[i] * vals[1 + i]
    dlogit = w * (gdotv - S)
    return (-dlogit * c.inv_tau,) + tuple(w * g for g in gv)


def fwd_ops_per_ray(config, tau: float, n_sph: int, n_pl: int) -> float:
    """K1 (unshadowed) / K4 (shadowed) per ray, every object taken:
    weighted FMA slots, uncull-effective."""
    c = O.SoftConsts.make(config, tau)
    sph, pl_, d, o = _scalar_inputs(n_sph, n_pl)
    # the running softmin state: registers of the kernel, inputs here
    m0, s0 = _s(c.bg_logit), _s(1.0)
    acc0 = tuple(_s(c.far if i == 3 else 0.0) for i in range(7))
    acc0_sh = tuple(_s(c.far if i == 0 else 0.0) for i in range(10))

    if not config.shadows:
        def f():
            state = (m0, s0, acc0)
            for a in sph:
                vals = O.sphere_f(c, *a, *d, *o)
                state = _accumulate(c, state, vals[0], vals[1:])
            for a in pl_:
                vals = O.plane_f(c, *a, *d, *o)
                state = _accumulate(c, state, vals[0], vals[1:])
            m, s, acc = state
            inv_s = 1.0 / s
            alpha = 1.0 - torch.exp(c.bg_logit - m) * inv_s
            return tuple(a * inv_s for a in acc) + (alpha, m, s)

        return _raygen_ops(c) + _count(f, sph, pl_, d, o, m0, s0, acc0)

    def f():
        # sweep 1: geometry softmin and the colour parts (depth, normal, A, B)
        state = (m0, s0, acc0_sh)
        cache = []
        for a in sph + pl_:
            if len(a) == 7:
                geo = O.sphere_geo(c, *a[:4], *d, *o)
                sn = geo[2:5]
            else:
                geo = O.plane_geo(c, *a[:8], *d, *o)
                sn = O.plane_unit_n(*a[3:6])
            t_eff, t_clip, nx, ny, nz, px, py, pz = geo
            dterm, sterm = O.shade_terms(c, px, py, pz, *sn, *d)
            (ar, br), (ag, bg), (ab, bb) = O.parts_from_terms(c, dterm, sterm, *a[-3:])
            state = _accumulate(c, state, t_eff, (t_clip, nx, ny, nz, ar, ag, ab, br, bg, bb))
            cache.append((t_eff, dterm, sterm, a[-3:]))
        m, s, acc = state
        inv_s = 1.0 / s
        depth = acc[0] * inv_s
        # the shadow sweep at the blended hit point
        lr = O.light_ray(c, o[0] + d[0] * depth, o[1] + d[1] * depth, o[2] + d[2] * depth)
        vis = _s(1.0)
        for a in pl_:
            vis = vis * O.shadow_transmittance(c, O.shadow_plane_pre(c, *a[:8], lr)[1])
        for a in sph:
            vis = vis * O.shadow_transmittance(c, O.shadow_sphere_pre(c, *a[:4], lr)[1])
        # the clamp correction over the object cache
        corr = [_s(0.0)] * 6
        for t_eff, dterm, sterm, col in cache:
            parts = O.parts_from_terms(c, dterm, sterm, *col)
            w = torch.exp(-t_eff * c.inv_tau - m) * inv_s
            for ch in range(3):
                a_c, b_c = parts[ch]
                val = a_c + vis * b_c
                over = val >= 255.0
                corr[ch] = corr[ch] + w * torch.where(over, val - 255.0, 0.0)
                corr[3 + ch] = corr[3 + ch] + w * torch.where(over, b_c, 0.0)
        rgb = [acc[4 + ch] * inv_s + vis * (acc[7 + ch] * inv_s) - corr[ch] for ch in range(3)]
        dv = [acc[7 + ch] * inv_s - corr[3 + ch] for ch in range(3)]
        alpha = 1.0 - torch.exp(c.bg_logit - m) * inv_s
        return rgb, dv, depth, vis, alpha, [acc[1 + ch] * inv_s for ch in range(3)]

    return _raygen_ops(c) + _count(f, sph, pl_, d, o, m0, s0, acc0_sh)


def bwd_ops_per_ray(config, tau: float, n_sph: int, n_pl: int) -> float:
    """K2 (unshadowed) / K5 (shadowed) per ray, every object taken: the
    hand-written adjoints replayed against the saved statistics."""
    c = O.SoftConsts.make(config, tau)
    sph, pl_, d, o = _scalar_inputs(n_sph, n_pl)
    g = tuple(_s(0.1) for _ in range(8))   # cotangents of rgb, depth, normal, alpha
    sav = tuple(_s(v) for v in (100, 90, 80, 5, 0, 1, 0))
    m, s = _s(-10.0), _s(2.0)
    vis, g_vis = _s(0.7), _s(0.05)

    def sweep(gv, S, inv_s, vis_=None):
        gd = [_s(0.0)] * 3
        go = [_s(0.0)] * 3
        for a in sph:
            vals = O.sphere_f(c, *a, *d, *o, vis=vis_)
            gr = O.sphere_f_vjp(c, *a, *d, *o, _cotangents(c, vals, gv, S, m, inv_s), vis=vis_)
            gd = [x + y for x, y in zip(gd, gr[7:10])]
            go = [x + y for x, y in zip(go, gr[10:13])]
        for a in pl_:
            vals = O.plane_f(c, *a, *d, *o, vis=vis_)
            gr = O.plane_f_vjp(c, *a, *d, *o, _cotangents(c, vals, gv, S, m, inv_s), vis=vis_)
            gd = [x + y for x, y in zip(gd, gr[11:14])]
            go = [x + y for x, y in zip(go, gr[14:17])]
        return gd, go

    def S_of(g_depth):
        inv_s = 1.0 / s
        w_bg = torch.exp(c.bg_logit - m) * inv_s
        S = g[0] * sav[0] + g[1] * sav[1] + g[2] * sav[2] + g_depth * sav[3]
        for i in range(3):
            S = S + g[4 + i] * sav[4 + i]
        return S - g[7] * w_bg, inv_s

    if not config.shadows:
        def f():
            S, inv_s = S_of(g[3])
            return sweep(g[:3] + (g[3],) + g[4:7], S, inv_s)

        return _raygen_vjp_ops(c) + _count(f, sph, pl_, d, o, g, sav, m, s)

    def f():
        depth = sav[3]
        pb = (o[0] + d[0] * depth, o[1] + d[1] * depth, o[2] + d[2] * depth)
        ct_vis = g_vis * vis
        ctp = [_s(0.0)] * 3
        for a in sph:
            fj = O.shadow_sphere_f(c, *a[:4], *pb)
            gr = O.shadow_sphere_f_vjp(c, *a[:4], *pb, ct_vis / fj)
            ctp = [x + y for x, y in zip(ctp, gr[4:7])]
        for a in pl_:
            fj = O.shadow_plane_f(c, *a[:8], *pb)
            gr = O.shadow_plane_f_vjp(c, *a[:8], *pb, ct_vis / fj)
            ctp = [x + y for x, y in zip(ctp, gr[8:11])]
        g_depth = g[3] + (ctp[0] * d[0] + ctp[1] * d[1] + ctp[2] * d[2])
        S, inv_s = S_of(g_depth)
        gd, go = sweep(g[:3] + (g_depth,) + g[4:7], S, inv_s, vis)
        return [x + y * depth for x, y in zip(gd, ctp)], [x + y for x, y in zip(go, ctp)]

    return _raygen_vjp_ops(c) + _count(f, sph, pl_, d, o, g, sav, m, s, vis, g_vis)


@functools.lru_cache(maxsize=16)
def soft_step_model(config, tau: float, n_sph: int, n_pl: int, fused: bool = False) -> dict:
    """Roofline of one forward + backward step of the soft kernels on 16x16
    tiles: per-frame weighted FMA slots, device-memory bytes, and the
    compute- and memory-bound times at the measured rates. fused=True models
    K3 / K6, whose only frame-sized traffic is the target read."""
    fwd = fwd_ops_per_ray(config, tau, n_sph, n_pl)
    bwd = bwd_ops_per_ray(config, tau, n_sph, n_pl)
    Hp, Wp = round_up(config.height, 16), round_up(config.width, 16)
    rays = Hp * Wp  # the kernels run every pixel of the padded tiles
    n_out = 14 if config.shadows else 10
    # fused: the padded target is read once; generic: the forward writes the
    # plane stack and the backward reads it (saved planes) and the cotangents
    hbm_bytes = 4 * Hp * Wp * 3 if fused else 3 * 4 * Hp * Wp * n_out
    ops = rays * (fwd + bwd)
    return {
        "fwd_ops_per_ray": fwd,
        "bwd_ops_per_ray": bwd,
        "ops_per_frame": ops,
        "fwd_ops_per_frame": rays * fwd,
        "hbm_bytes_per_frame": hbm_bytes,
        "t_compute_bound_s": ops / FMA_PER_S,
        "t_fwd_compute_bound_s": rays * fwd / FMA_PER_S,
        "t_bwd_compute_bound_s": rays * bwd / FMA_PER_S,
        "t_hbm_bound_s": hbm_bytes / HBM_BYTES_PER_S,
    }


def utilization(model: dict, measured_s: float) -> dict:
    """Achieved fraction of the FMA-slot speed of light, and of the memory
    side, to show which wall the kernel sits against."""
    return {
        "vpu_util": model["t_compute_bound_s"] / measured_s,
        "hbm_util": model["t_hbm_bound_s"] / measured_s,
        "bound": "compute" if model["t_compute_bound_s"] > model["t_hbm_bound_s"] else "hbm",
    }


@functools.lru_cache(maxsize=8)
def culled_component_costs(config, tau: float, slots: tuple | None = None) -> dict:
    """FMA-slot cost of one loop iteration, per ray, of each per-object piece
    of the shadowed kernels, for the list-aware floor (culled_step_model):
    the culling bounds (lb_*), K4's heavy branch and clamp-cache slot, the
    light ray, the occluder gate stages and transmittance, and the backward's
    two adjoint replays. `slots` is a calibration's slot weights as sorted
    (body, weight) pairs; None prices with the pinned SLOTS."""
    weights = None if slots is None else weights_from_slots(dict(slots))
    c = O.SoftConsts.make(config, tau)
    sph, pl_, d, o = _scalar_inputs(1, 1)
    a_s, a_p = sph[0], pl_[0]
    m0, s0, inv_s0 = _s(-10.0), _s(2.0), _s(0.5)
    t2c, dssc, vis0 = _s(5.0), _s(1.0), _s(0.7)
    g8 = tuple(_s(0.1) for _ in range(8))
    lrc = tuple(_s(v) for v in (0.1, 0.9, 0.2, 30.0, 1.0, 2.0, 3.0))
    pre = (_s(1.0), _s(0.5), _s(-2.0), _s(30.0))
    targs = tuple(_s(0.5) for _ in range(4))
    terms, col = (_s(0.5), _s(0.2)), a_s[4:]
    t5, g_sh = _s(5.0), _s(0.05)
    acc10 = tuple(_s(0.0) for _ in range(10))
    inputs = (a_s, a_p, d, o, m0, s0, inv_s0, t2c, dssc, vis0, g8, lrc, pre, targs, terms, t5, g_sh,
              acc10)

    def lb_s():
        lb, t2, dss = O.sphere_lb_ex(c, *a_s[:4], *d, *o)
        return (-lb * c.inv_tau - m0) > -16.0, t2, dss

    def lb_p():
        lb, t, den, px, pz = O.plane_lb_ex(c, *a_p[:8], *d, *o)
        return (-lb * c.inv_tau - m0) > -16.0

    def heavy_s():
        t_eff, t_clip, nx, ny, nz, px, py, pz = O.sphere_geo_post(c, *a_s[:3], t2c, dssc, *d, *o)
        dt, st = O.shade_terms(c, px, py, pz, nx, ny, nz, *d)
        (ar, br), (ag, bg), (ab, bb) = O.parts_from_terms(c, dt, st, *col)
        state = (m0, s0, acc10)
        return _accumulate(c, state, t_eff, (t_clip, nx, ny, nz, ar, ag, ab, br, bg, bb))

    def lightray():
        return O.light_ray(c, o[0] + d[0] * t5, o[1] + d[1] * t5, o[2] + d[2] * t5)

    def sh_pre_s():
        min_arg, args = O.shadow_sphere_pre(c, *a_s[:4], lrc)
        return min_arg > c.sh_floor, args

    def sh_preA_s():
        disc, dss, b, dist = O.shadow_sphere_preA(c, *a_s[:4], lrc)
        return dss > c.sh_floor, disc, b, dist

    def sh_preB_s():
        return O.shadow_sphere_preB(*pre)

    def sh_trans():
        v = vis0 * O.shadow_transmittance(c, targs)
        return v, v <= O.f32(1e-7)  # + the all-dark test

    def corr_slot():
        parts = O.parts_from_terms(c, *terms, *col)
        w = torch.exp(-t2c * c.inv_tau - m0) * inv_s0
        out = []
        for a_c, b_c in parts:
            val = a_c + vis0 * b_c
            over = val >= 255.0
            out.append(w * torch.where(over, val - 255.0, 0.0))
            out.append(w * torch.where(over, b_c, 0.0))
        return out

    def sh_args_s():
        return O.shadow_sphere_pre(c, *a_s[:4], O.light_ray(c, *o))[0] > c.sh_floor

    def vjp_sh_s():
        fj = O.shadow_sphere_f(c, *a_s[:4], *o)
        return O.shadow_sphere_f_vjp(c, *a_s[:4], *o, g_sh * vis0 / fj)

    def vjp_main_s(vis=vis0):
        S = g8[7]
        vals = O.sphere_f(c, *a_s, *d, *o, vis=vis)
        gv = g8[:4] + (_s(0.0),) * 3
        return O.sphere_f_vjp(c, *a_s, *d, *o, _cotangents(c, vals, gv, S, m0, inv_s0), vis=vis)

    def heavy_u():
        # K1 / K3: the shaded object and the 7-plane accumulate, no shadows
        geo = O.sphere_geo_post(c, *a_s[:3], t2c, dssc, *d, *o)
        rgb = O.shade(c, *col, *geo[5:8], *geo[2:5], *d)
        state = (m0, s0, acc10[:7])
        return _accumulate(c, state, geo[0], rgb + geo[1:5])

    parts = dict(lb_s=lb_s, lb_p=lb_p, heavy_s=heavy_s, lightray=lightray, sh_pre_s=sh_pre_s,
                 sh_preA_s=sh_preA_s, sh_preB_s=sh_preB_s, sh_trans=sh_trans, corr_slot=corr_slot,
                 sh_args_s=sh_args_s, vjp_sh_s=vjp_sh_s, vjp_main_s=vjp_main_s,
                 heavy_u=heavy_u, vjp_main_u=lambda: vjp_main_s(None))
    out = {k: _count(fn, *inputs, weights=weights) for k, fn in parts.items()}
    out["raygen"] = _raygen_ops(c, weights)
    out["raygen_vjp"] = _raygen_vjp_ops(c, weights)
    return out


def culled_step_model(config, tau: float, diag: dict, fused: bool = True,
                      calibration: dict | None = None) -> dict:
    """LIST-AWARE floor of the culled shadowed step on this scene: the
    per-tile work profile of render/shadow_kernel.soft_tile_diagnostics
    (list lengths = how many culling bounds run; applied counts = how many
    heavy bodies and adjoint replays run), priced with culled_component_costs
    at the measured FMA rate (rtwc_tpu/utils/roofline.py:567-630). Planes are
    priced at sphere component costs; the occluder gate's stage-B survivors
    at the applied count (a lower bound on them); the backward pays no gate
    of its own (it reads the forward's gate table). `t_fwd_floor_s` is K4's
    floor, `t_bwd_floor_s` K5's, `t_floor_s` K6's (fused) or K4 + K5's.
    With config.shadows off it prices K1 / K2 / K3 (shadow counts ignored).
    `calibration` (the dict of utils/calibrate.calibrate: "fma_ops_per_s"
    and "slots") prices it with a run's own measurement in place of the
    pinned FMA_PER_S and SLOTS."""
    if calibration is None:
        rate, slots = FMA_PER_S, None
    else:
        rate = float(calibration["fma_ops_per_s"])
        slots = tuple(sorted((k, float(v)) for k, v in calibration["slots"].items()))
    cc = culled_component_costs(config, tau, slots)
    px = diag["bh"] * diag["bw"]
    n_pl = diag["n_planes"]
    L = np.asarray(diag["list_len"], dtype=np.float64)
    A = np.asarray(diag["main_applied"], dtype=np.float64)
    SL = np.asarray(diag["shadow_list_len"], dtype=np.float64)
    SA = np.asarray(diag["shadow_applied"], dtype=np.float64)

    per_ray_bwd = cc["raygen_vjp"] + 60.0               # + S and the cotangent setup
    if config.shadows:
        per_ray_fwd = cc["raygen"] + cc["lightray"] + 40.0  # + blend and outputs
        fwd = (per_ray_fwd + (L + n_pl) * cc["lb_s"] + A * (cc["heavy_s"] + cc["corr_slot"])
               + SL * cc["sh_preA_s"] + n_pl * cc["sh_pre_s"]
               + SA * (cc["sh_preB_s"] + cc["sh_trans"]))
        bwd = per_ray_bwd + A * cc["vjp_main_s"] + SA * cc["vjp_sh_s"]
    else:
        per_ray_fwd = cc["raygen"] + 40.0
        fwd = per_ray_fwd + (L + n_pl) * cc["lb_s"] + A * cc["heavy_u"]
        bwd = per_ray_bwd + A * cc["vjp_main_u"]
    extra = 25.0 if fused else 0.0  # the in-kernel loss and MSE cotangents
    ops_fwd = float(np.sum(fwd) * px)
    ops_bwd = float(np.sum(bwd) * px)
    ops = ops_fwd + ops_bwd + extra * px * len(L)
    fixed = (per_ray_fwd + per_ray_bwd + extra) * px * len(L)
    return {
        "ops_per_frame": ops,
        "t_floor_s": ops / rate,
        "t_fwd_floor_s": ops_fwd / rate,
        "t_bwd_floor_s": ops_bwd / rate,
        # the priced per-ray constants; the bench sets the measured empty-scene
        # time beside it to isolate the object work
        "t_fixed_s": float(fixed) / rate,
        "components": {k: round(float(v), 1) for k, v in cc.items()},
        "mean_list_len": float(L.mean()),
        "mean_applied": float(A.mean()),
        "mean_shadow_list_len": float(SL.mean()),
        "mean_shadow_applied": float(SA.mean()),
    }
