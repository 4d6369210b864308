#!/usr/bin/env python3
"""Run the PyTorch port's display, train and roofline paths on one CUDA card and check them.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases (each prints its lines; any failure raises and exits non-zero):
  0  card name and power limit (nvidia-smi), torch and CUDA versions
  1  build csrc/hard_render.cu, csrc/soft_render.cu, csrc/soft_shadow.cu and
     csrc/calibrate.cu with nvcc for sm_90a, one nvcc each, all at once;
     print build times and each kernel's ptxas registers and spills
  2  the K7 kernel against its plain torch version on the card, on the
     same packed tables and broad-phase lists, in seven cases; then one
     frame of the whole step (kernel path) against the plain reference
     renderer, cell by cell
  2b the soft kernels against their plain versions on the card, in eight
     cases and one with culling off: K1's planes and gates, K2's tables under seeded random
     cotangents, K3's loss and tables, K3 against K1 + K2 with the MSE
     cotangents, the reduction against a float64 sum, and two launches
     giving bit-equal tables; then the kernel path end to end (forward and
     gradients) against the torch soft renderer at 400x150
  2c the shadowed kernels against their plain versions on the card: K4's
     14 planes and gates, K4-stats' counts, K5's tables under seeded random
     cotangents, K6's loss and tables, K6 against K4 + K5 with the MSE
     cotangents and two launches bit-equal, in eight cases (96x32; 400x150
     pitched; the bench headline 1920x1080 random_scene(20); a saturating
     light; a cache overflow past NC; full darkness, where the early-out
     fires; culling off; an empty scene); then the shadowed kernel path
     against the torch soft renderer at bench.py's grad_cam_rot_rel config
     (640x360, 20 spheres): camera-rotation relative error <= 1.5e-2; and
     its rotation gradient against a float64 render on independently built
     rays: no farther than the farthest of five independent float32
     renders there, within 1.5e-2 at 400x150 with a posed camera
  3  the display path, counted: the engine with a FramebufferSink on the
     card, 400x150 in all five modes, a forced spawn with a capacity
     doubling, 1920x500 with 100 spheres and 2x supersampling; K7's launch
     count must equal the frames rendered
  3b the train paths, counted: an in-process fit whose K1 / K2 launches
     must equal its steps; `python -m rtwc_tpu_torch.examples.inverse_render`
     in process at 1920x1080 with 20 spheres (generic path: K1, K2, the
     reduction); a fused-MSE training loop at the same size (K3, the
     reduction); and the entry point in subprocesses at 192x96, plain and
     --quantized, which must converge sub-pixel (exit 0)
  3c the shadowed train path, counted (every launch count set to 0 first):
     the generic step (K4, K5, the reduction) and the fused step (K6, the
     reduction) at the bench headline config, soft_tile_diagnostics
     (K4-stats), and `python -m rtwc_tpu_torch.examples.fit_from_shadow` at
     its defaults in process; each new kernel must have launched; then the
     entry point in a subprocess, which must print FIT OK and exit 0
  4  `python -m rtwc_tpu_torch` in a subprocess
  5  timings (CUDA events, host clock, profiler): K7 vs plain, broad phase,
     engine frames/s and rays/s, a per-frame host breakdown; K1, K2, K3 and
     the reduction vs plain at 1920x1080 with 20 spheres, the generic and
     fused train steps vs the same steps on the plain versions, and the
     device's busy share over 20 steps
  5b with shadows: K4, K5, K6, K4-stats and the reduction vs plain at the
     bench headline config; the generic and fused steps and the device's
     busy share; the fused step at 3840x2160 with 200 spheres and its peak
     memory; the cache-fallback share of tiles at both sizes
  6a the calibration chain kernel against its plain version for every body,
     at 64 iterations on a grid that fills the card: mul, add, max, abs,
     select, sqrt and div bit-equal, the others within 1e-5 relative
  6b the roofline calibration (utils/calibrate.py), launches counted: the
     FMA rate must lie within 0.5-1.05 of SMs x 128 x the maximum SM clock
     (nvidia-smi), every slot weight finite and non-negative; printed beside
     the constants utils/roofline.py pins, with each body's SASS counts
  6c the calibrated list-aware floor (roofline.culled_step_model) of K1-K3
     at 1920x1080 and of K4-K6 at the bench headline and at 4K/200, priced
     with phase 6b's calibration and with the pinned constants, must be at
     most 105 % of each kernel's device time
  6d `python -m rtwc_tpu_torch.bench` in a subprocess: exit 0, one JSON line
     of finite numbers, the no-credit and culled-floor speed-of-light
     percentages at most 105, every kernel of its path launched
Then a JSON line describing the kernels (each with its bound: the larger of
its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted
from this run's lists and gate tables; the chain kernel's is its FMAs over
SMs x 128 x the maximum clock; the soft kernels add `floor_ms`, the
calibrated floor of phase 6c from this run's calibration; the reduction's
`library_ms` is its whole function in float64 PyTorch calls, index_add_ and
sums, held to the kernel's sums), the seconds of each phase, and as the last
line {"ok": true, "device": {...}}. Imports nothing of JAX. TF32 is off.
Longer tables go to chip_smoke_out/.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")
FB_ATOL, FB_RTOL, HIT_FRAC_MAX, CELL_FRAC_MIN = 2e-3, 1e-4, 0.005, 0.995
# Soft kernels against their plain versions: planes (slice, atol, rtol);
# gradient tables within TABLE_REL of each table's largest magnitude; the
# loss to LOSS_RTOL; the two-float reduction to 1e-10 of the float64 sum.
SOFT_PLANES = ((slice(0, 3), 2e-3, 1e-4, "rgb"), (slice(3, 4), 1e-3, 1e-4, "depth"),
               (slice(4, 7), 1e-4, 1e-4, "normal"), (slice(7, 10), 1e-5, 1e-5, "alpha/m/s"))
TABLE_REL, LOSS_RTOL, TF_REL = 1e-4, 1e-6, 1e-10
SOFT_KW = dict(soft_miss_penalty=300.0, soft_mask_k=10.0)
# The shadowed kernels' 14 planes: K1's ten, vis, d(rgb)/d(vis).
SHADOW_PLANES = SOFT_PLANES + ((slice(10, 11), 1e-5, 1e-5, "vis"),
                               (slice(11, 14), 2e-3, 1e-4, "d(rgb)/d(vis)"))
ROT_REL, GRAD_RTOL, GRAD_ATOL = 1.5e-2, 2e-2, 5e-6  # ROADMAP queue 3's carve-out
# Phase 6: chain iterations of the kernel-vs-plain check; the calibrated floor
# (a lower bound) may exceed a kernel's device time by 5 % of noise at most.
CHAIN_ITERS, FLOOR_MAX = 64, 1.05
# One H100 SXM at 700 W (NVIDIA's data sheet): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the
# float32 rate outside the tensor cores.
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# float32 operations per pixel, counted from csrc/soft_common.cuh,
# csrc/soft_block.cuh and csrc/hard_render.cu: one per add, multiply,
# compare-select, exp, log1p, sqrt, rsqrt or divide, the smaller count where
# a branch could go either way.
OPS = dict(raygen=20, lb_sphere=37, lb_plane=43, geo_sphere=40, geo_plane=47, shade=78,
           acc7=31, acc10=40, final=20, light_ray=20, pre_a=23, pre_b=12, pre_plane=35,
           trans=23, corr=62, blend=18, cot=28, vjp_sphere=330, vjp_plane=360,
           sh_vjp_sphere=260, sh_vjp_plane=300, block_sum=5, tf_slot=40, loss=12,
           hard_sphere=30, hard_plane=25, hard_shade=70, hard_shadow=30)


def _card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _compare_fb(ref, ker, label):
    """hit masks differ on < 0.5 % of pixels; on pixels both call a hit,
    rgb / depth / normal / shading allclose(atol=2e-3, rtol=1e-4)."""
    import torch

    frac = (ref.hit != ker.hit).float().mean().item()
    both = ref.hit & ker.hit
    max_abs = 0.0
    bad = []
    for name in ("rgb", "depth", "normal", "shading"):
        a = getattr(ref, name)[both]
        b = getattr(ker, name)[both]
        if a.numel():
            max_abs = max(max_abs, (a - b).abs().max().item())
            if not torch.allclose(b, a, atol=FB_ATOL, rtol=FB_RTOL):
                n_bad = (~torch.isclose(b, a, atol=FB_ATOL, rtol=FB_RTOL)).sum().item()
                worst = (a - b).abs().reshape(a.shape[0], -1).amax(-1).topk(min(3, a.shape[0]))
                pix = both.nonzero()[worst.indices].tolist()
                bad.append(f"{name}: {n_bad} values outside tolerance, worst at (row, col) "
                           f"{pix}: plain {a[worst.indices].tolist()} "
                           f"kernel {b[worst.indices].tolist()}")
    print(f"phase 2: {label}: hit-mask mismatch {frac:.6f} (limit {HIT_FRAC_MAX}), "
          f"hits {int(both.sum().item())}, max abs diff on both-hit pixels {max_abs!r}")
    if frac >= HIT_FRAC_MAX or bad:
        raise AssertionError(f"{label}: kernel disagrees with plain version: "
                             f"hit mismatch {frac}, {bad}")
    return max_abs


def _time_ms(fn, reps=20, warm=3):
    """Median ms of fn() between CUDA events, after warm-up calls."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernel_device_ms(fn, reps=20, name="hard_render_kernel", tries=3):
    """Mean device time of the kernel `name` over `reps` calls of fn, from
    the profiler's CUDA kernel records whose name contains `name`. A profile
    that holds no such record is taken again, up to `tries` profiles in all
    (the profiler now and then returns a run without its device records);
    None if none holds one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def _ptxas_report(log_path: str):
    """[(kernel, registers, spill line)] from nvcc's -Xptxas -v output."""
    out, kernel = [], None
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                kernel, spill = line.split("'")[1], ""
            elif "spill" in line and kernel:
                spill = line.strip()
            elif "registers" in line and kernel:
                regs = line.split("Used")[1].split("registers")[0].strip()
                out.append((kernel, regs, spill))
    return out


def _soft_scene_96():
    """The scene of tests/test_pallas_soft.py:20-25 (96x32, 2 spheres + 1 plane)."""
    from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene

    s = empty_scene(4, 2)
    s = add_sphere(s, 5.0, (0.0, 1.0, 20.0), (200.0, 40.0, 40.0), speed=1.0)
    s = add_sphere(s, 3.0, (-4.0, -1.0, 28.0), (40.0, 200.0, 40.0), speed=1.0)
    return add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)


def _tables(red):
    dsph, dpl, dtf = red
    return {"dsph": dsph, "dpl": dpl, "dcam": dtf[:12, 0] + dtf[:12, 1]}


def _close_tables(a, b, what):
    """Every table of `a` within TABLE_REL of the largest magnitude of the
    same table of `b`; returns the largest absolute difference."""
    worst = 0.0
    for k in a:
        d = (a[k] - b[k]).abs().max().item() if a[k].numel() else 0.0
        scale = b[k].abs().max().item() if b[k].numel() else 0.0
        worst = max(worst, d)
        if not (d <= TABLE_REL * scale):
            raise AssertionError(f"{what} {k}: max abs diff {d!r} > {TABLE_REL} x {scale!r}")
    return worst


def _soft_case(SK, label, scene, cam, cfg, tau, dev, errs, cull=True):
    """Phase 2b for one case: K1, K2, K3 and the reduction against their
    plain versions on the same inputs, K3 against K1 + K2, determinism.
    cull=False runs every kernel without its culling (all live spheres
    listed, no gates)."""
    import torch

    spec = SK.SoftSpec(cfg, tau, cull=cull, bwd_cull=cull)
    sph, pl, camv = SK._packed(scene.to(dev), cam)
    lists = SK.build_lists(sph, camv, spec, cull)
    offsets, pidx = SK.list_entries(lists)
    n, ns = pidx.shape[0], sph.shape[1]

    def red(parts):
        return SK.soft_grad_reduce(parts[0], pidx, parts[1], parts[2], ns)

    def red_plain(parts):
        return SK.soft_grad_reduce_plain(parts[0][:n], pidx, parts[1], parts[2], ns)

    out_k, gates_k = SK.soft_fwd(sph, pl, camv, lists, spec=spec)
    out_p, gates_p = SK.soft_fwd_plain(sph, pl, camv, lists, spec=spec)
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all() and out_k.shape == out_p.shape):
        raise AssertionError(f"{label}: K1 output non-finite or misshapen")
    k1 = 0.0
    for sl, atol, rtol, name in SOFT_PLANES:
        d = (out_k[sl] - out_p[sl]).abs().max().item()
        k1 = max(k1, d)
        if not torch.allclose(out_k[sl], out_p[sl], atol=atol, rtol=rtol):
            raise AssertionError(f"{label}: K1 {name} outside atol {atol} rtol {rtol}: max {d!r}")
    if not torch.equal(gates_k, gates_p):
        raise AssertionError(f"{label}: K1 gates differ from the plain version's")

    gen = torch.Generator().manual_seed(1234)
    g = torch.randn(out_p.shape, generator=gen).to(dev)
    bwd_args = (sph, pl, camv, lists, offsets, gates_p, out_p, g)
    r2k = red(SK.soft_bwd(*bwd_args, spec=spec, n_entries=n))
    r2p = red_plain(SK.soft_bwd_plain(*bwd_args, spec=spec, n_entries=n))
    k2 = _close_tables(_tables(r2k), _tables(r2p), f"{label}: K2 + reduction")

    Hp, Wp = spec.extent
    H, W = cfg.height, cfg.width
    tgt = (torch.rand((3, Hp, Wp), generator=gen) * 255.0).to(dev)
    r3k = red(SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec, n_entries=n))
    r3p = red_plain(SK.soft_mse_plain(sph, pl, camv, lists, offsets, tgt, spec=spec, n_entries=n))
    k3 = _close_tables(_tables(r3k), _tables(r3p), f"{label}: K3 + reduction")
    loss_k = (r3k[2][12, 0].double() + r3k[2][12, 1].double()).item()
    loss_p = (r3p[2][12, 0].double() + r3p[2][12, 1].double()).item()
    truth = ((out_k[:3, :H, :W].double() - tgt[:, :H, :W].double()) ** 2).sum().item()
    for what, v in (("plain K3", loss_p), ("float64 sum over K1's rgb", truth)):
        if abs(loss_k - v) > LOSS_RTOL * abs(v):
            raise AssertionError(f"{label}: K3 loss {loss_k!r} vs {what} {v!r}")

    # K3 against K1 + K2 with the MSE cotangents
    g_mse = torch.zeros_like(out_k)
    scale = 2.0 / (255.0 * 255.0 * 3.0 * H * W)
    g_mse[:3, :H, :W] = torch.tensor(scale, dtype=torch.float32, device=dev) * (
        out_k[:3, :H, :W] - tgt[:, :H, :W])
    r12 = red(SK.soft_bwd(sph, pl, camv, lists, offsets, gates_k, out_k, g_mse, spec=spec,
                          n_entries=n))
    k3_vs = _close_tables(_tables(r3k), _tables(r12), f"{label}: K3 vs K1 + K2")

    # two launches on the same inputs give bit-equal tables
    again = (SK.soft_fwd(sph, pl, camv, lists, spec=spec),
             red(SK.soft_bwd(*bwd_args, spec=spec, n_entries=n)),
             red(SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec, n_entries=n)))
    same = (torch.equal(again[0][0], out_k) and torch.equal(again[0][1], gates_k)
            and all(torch.equal(a, b) for a, b in zip(again[1], r2k))
            and all(torch.equal(a, b) for a, b in zip(again[2], r3k)))
    if not same:
        raise AssertionError(f"{label}: two launches gave different tables")
    errs["K1"] = max(errs["K1"], k1)
    errs["K2"] = max(errs["K2"], k2)
    errs["K3"] = max(errs["K3"], k3)
    print(f"phase 2b: {label} (tau {tau}): max abs diff K1 {k1!r}, K2 tables {k2!r}, "
          f"K3 tables {k3!r}, K3 vs K1+K2 {k3_vs!r}; K3 loss rel diff "
          f"{abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)!r}; list entries {n}; "
          f"two launches bit-equal")
    return out_k


def _plain_autograd(SK):
    """The soft autograd Functions wired to the plain versions, for timing
    the same train steps without the kernels (phase 5)."""
    import torch

    class PlainRender(torch.autograd.Function):
        @staticmethod
        def forward(ctx, sph, pl, cam, spec):
            lists = SK.build_lists(sph, cam, spec, spec.cull)
            out, gates = SK.soft_fwd_plain(sph, pl, cam, lists, spec=spec)
            ctx.spec = spec
            ctx.save_for_backward(sph, pl, cam, out, gates, lists)
            return out

        @staticmethod
        def backward(ctx, g):
            sph, pl, cam, out, gates, lists = ctx.saved_tensors
            offsets, pidx = SK.list_entries(lists)
            n = pidx.shape[0]
            parts = SK.soft_bwd_plain(sph, pl, cam, lists, offsets, gates, out, g.contiguous(),
                                      spec=ctx.spec, n_entries=n)
            dsph, dpl, dtf = SK.soft_grad_reduce_plain(parts[0][:n], pidx, parts[1], parts[2],
                                                       sph.shape[1])
            return dsph, dpl, SK._dcam(dtf), None

    class PlainMSE(torch.autograd.Function):
        @staticmethod
        def forward(ctx, sph, pl, cam, tgt, spec):
            lists = SK.build_lists(sph, cam, spec, spec.cull)
            offsets, pidx = SK.list_entries(lists)
            n = pidx.shape[0]
            parts = SK.soft_mse_plain(sph, pl, cam, lists, offsets, tgt, spec=spec, n_entries=n)
            dsph, dpl, dtf = SK.soft_grad_reduce_plain(parts[0][:n], pidx, parts[1], parts[2],
                                                       sph.shape[1])
            H, W = spec.config.height, spec.config.width
            ctx.save_for_backward(dsph, dpl, SK._dcam(dtf))
            return (dtf[12, 0] + dtf[12, 1]) * (1.0 / 255.0 ** 2) / (3.0 * H * W)

        @staticmethod
        def backward(ctx, gbar):
            dsph, dpl, dcam = ctx.saved_tensors
            return gbar * dsph, gbar * dpl, gbar * dcam, None, None

    return PlainRender, PlainMSE


def _step_ms(step, reps: int) -> float:
    """Host ms per call of step() over `reps` calls, after two warm-up calls,
    between device synchronisations."""
    import torch

    step()
    step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def _profile_steps(step, out_name: str, label: str, tag: str, reps: int = 20):
    """Device busy share of `reps` calls of step() under the profiler, with
    the per-kernel device time written to chip_smoke_out/<out_name>.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    with open(os.path.join(OUT_DIR, f"{out_name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=60))
        f.write("\n".join(f"{us / reps:10.1f} us/step  {nm}" for nm, us in top))
    print(f"phase 5: profile {label}, {reps} steps: device busy {busy_us / wall_us!r} of "
          f"{wall_us / reps / 1e3!r} ms per step (profiler on) {tag}")
    print("phase 5: top device time: " + "; ".join(
        f"{nm[:40]} {us / reps:.1f} us/step" for nm, us in top[:6]))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: float, ops: float):
    """(least ms, what bounds it) for the work: bytes over 3.35 TB/s or
    float32 operations over 67 TFLOP/s, whichever takes longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _soft_work(lists, gates, npl: int, px: int, shl=None, counts=None, nc: int = 8):
    """Per-kernel float32 operations of one soft launch, from the lists and
    the gate tables it ran with (and, for the shadowed kernels, the shadow
    lists and K4-stats' counts): the forward sweep, the backward sweep, the
    shadowed forward and the shadowed backward, each summed over pixels."""
    import torch

    ns = lists.shape[2] - 1
    L = lists[:, 0, 0].double()
    gs = gates[:, 0, :ns].sum(1).double()
    gp = gates[:, 0, ns:].sum(1).double()
    o = OPS
    fwd = (o["raygen"] + L * o["lb_sphere"] + npl * o["lb_plane"]
           + gs * (o["geo_sphere"] + o["shade"] + o["acc7"])
           + gp * (o["geo_plane"] + o["shade"] + o["acc7"]) + o["final"])
    bwd = (o["raygen"] + 2 * o["final"] + 12 * o["tf_slot"]
           + gs * (o["lb_sphere"] + o["geo_sphere"] + o["shade"] + o["cot"] + o["vjp_sphere"]
                   + 7 * o["block_sum"])
           + gp * (o["lb_plane"] + o["geo_plane"] + o["shade"] + o["cot"] + o["vjp_plane"]
                   + 11 * o["block_sum"]))
    work = {"fwd": float(fwd.sum()) * px, "bwd": float(bwd.sum()) * px}
    if shl is not None:
        sgs = gates[:, 1, :ns].sum(1).double()
        sgp = gates[:, 1, ns:].sum(1).double()
        count, applied = counts[:, 0].double(), counts[:, 1].double()
        blend = torch.where(count <= nc, count * o["corr"], fwd)  # overflow: the re-walk
        sh_fwd = (fwd + (gs + gp) * (o["acc10"] - o["acc7"]) + o["light_ray"]
                  + shl[:, 0, 0].double() * o["pre_a"] + sgs * o["pre_b"] + npl * o["pre_plane"]
                  + applied * o["trans"] + blend + o["blend"])
        sh_bwd = (bwd + o["light_ray"] + sgs * (o["sh_vjp_sphere"] + 4 * o["block_sum"])
                  + sgp * (o["sh_vjp_plane"] + 8 * o["block_sum"]))
        work.update(sh_fwd=float(sh_fwd.sum()) * px, sh_bwd=float(sh_bwd.sum()) * px)
    return work


def _shadow_scene_96(n_spheres=4, n_planes=2):
    """tests/test_pallas_soft.py:112-115: the 96x32 scene with an occluder
    between the light and the others."""
    from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene

    s = empty_scene(n_spheres, n_planes)
    s = add_sphere(s, 5.0, (0.0, 1.0, 20.0), (200.0, 40.0, 40.0), speed=1.0)
    s = add_sphere(s, 3.0, (-4.0, -1.0, 28.0), (40.0, 200.0, 40.0), speed=1.0)
    s = add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)
    return add_sphere(s, 3.0, (-2.0, 8.0, 22.0), (40.0, 40.0, 200.0), speed=1.0)


def _crowd_scene(n=14, seed=3):
    """n overlapping spheres in frame over the floor: some 16x16 tiles gate
    in more objects than the NC cache slots."""
    import numpy as np
    from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene

    rng = np.random.default_rng(seed)
    s = empty_scene(16, 2)
    for _ in range(n):
        s = add_sphere(s, float(rng.uniform(2.0, 4.0)),
                       (float(rng.uniform(-4, 4)), float(rng.uniform(-2, 2)),
                        float(rng.uniform(18, 30))),
                       tuple(float(c) for c in rng.uniform(30, 220, 3)), speed=1.0)
    return add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)


def _dark_scene():
    """The 96x32 shadow scene under a ceiling slab that blocks the light:
    every floor and sphere pixel is in full shadow."""
    from rtwc_tpu_torch.scene import add_plane

    return add_plane(_shadow_scene_96(4, 3), (0.0, 20.0, 20.0), (0.0, -1.0, 0.0),
                     (80.0, 80.0, 80.0), 400.0, 400.0)


def _cast_scene(scene, dtype):
    """The scene with its float tables in `dtype`."""
    def cast(group):
        return group.replace(**{f.name: getattr(group, f.name).to(dtype)
                                for f in dataclasses.fields(group)
                                if getattr(group, f.name).is_floating_point()})
    return scene.replace(spheres=cast(scene.spheres), planes=cast(scene.planes))


def _rot_loss(fb_rgb, fb_depth, cfg):
    """bench.py's grad_cam_rot_rel loss (bench.py:377-382), zero target."""
    import torch

    return torch.mean((fb_rgb / 255.0) ** 2) + 0.01 * torch.mean(fb_depth) / cfg.far


def _rot_grad_kernel(scene, camera, cfg):
    """d loss / d camera.rot through the soft kernel path."""
    from rtwc_tpu_torch.camera import Camera
    from rtwc_tpu_torch.render import render_frame_soft_kernel

    rot = camera.rot.clone().requires_grad_(True)
    fb = render_frame_soft_kernel(scene, Camera(pos=camera.pos.clone(), rot=rot), cfg, tau=0.5)
    _rot_loss(fb.rgb, fb.depth, cfg).backward()
    return rot.grad.double()


def _rot_grad_arbiter(scene, camera, cfg):
    """Camera-rotation gradients of the same loss that share no rounding
    with the kernels: the torch soft renderer (`trace_soft`) on rays built
    here from camera_rays's formula, d = (right.v, up.v, fwd.v) normalised,
    v = (cx e1, cy e2, 1), not from the kernels' ray generation. Returns the
    float64 gradient and the float32 ones of: camera_rays itself; the
    float64 rays rounded to float32; and those rays with each component
    moved one ulp up or down at random (three seeds)."""
    import torch

    from rtwc_tpu_torch.camera import Camera, basis, camera_rays, projection_elements
    from rtwc_tpu_torch.render import trace_soft

    dev = scene.device
    W, H = cfg.width, cfg.height
    e1, e2 = projection_elements(cfg)

    def rays64(cam):
        right, up, fwd = basis(cam.rot.double())
        col = torch.arange(W, dtype=torch.float64, device=dev)
        row = torch.arange(H, dtype=torch.float64, device=dev)
        vx = ((2.0 * col - W) / W * e1)[None, :].expand(H, W)
        vy = ((H - 2.0 * row) / H * e2)[:, None].expand(H, W)
        d = torch.stack([vx * b[0] + vy * b[1] + b[2] for b in (right, up, fwd)], dim=-1)
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    def perturbed(seed):
        def rays(cam):
            d = rays64(cam).float()
            u = torch.randint(-1, 2, d.shape, generator=torch.Generator().manual_seed(seed))
            u = u.to(dev)
            up, down = (torch.nextafter(d, torch.full_like(d, s * float("inf"))) for s in (1, -1))
            moved = torch.where(u > 0, up, torch.where(u < 0, down, d))
            return d + (moved - d).detach()
        return rays

    def grad(dtype, rays):
        rot = camera.rot.to(dev, dtype).clone().requires_grad_(True)
        cam = Camera(pos=camera.pos.to(dev, dtype), rot=rot)
        rgb, depth, _, _ = trace_soft(_cast_scene(scene, dtype), cam.pos, rays(cam), cfg, tau=0.5)
        _rot_loss(rgb, depth, cfg).backward()
        return rot.grad.double()

    g64 = grad(torch.float64, rays64)
    family = [grad(torch.float32, lambda cam: camera_rays(cam, W, H, e1, e2, device=dev)[1]),
              grad(torch.float32, lambda cam: rays64(cam).float())]
    family += [grad(torch.float32, perturbed(seed)) for seed in (1, 2, 3)]
    return g64, family


def _shadow_case(SK, SH, label, scene, cam, cfg, tau, dev, errs, cull=True):
    """Phase 2c for one case: K4, K4-stats, K5, K6 and the reduction against
    their plain versions on the same inputs, K6 against K4 + K5, two
    launches bit-equal. Returns (K4's planes, gates, K4-stats' counts)."""
    import torch

    spec = SK.SoftSpec(cfg, tau, cull=cull, bwd_cull=cull)
    sph, pl, camv = SK._packed(scene.to(dev), cam)
    lists, shl = SH.build_lists(sph, pl, camv, spec, cull)
    offsets, pidx = SK.list_entries(lists)
    sh_offsets, pshidx = SK.list_entries(shl)
    n, nsh, ns = pidx.shape[0], pshidx.shape[0], sph.shape[1]
    sizes = dict(n_entries=n, n_sh_entries=nsh)

    def red(parts):
        return SK.soft_grad_reduce(parts[0], pidx, parts[2], parts[3], ns, psh=parts[1],
                                   pshidx=pshidx)

    def red_plain(parts):
        return SK.soft_grad_reduce_plain(parts[0][:n], pidx, parts[2], parts[3], ns,
                                         parts[1][:nsh], pshidx)

    out_k, gates_k = SH.soft_sh_fwd(sph, pl, camv, lists, shl, spec=spec)
    out_p, gates_p = SH.soft_sh_fwd_plain(sph, pl, camv, lists, shl, spec=spec)
    out_s, gates_s, cnt_k = SH.soft_sh_stats(sph, pl, camv, lists, shl, spec=spec)
    cnt_p = SH.soft_sh_stats_plain(sph, pl, camv, lists, shl, spec=spec)[2]
    torch.cuda.synchronize()
    if not (torch.isfinite(out_k).all() and out_k.shape == out_p.shape):
        raise AssertionError(f"{label}: K4 output non-finite or misshapen")
    k4 = 0.0
    for sl, atol, rtol, name in SHADOW_PLANES:
        d = (out_k[sl] - out_p[sl]).abs().max().item()
        k4 = max(k4, d)
        if not torch.allclose(out_k[sl], out_p[sl], atol=atol, rtol=rtol):
            raise AssertionError(f"{label}: K4 {name} outside atol {atol} rtol {rtol}: max {d!r}")
    if not (torch.equal(gates_k, gates_p) and torch.equal(cnt_k, cnt_p)
            and torch.equal(out_s, out_k) and torch.equal(gates_s, gates_k)):
        raise AssertionError(f"{label}: K4 gates or K4-stats counts differ from the plain "
                             f"version's, or K4-stats' planes from K4's")

    gen = torch.Generator().manual_seed(1234)
    g = torch.randn(out_p.shape, generator=gen).to(dev)
    bwd_args = (sph, pl, camv, lists, shl, offsets, sh_offsets, gates_p, out_p, g)
    r5k = red(SH.soft_sh_bwd(*bwd_args, spec=spec, **sizes))
    r5p = red_plain(SH.soft_sh_bwd_plain(*bwd_args, spec=spec, **sizes))
    k5 = _close_tables(_tables(r5k), _tables(r5p), f"{label}: K5 + reduction")

    Hp, Wp = spec.extent
    H, W = cfg.height, cfg.width
    tgt = (torch.rand((3, Hp, Wp), generator=gen) * 255.0).to(dev)
    mse_args = (sph, pl, camv, lists, shl, offsets, sh_offsets, tgt)
    r6k = red(SH.soft_sh_mse(*mse_args, spec=spec, **sizes))
    r6p = red_plain(SH.soft_sh_mse_plain(*mse_args, spec=spec, **sizes))
    k6 = _close_tables(_tables(r6k), _tables(r6p), f"{label}: K6 + reduction")
    loss_k = (r6k[2][12, 0].double() + r6k[2][12, 1].double()).item()
    loss_p = (r6p[2][12, 0].double() + r6p[2][12, 1].double()).item()
    truth = ((out_k[:3, :H, :W].double() - tgt[:, :H, :W].double()) ** 2).sum().item()
    for what, v in (("plain K6", loss_p), ("float64 sum over K4's rgb", truth)):
        if abs(loss_k - v) > LOSS_RTOL * abs(v):
            raise AssertionError(f"{label}: K6 loss {loss_k!r} vs {what} {v!r}")

    g_mse = torch.zeros_like(out_k)
    scale = 2.0 / (255.0 * 255.0 * 3.0 * H * W)
    g_mse[:3, :H, :W] = torch.tensor(scale, dtype=torch.float32, device=dev) * (
        out_k[:3, :H, :W] - tgt[:, :H, :W])
    r45 = red(SH.soft_sh_bwd(sph, pl, camv, lists, shl, offsets, sh_offsets, gates_k, out_k,
                             g_mse, spec=spec, **sizes))
    k6_vs = _close_tables(_tables(r6k), _tables(r45), f"{label}: K6 vs K4 + K5")

    again = (SH.soft_sh_fwd(sph, pl, camv, lists, shl, spec=spec),
             red(SH.soft_sh_bwd(*bwd_args, spec=spec, **sizes)),
             red(SH.soft_sh_mse(*mse_args, spec=spec, **sizes)),
             SH.soft_sh_stats(sph, pl, camv, lists, shl, spec=spec)[2])
    same = (torch.equal(again[0][0], out_k) and torch.equal(again[0][1], gates_k)
            and all(torch.equal(a, b) for a, b in zip(again[1], r5k))
            and all(torch.equal(a, b) for a, b in zip(again[2], r6k))
            and torch.equal(again[3], cnt_k))
    if not same:
        raise AssertionError(f"{label}: two launches gave different tables")
    errs["K4"] = max(errs["K4"], k4)
    errs["K5"] = max(errs["K5"], k5)
    errs["K6"] = max(errs["K6"], k6)
    print(f"phase 2c: {label} (tau {tau}{'' if cull else ', culling off'}): max abs diff K4 "
          f"{k4!r}, K5 tables {k5!r}, K6 tables {k6!r}, K6 vs K4+K5 {k6_vs!r}; K6 loss rel diff "
          f"{abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)!r}; K4-stats counts equal (max "
          f"culled-in {int(cnt_k[:, 0].max())}, tiles over NC={SH.NC}: "
          f"{int((cnt_k[:, 0] > SH.NC).sum())} of {cnt_k.shape[0]}); list entries {n}, shadow "
          f"entries {nsh}; two launches bit-equal")
    return out_k, gates_k, cnt_k


def _reduce_library(pvals, pidx, ppl, ptf, ns, psh=None, pshidx=None):
    """soft_grad_reduce's function in PyTorch library calls, in float64:
    (dsph [NS, 8], dpl [NP, 12], camera sums hi + lo [NTF])."""
    import torch

    dsph = torch.zeros((ns, 8), dtype=torch.float64, device=pvals.device)
    dsph.index_add_(0, pidx.long(), pvals[:pidx.shape[0]].double())
    if psh is not None:
        dsph[:, :4].index_add_(0, pshidx.long(), psh[:pshidx.shape[0]].double())
    return dsph, ppl.double().sum(0), ptf.double().sum((0, 2))


def _reduce_library_ms(P, args, kernel_out):
    """Median ms of _reduce_library(*args), after holding its sums to the
    kernel's (`kernel_out` of soft_grad_reduce on the same args; the active
    rows, which the kernel zeroes, are left out): each sum within TABLE_REL
    (tables) or TF_REL (the two-float camera sums) of the sum of its terms'
    magnitudes, the bound of a summation's rounding."""
    lib = _reduce_library(*args)
    mag = _reduce_library(*(a.abs() if i in (0, 2, 3, 5) else a for i, a in enumerate(args)))
    k_sph, k_pl, k_tf = kernel_out
    for name, got, ker, m, tol, skip in (
            ("spheres", lib[0].T, k_sph.double(), mag[0].T, TABLE_REL, P.S_ACTIVE),
            ("planes", lib[1].T, k_pl.double(), mag[1].T, TABLE_REL, P.P_ACTIVE),
            ("camera sums", lib[2][None], k_tf.double().sum(1)[None], mag[2][None], TF_REL, -1)):
        keep = [r for r in range(got.shape[0]) if r != skip]
        excess = ((got[keep] - ker[keep]).abs() - tol * m[keep]).max().item()
        if excess > 0.0:
            raise AssertionError(f"reduction library {name}: {excess} beyond its bound from the "
                                 f"kernel's sums")
    return _time_ms(lambda: _reduce_library(*args))


def _max_sm_clock_mhz() -> float:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60, check=True)
    return float(proc.stdout.strip().splitlines()[0])


def _phase_6ab(dev, tag):
    """6a: every calibration body, kernel against plain version; 6b: the
    calibration itself, counted, against the pinned constants. Returns the
    calibration and the kernels-line entry of the chain kernel."""
    import numpy as np
    import torch

    from rtwc_tpu_torch.utils import calibrate as CB
    from rtwc_tpu_torch.utils import roofline as R

    n = CB.full_occupancy_elems(dev)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0.4, 0.8, n).astype(np.float32)).to(dev)
    worst = 0.0
    for op in CB.OPS:
        k = CB.chain_kernel(op, x, CHAIN_ITERS)
        p = CB.chain_plain(op, x, CHAIN_ITERS)
        torch.cuda.synchronize()
        if not (k.shape == p.shape and torch.isfinite(k).all()):
            raise AssertionError(f"chain {op}: kernel output non-finite or misshapen")
        diff = (k - p).abs()
        worst = max(worst, diff.max().item())
        rel = (diff / p.abs()).max().item()
        same = torch.equal(k, p)
        exact = op in CB.EXACT
        print(f"phase 6a: chain {op}, {n} x {CB.NCHAIN} chains, {CHAIN_ITERS} iterations: "
              f"bit-equal {same}, max rel diff {rel!r} (limit: "
              f"{'bit-equal' if exact else CB.INEXACT_RTOL})")
        if not (same if exact else rel <= CB.INEXACT_RTOL):
            raise AssertionError(f"chain {op}: kernel disagrees with its plain version ({rel})")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    peak = sms * 128 * _max_sm_clock_mhz() * 1e6
    CB.LAUNCHES = 0
    t = time.perf_counter()
    res = CB.calibrate(dev)
    launches = CB.LAUNCHES
    rate = res["fma_ops_per_s"]
    print(f"phase 6b: calibration in {time.perf_counter() - t:.1f} s, {launches} launches: FMA "
          f"{rate!r} elem-ops/s = {rate / peak!r} of {sms} SMs x 128 x the maximum clock "
          f"({peak!r}; limits 0.5-1.05); pinned {R.FMA_PER_S!r}; memory "
          f"{res['hbm_bytes_per_s']!r} B/s, pinned {R.HBM_BYTES_PER_S!r} {tag}")
    launch_apps = CB.I2 * CB.DEPTH * 1e-6  # ns an application -> ms a launch at I2
    for op in ("fma",) + tuple(res["slots"]):
        w_txt = "" if op == "fma" else f"{res['slots'][op]!r} FMA slots, pinned {R.SLOTS[op]!r}; "
        print(f"phase 6b: {op}: {w_txt}slope {res['slope_ns'][op] * launch_apps!r} ms a launch "
              f"of {CB.I2} iterations")
    weights = list(res["slots"].values())
    if not (0.5 * peak <= rate <= 1.05 * peak):
        raise AssertionError(f"FMA rate {rate} outside 0.5-1.05 of the peak {peak}")
    if not all(np.isfinite(w) and w >= 0.0 for w in weights) or launches < 1:
        raise AssertionError(f"calibration: weights {weights}, launches {launches}")
    sass = CB.sass_counts()
    for op, cnt in sass.items():  # the loop body holds NCHAIN x DEPTH applications
        top = sorted(cnt.items(), key=lambda kv: -kv[1])[:8]
        print(f"phase 6b: SASS {op}: {sum(cnt.values())} instructions in the kernel; "
              + ", ".join(f"{o} {c}" for o, c in top))

    k_ms = _time_ms(lambda: CB.chain_kernel("fma", x, CHAIN_ITERS))
    p_ms = _time_ms(lambda: CB.chain_plain("fma", x, CHAIN_ITERS), reps=3, warm=1)
    d_ms = _kernel_device_ms(lambda: CB.chain_kernel("fma", x, CHAIN_ITERS), name="chain_kernel")
    i2_ms = _time_ms(lambda: CB.chain_kernel("fma", x, CB.I2), reps=5, warm=1)
    ops = n * CB.NCHAIN * CHAIN_ITERS * CB.DEPTH
    entry = {"name": "chain_kernel (roofline calibration chains)", "route": "cuda",
             "source": "rtwc_tpu_torch/csrc/calibrate.cu",
             "replaces": "scripts/calibrate_roofline.py:66", "launches": launches,
             "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, "bound_ms": ops / peak * 1e3,
             "bound_by": "operations", "library_ms": None, "floor_ms": None, "device_ms": d_ms,
             "ms_at_i2": i2_ms,
             "shape": f"fma body, {n} threads x {CB.NCHAIN} chains, {CHAIN_ITERS} iterations of "
                      f"{CB.DEPTH}; launches from the calibration ({CB.I1} and {CB.I2} iterations, "
                      f"14 bodies)"}
    print(f"phase 6b: chain kernel (fma, {CHAIN_ITERS} iterations): {k_ms!r} ms (device "
          f"{d_ms!r} ms), plain {p_ms!r} ms, bound {entry['bound_ms']!r} ms (operations); "
          f"{CB.I2} iterations {i2_ms!r} ms {tag}")
    return {"calibration": res, "entry": entry}


def _phase_6c(cases, calibration, tag):
    """6c: the list-aware floor of culled_step_model for each kernel of each
    case, priced with this run's calibration (phase 6b) and with the pinned
    constants of utils/roofline.py, must be at most FLOOR_MAX of its device
    time. Returns {kernel: floor ms from this run's calibration} of the first
    case that names it."""
    from rtwc_tpu_torch.utils import roofline as R

    role = {"K1": "fwd", "K4": "fwd", "K2": "bwd", "K5": "bwd", "K3": "fused", "K6": "fused"}
    floors = {}
    for label, cfg, diag, dev_ms in cases:
        fl = {}
        for src, cal in (("run", calibration), ("pinned", None)):
            gen = R.culled_step_model(cfg, 0.5, diag, fused=False, calibration=cal)
            fused = R.culled_step_model(cfg, 0.5, diag, fused=True, calibration=cal)
            fl[src] = {"fwd": gen["t_fwd_floor_s"] * 1e3, "bwd": gen["t_bwd_floor_s"] * 1e3,
                       "fused": fused["t_floor_s"] * 1e3}
        for key, d in dev_ms.items():
            f, f_pin = fl["run"][role[key]], fl["pinned"][role[key]]
            floors.setdefault(key, f)
            if d is None:
                raise AssertionError(f"{label}: no device time for {key}")
            print(f"phase 6c: {label}: {key} calibrated floor {f!r} ms (pinned constants "
                  f"{f_pin!r} ms), device {d!r} ms -> {f / d * 100:.1f} % ({f_pin / d * 100:.1f} "
                  f"%; limit {FLOOR_MAX * 100:.0f} %); mean list {gen['mean_list_len']:.2f}, "
                  f"applied {gen['mean_applied']:.2f}, shadow list "
                  f"{gen['mean_shadow_list_len']:.2f}, shadow applied "
                  f"{gen['mean_shadow_applied']:.2f} {tag}")
            if max(f, f_pin) > FLOOR_MAX * d:
                raise AssertionError(f"{label}: {key}'s floor {f} / {f_pin} ms exceeds its device "
                                     f"time {d} ms")
    return floors


def _phase_6d(tag):
    """6d: `python -m rtwc_tpu_torch.bench` in a subprocess: exit 0, one JSON
    line with every number finite, the speed-of-light percentages at most
    105, and every kernel of its path launched."""
    import math

    cmd = [sys.executable, "-m", "rtwc_tpu_torch.bench"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t
    with open(os.path.join(OUT_DIR, "bench.log"), "w") as f:
        f.write(proc.stderr + "\n" + proc.stdout)
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    res = json.loads(lines[-1])
    if len(lines) != 1 or not isinstance(res, dict):
        raise AssertionError(f"bench printed {len(lines)} lines on stdout, want one JSON line")

    def numbers(v):
        if isinstance(v, dict):
            for x in v.values():
                yield from numbers(x)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v

    if not all(math.isfinite(v) for v in numbers(res)):
        raise AssertionError(f"bench: a number is not finite: {res}")
    sol = {k: res[k] for k in res if k.startswith(("sol_pct_nocull", "sol_pct_culled_floor"))}
    launches = json.loads(proc.stderr.split("# kernel launches: ", 1)[1].splitlines()[0])
    print(f"phase 6d: {' '.join(cmd[1:])}: exit 0 in {secs:.1f} s; {res['value']!r} rays/s "
          f"(shadowed fused step), generic {res['generic_shadowed']!r}, 4K "
          f"{res['r4k_200sph_shadowed']!r}; speed of light {sol}; launches {launches} {tag}")
    for line in proc.stderr.splitlines():
        print(f"phase 6d: bench {line}")
    if not all(v <= 105.0 for v in sol.values()) or len(sol) != 6:
        raise AssertionError(f"bench speed-of-light percentages {sol} (limit 105)")
    used = ("soft_mse", "soft_grad_reduce", "soft_sh_fwd", "soft_sh_bwd", "soft_sh_mse",
            "soft_sh_stats", "hard_render")
    if not all(launches.get(k, 0) >= 1 for k in used):
        raise AssertionError(f"bench launches {launches}: a kernel of its path never ran")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    laps, mark = {}, [t_start]

    def lap(label):
        now = time.perf_counter()
        laps[label] = round(now - mark[0], 1)
        mark[0] = now
        print(f"phase {label}: {laps[label]} s")

    # -- phase 0 ---------------------------------------------------------------
    card = _card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"phase 0: {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from rtwc_tpu_torch.camera import Camera, default_camera
    from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.engine.engine import (
        _render_step, _start_download, resolve_device)
    from rtwc_tpu_torch.heads import encode_frame
    from rtwc_tpu_torch.io import FramebufferSink
    from rtwc_tpu_torch.render import _cuda, hard_kernel
    from rtwc_tpu_torch.render import pack as P
    from rtwc_tpu_torch.scene import default_scene, empty_scene, random_scene

    resolve_device(dev)  # TF32 off for matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 ---------------------------------------------------------------
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_core as C
    from rtwc_tpu_torch.render import soft_kernel as SK

    t0 = time.perf_counter()
    names = ("hard_render", "soft_render", "soft_shadow", "calibrate")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:  # one nvcc for each source, at once
        libs = dict(zip(names, pool.map(_cuda.build, names)))
    hard_kernel._kernel_fn()
    for fn_name in C._ENTRIES:
        C._fn(fn_name)
    print(f"phase 1: built {', '.join(os.path.relpath(v, ROOT) for v in libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{k} {_cuda.build_seconds[k]:.2f} s" for k in libs)
          + f"; {' '.join(_cuda.ARCH_FLAGS)})")
    for lib, so in libs.items():
        for kernel, regs, spill in _ptxas_report(so[:-3] + ".log"):
            print(f"phase 1: ptxas {lib}: {kernel}: {regs} registers; {spill}")
    lap("0-1")

    # -- phase 2 ---------------------------------------------------------------
    base = RenderConfig(width=400, height=150)
    posed = Camera(pos=torch.tensor([3.0, 2.0, -5.0]), rot=torch.tensor([0.25, 2.8, 0.0]))
    cases = [
        ("a default 400x150", default_scene(base, device=dev), default_camera(), base),
        ("a default 400x150 shadows", default_scene(base, device=dev), default_camera(),
         base.replace(shadows=True)),
        ("b posed camera 400x150", default_scene(base, device=dev), posed, base),
        ("c random 20 1920x1080 shadows", random_scene(20, seed=0, device=dev),
         default_camera(), RenderConfig(width=1920, height=1080, shadows=True)),
        ("d random 200 3840x2160 shadows", random_scene(200, max_spheres=256, device=dev),
         default_camera(), RenderConfig(width=3840, height=2160, shadows=True)),
        ("e default 401x151 shadows", default_scene(base, device=dev), default_camera(),
         RenderConfig(width=401, height=151, shadows=True)),
        ("f empty 400x150", empty_scene(8, 2, device=dev), default_camera(), base),
    ]
    bh = bw = 16
    max_err = 0.0
    packed = {}
    for label, scene, cam, cfg in cases:
        sph, pl, counts = P.pack_scene(scene)
        camv = P.pack_camera(cam, dev)
        lists = hard_kernel.tile_lists(sph, camv, cfg, bh, bw)
        args = (sph, pl, counts.reshape(1, 2), camv, lists)
        ker = hard_kernel.hard_render_packed(*args, config=cfg, bh=bh, bw=bw)
        plain = hard_kernel.hard_render_plain(*args, config=cfg, bh=bh, bw=bw)
        torch.cuda.synchronize()
        fk = hard_kernel.planes_to_framebuffer(ker, cfg, cfg.height)
        fp = hard_kernel.planes_to_framebuffer(plain, cfg, cfg.height)
        if not (torch.isfinite(ker).all() and ker.shape == plain.shape):
            raise AssertionError(f"{label}: non-finite or misshapen kernel output")
        max_err = max(max_err, _compare_fb(fp, fk, label))
        if label.startswith("f"):
            if fk.hit.any() or (fk.rgb != 0).any():
                raise AssertionError("empty scene must render all background")
            print("phase 2: f empty scene renders all background")
        packed[label] = (args, cfg)

    # the whole step on the card: kernel path vs the plain reference renderer,
    # with and without camera pitch (the broad-phase cones must follow it)
    for cam_label, cam, scene_fn in (
            ("default camera", default_camera(), lambda c: default_scene(c, device=dev)),
            ("posed camera", posed, lambda c: default_scene(c, device=dev)),
            ("posed camera random 20", posed, lambda c: random_scene(20, seed=0, device=dev))):
        for mode in (RenderMode.RGB_ASCII, RenderMode.BIT_ASCII):
            cfg = base.replace(mode=mode, shadows=True)
            scene = scene_fn(cfg)
            _, (k1, c1, ch1) = _render_step(scene, cam, 0.02, cfg.replace(renderer="kernel"))
            _, (k2, c2, ch2) = _render_step(scene, cam, 0.02, cfg.replace(renderer="reference"))
            same = (k1 == k2) & (ch1 == ch2)
            same &= (c1 == c2).all(-1) if c1.dim() == 3 else (c1 == c2)
            frac = same.float().mean().item()
            print(f"phase 2: step {mode.value} 400x150 shadows, {cam_label}: cells equal to the "
                  f"reference renderer's on {frac:.6f} (limit {CELL_FRAC_MIN})")
            if frac < CELL_FRAC_MIN:
                raise AssertionError(f"{mode.value} {cam_label}: cells differ from the "
                                     f"reference renderer")

    lap("2")

    # -- phase 2b: the soft kernels against their plain versions ----------------
    from rtwc_tpu_torch.examples import inverse_render as IR
    from rtwc_tpu_torch.render.anneal import AnnealSchedule
    from rtwc_tpu_torch.scene import add_sphere

    cfg96 = RenderConfig(width=96, height=32, max_spheres=4, max_planes=2, **SOFT_KW)
    cfg20, scene20 = IR.build(1920, 1080, 20)
    one = add_sphere(empty_scene(8, 4), 4.0, (2.0, 0.0, 15.0), (10.0, 220.0, 10.0), speed=1.0)
    soft_cases = [
        ("CFG 96x32", _soft_scene_96(), default_camera(), cfg96, 0.5),
        ("default 400x150 posed camera", default_scene(base), posed, base, 0.5),
        ("--spheres 20 1920x1080", scene20, default_camera(), cfg20, 20.0),
        ("--spheres 20 1920x1080", scene20, default_camera(), cfg20, 0.05),
        ("random 20 1920x1080", random_scene(20, seed=0), default_camera(),
         RenderConfig(width=1920, height=1080, **SOFT_KW), 0.5),
        ("empty 400x150", empty_scene(8, 2), default_camera(), base, 0.5),
        ("1 sphere in 8 slots 96x32", one, default_camera(),
         cfg96.replace(max_spheres=8, max_planes=4), 0.5),
        ("default 401x151", default_scene(base), default_camera(),
         RenderConfig(width=401, height=151), 0.5),
    ]
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "reduce": 0.0}
    for label, scene, cam, cfg, tau in soft_cases:
        out = _soft_case(SK, label, scene, cam, cfg, tau, dev, errs)
        if label.startswith("empty") and (out[SK.SO_ALPHA] != 0).any():
            raise AssertionError("the empty scene must render all background")
    _soft_case(SK, "random 24 400x150 posed camera, culling off",
               random_scene(24, max_spheres=24, max_planes=4, seed=7), posed,
               RenderConfig(width=400, height=150, max_spheres=24, **SOFT_KW), 0.5, dev, errs,
               cull=False)

    # the reduction: adversarial two-float partials against a float64 sum,
    # and random sphere / plane partials against the plain reduction
    import numpy as np

    rng = np.random.RandomState(0)
    T = 8160
    x = (rng.randn(T, SK.NTF) * np.exp(rng.randn(T, SK.NTF) * 4.0)).astype(np.float32)
    ptf = torch.zeros((T, SK.NTF, 2))
    ptf[..., 0] = torch.from_numpy(x)
    ptf = ptf.to(dev)
    pvals = torch.from_numpy(rng.randn(20000, 8).astype(np.float32)).to(dev)
    pidx = torch.from_numpy(rng.randint(0, 20, 20000).astype(np.int32)).to(dev)
    ppl = torch.from_numpy(rng.randn(T, 2, 12).astype(np.float32)).to(dev)
    rk = SK.soft_grad_reduce(pvals, pidx, ppl, ptf, 20)
    rp = SK.soft_grad_reduce_plain(pvals, pidx, ppl, ptf, 20)
    torch.cuda.synchronize()
    truth = x.astype(np.float64).sum(0)
    got = (rk[2][:, 0].double() + rk[2][:, 1].double()).cpu().numpy()
    tf_rel = float(np.max(np.abs(got - truth) / np.abs(truth)))
    f32_rel = float(np.max(np.abs(x.sum(0, dtype=np.float32) - truth) / np.abs(truth)))
    red_diff = max((a - b).abs().max().item() for a, b in zip(rk, rp))
    errs["reduce"] = red_diff
    print(f"phase 2b: reduction of {T} adversarial two-float partials: max rel err vs float64 "
          f"{tf_rel!r} (limit {TF_REL}; a plain float32 sum: {f32_rel!r}); against the plain "
          f"reduction (20000 sphere entries, 2 planes, 13 slots): max abs diff {red_diff!r}")
    _close_tables(_tables(rk), _tables(rp), "reduction vs plain")
    if tf_rel > TF_REL:
        raise AssertionError(f"the two-float reduction is {tf_rel} off the float64 sum")

    # the kernel path end to end against the torch soft renderer on the card:
    # forward planes and the gradients of a loss over rgb, depth and normals
    from rtwc_tpu_torch.render import render_frame_soft, render_frame_soft_kernel

    cfg_o = RenderConfig(width=400, height=150, max_spheres=8, max_planes=2, **SOFT_KW)
    grads = {}
    for which, render in (("kernel", render_frame_soft_kernel), ("oracle", render_frame_soft)):
        sc = default_scene(cfg_o, device=dev)
        leaves = {"sphere centers": sc.spheres.center, "sphere radii": sc.spheres.radius,
                  "sphere colours": sc.spheres.color, "plane centres": sc.planes.center,
                  "plane normals": sc.planes.normal}
        for t in leaves.values():
            t.requires_grad_(True)
        cam_o = Camera(pos=posed.pos.clone().requires_grad_(True),
                       rot=posed.rot.clone().requires_grad_(True))
        fb = render(sc, cam_o, cfg_o, tau=0.5)
        loss = (torch.mean((fb.rgb / 255.0) ** 2) + 0.01 * torch.mean(fb.depth) / cfg_o.far
                + 0.1 * torch.mean(fb.normal ** 2))
        loss.backward()
        grads[which] = (fb, {**{k: v.grad for k, v in leaves.items()},
                             "camera pos": cam_o.pos.grad, "camera rot": cam_o.rot.grad})
    (fk, gk), (fo, go) = grads["kernel"], grads["oracle"]
    # The torch renderer runs other float32 roundings on the card (it
    # multiplies by reciprocals where the kernels divide). At silhouettes the
    # penalty slope times miss_penalty amplifies them, so, as in the CPU
    # tests: at most 0.5 % of the values may leave the tolerance, and no
    # kernel value may be farther from a float64 render of the same scene
    # than the torch renderer's farthest value.
    sc64 = default_scene(cfg_o, device=dev)
    sc64 = sc64.replace(spheres=sc64.spheres.replace(**{
        f.name: getattr(sc64.spheres, f.name).double() for f in dataclasses.fields(sc64.spheres)}),
        planes=sc64.planes.replace(**{f.name: getattr(sc64.planes, f.name).double()
                                      for f in dataclasses.fields(sc64.planes)}))
    f64 = render_frame_soft(sc64, Camera(pos=posed.pos.double(), rot=posed.rot.double()), cfg_o,
                            tau=0.5)
    for field, atol in (("rgb", 2e-3), ("depth", 1e-3), ("normal", 1e-4), ("alpha", 1e-5)):
        a, b = getattr(fk, field).detach().double(), getattr(fo, field).detach().double()
        e = getattr(f64, field).detach()
        tol = atol + 1e-4 * b.abs()
        frac = ((a - b).abs() > tol).double().mean().item()
        worst = (b - e).abs().max().item()
        far_out = ((a - e).abs() > worst + tol).sum().item()
        print(f"phase 2b: kernel path vs torch soft renderer, {field}: max abs diff "
              f"{(a - b).abs().max().item()!r}, {frac!r} of values off tolerance (limit 0.005); "
              f"kernel farthest from float64 {(a - e).abs().max().item()!r}, torch renderer "
              f"{worst!r}")
        if frac >= 0.005 or far_out:
            raise AssertionError(f"kernel path vs torch soft renderer: {field} disagrees")
    worst = 0.0
    for k in gk:
        a, b = gk[k].double().cpu(), go[k].double().cpu()
        bad = (a - b).abs() > 1e-6 + 2e-2 * torch.maximum(a.abs(), b.abs())
        worst = max(worst, ((a - b).abs() / (b.abs() + 1e-12)).max().item())
        if bad.any():
            raise AssertionError(f"kernel path vs torch soft renderer: {k} gradients "
                                 f"{a[bad][:4].tolist()} vs {b[bad][:4].tolist()}")
    print(f"phase 2b: kernel path vs the torch soft renderer, 400x150 default scene, posed "
          f"camera, tau 0.5: gradients of 7 leaf groups within rtol 2e-2 / atol 1e-6 "
          f"(largest relative diff {worst!r})")

    lap("2b")

    # -- phase 2c: the shadowed kernels against their plain versions --------------
    from rtwc_tpu_torch.examples import fit_from_shadow as FS

    cfg96s = cfg96.replace(shadows=True)
    cfg_hl = RenderConfig(width=1920, height=1080, max_spheres=20, max_planes=4, shadows=True,
                          **SOFT_KW)  # bench.py's headline step
    scene_hl = random_scene(20, max_spheres=20, max_planes=4, seed=0)
    shadow_cases = [
        ("CFG_SH 96x32", _shadow_scene_96(), default_camera(), cfg96s, 0.5, True),
        ("default 400x150 posed camera shadows", default_scene(base), posed,
         base.replace(shadows=True), 0.5, True),
        ("bench headline 1920x1080 random_scene(20)", scene_hl, default_camera(), cfg_hl, 0.5,
         True),
        ("saturating light 96x32", _shadow_scene_96(), default_camera(),
         cfg96s.replace(light_specular_power=3e5, light_diffuse_power=2e4), 0.5, True),
        ("cache overflow 96x32, 14 spheres", _crowd_scene(), default_camera(),
         cfg96s.replace(max_spheres=16), 0.5, True),
        ("full darkness 96x32", _dark_scene(), default_camera(), cfg96s.replace(max_planes=3), 0.5,
         True),
        ("random 24 400x150 posed camera shadows", random_scene(24, max_spheres=24, max_planes=4,
                                                                seed=7), posed,
         RenderConfig(width=400, height=150, max_spheres=24, shadows=True, **SOFT_KW), 0.5, False),
        ("empty 400x150 shadows", empty_scene(8, 2), default_camera(), base.replace(shadows=True),
         0.5, True),
    ]
    errs.update(K4=0.0, K5=0.0, K6=0.0)
    for label, scene, cam, cfg, tau, cull in shadow_cases:
        out, gates, cnt = _shadow_case(SK, SH, label, scene, cam, cfg, tau, dev, errs, cull=cull)
        if label.startswith("saturating") and not (out[:3] >= 254.5).any():
            raise AssertionError("the saturating light never clamps")
        if label.startswith("cache overflow") and not int(cnt[:, 0].max()) > SH.NC:
            raise AssertionError(f"no tile overflows the {SH.NC} cache slots")
        if label.startswith("full darkness"):
            dark = (SK.tile_view(out[SH.SO_VIS], 16, 16) <= SH.VIS_EARLY_OUT).all(dim=1)
            skipped = dark & (cnt[:, 1] < gates[:, 1].sum(dim=1))
            print(f"phase 2c: full darkness: {int(dark.sum())} dark tiles, the early-out skipped "
                  f"occluders in {int(skipped.sum())}")
            if not skipped.any():
                raise AssertionError("the all-dark early-out never fired")
        if label.startswith("empty") and (out[SK.SO_ALPHA] != 0).any():
            raise AssertionError("the empty scene must render all background")

    # the shadowed kernel path against the torch soft renderer on the card, at
    # bench.py's grad_cam_rot_rel config and loss (bench.py:366-388)
    from rtwc_tpu_torch.render import render_frame_soft

    cfg_g = RenderConfig(width=640, height=360, max_spheres=24, max_planes=4, shadows=True,
                         **SOFT_KW)
    grads = {}
    for which, render in (("kernel", render_frame_soft_kernel), ("oracle", render_frame_soft)):
        sc = random_scene(20, max_spheres=24, max_planes=4, seed=0, device=dev)
        leaves = {"sphere centers": sc.spheres.center, "sphere radii": sc.spheres.radius,
                  "sphere colours": sc.spheres.color, "plane centres": sc.planes.center,
                  "plane normals": sc.planes.normal}
        for t in leaves.values():
            t.requires_grad_(True)
        cam_g = Camera(pos=default_camera().pos.clone().to(dev).requires_grad_(True),
                       rot=default_camera().rot.clone().to(dev).requires_grad_(True))
        fb = render(sc, cam_g, cfg_g, tau=0.5)
        loss = torch.mean((fb.rgb / 255.0) ** 2) + 0.01 * torch.mean(fb.depth) / cfg_g.far
        loss.backward()
        grads[which] = {**{k: v.grad for k, v in leaves.items()}, "camera pos": cam_g.pos.grad,
                        "camera rot": cam_g.rot.grad}
    gk, go = grads["kernel"], grads["oracle"]
    a, b = gk["camera rot"].double(), go["camera rot"].double()
    rot_rel = ((a - b).abs().max() / torch.maximum(a.abs().max(), b.abs().max())).item()
    worst = 0.0
    for k in gk:
        a, b = gk[k].double().cpu(), go[k].double().cpu()
        if k != "camera rot":
            bad = (a - b).abs() > GRAD_ATOL + GRAD_RTOL * torch.maximum(a.abs(), b.abs())
            worst = max(worst, ((a - b).abs() / (b.abs() + 1e-12)).max().item())
            if bad.any():
                raise AssertionError(f"shadowed kernel path vs torch soft renderer: {k} gradients "
                                     f"{a[bad][:4].tolist()} vs {b[bad][:4].tolist()}")
    print(f"phase 2c: shadowed kernel path vs the torch soft renderer, 640x360 random_scene(20), "
          f"tau 0.5 (bench.py grad_cam_rot_rel): camera-rotation relative error {rot_rel!r} "
          f"(limit {ROT_REL}); 6 other leaf groups within rtol {GRAD_RTOL} / atol {GRAD_ATOL} "
          f"(largest relative diff {worst!r})")
    if not rot_rel <= ROT_REL:
        raise AssertionError(f"camera-rotation gradient {rot_rel} off the torch renderer's")
    # That torch renderer builds its rays and each sphere's c in the kernels'
    # op order (render/softmin.py), so the comparison above shares their
    # rounding. The arbiter shares none: the kernel path's rotation gradient
    # against a float64 render on independently built rays. At
    # grad_cam_rot_rel no float32 render comes within ROT_REL of float64, so
    # the kernel path must be no farther from it than the farthest of five
    # independent float32 renders; at a well conditioned config (400x150,
    # posed camera, shadows) it must come within ROT_REL of float64.
    arb_cases = (("640x360 random_scene(20) (grad_cam_rot_rel)",
                  random_scene(20, max_spheres=24, max_planes=4, seed=0, device=dev),
                  default_camera().to(dev), cfg_g, gk["camera rot"].double(), False),
                 ("400x150 default scene, posed camera", default_scene(base).to(dev),
                  posed.to(dev), base.replace(shadows=True), None, True))
    for label, sc, cam_a, cfg_a, g_k, strict in arb_cases:
        if g_k is None:
            g_k = _rot_grad_kernel(sc, cam_a, cfg_a)
        g64, family = _rot_grad_arbiter(sc, cam_a, cfg_a)
        scale = g64.abs().max()
        err_k = ((g_k - g64).abs().max() / scale).item()
        errs_f32 = [((g - g64).abs().max() / scale).item() for g in family]
        limit = ROT_REL if strict else max(errs_f32)
        print(f"phase 2c: camera-rotation gradient against float64, {label}: kernel path "
              f"{err_k!r} (limit {limit!r}); independent float32 renders {errs_f32!r}; "
              f"float64 {g64.tolist()!r}, kernel path {g_k.tolist()!r}")
        if not err_k <= limit:
            raise AssertionError(f"{label}: the kernel path's rotation gradient is {err_k} off "
                                 f"float64, beyond {limit}")

    lap("2c")

    # -- phase 3: the main path, counted ----------------------------------------
    hard_kernel.LAUNCHES = 0
    frames = 0

    def run_engine(rcfg, ecfg, n, scene=None, force_spawn=False):
        sink = FramebufferSink(keep_all=True)
        eng = Engine(rcfg, ecfg, scene=scene, presenter=sink, interactive=False, device=dev)
        if force_spawn:
            eng.telemetry.interval = 0.0
        eng.run(max_frames=n)
        if len(sink.frames) != n:
            raise AssertionError(f"{rcfg.width}x{rcfg.height}: {len(sink.frames)} frames of {n}")
        for fr in sink.frames:
            rows = fr.count(b"\n")
            if rows != rcfg.height:
                raise AssertionError(f"frame with {rows} rows, want {rcfg.height}")
            fam = (b";2;",) if rcfg.mode.value.startswith("rgb") else (b"\x1b[38;5;", b"\x1b[48;5;")
            if not any(f in fr for f in fam):
                raise AssertionError(f"{rcfg.mode.value}: no {fam} escape in a frame")
        return eng

    no_spawn = EngineConfig(spawn=False, show_fps=False, seed=1)
    for mode in (RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
                 RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS):
        run_engine(RenderConfig(width=400, height=150, mode=mode), no_spawn, 30)
        frames += 30
        print(f"phase 3: engine 400x150 {mode.value}: 30 frames, rows and escapes right")
    rcfg = RenderConfig(width=400, height=150, max_spheres=8)
    eng = Engine(rcfg, no_spawn, interactive=False, presenter=FramebufferSink(), device=dev)
    n0, cap0 = eng.scene.n_spheres, eng.scene.spheres.capacity
    eng = run_engine(rcfg, EngineConfig(spawn=True, show_fps=False, seed=1), 10,
                     force_spawn=True)
    frames += 10
    n1, cap1 = eng.scene.n_spheres, eng.scene.spheres.capacity
    print(f"phase 3: spawn: spheres {n0} -> {n1}, capacity {cap0} -> {cap1}")
    if not (n1 > n0 and cap1 > cap0):
        raise AssertionError("spawn did not grow the scene and its capacity")
    hi = RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII, supersample=2)
    run_engine(hi, no_spawn, 10, scene=random_scene(100, seed=0))
    frames += 10
    print("phase 3: engine 1920x500 rgb_ascii supersample 2, 100 spheres: 10 frames")
    launches = hard_kernel.LAUNCHES
    print(f"phase 3: K7 launches {launches}, frames rendered {frames}")
    if launches != frames:
        raise AssertionError(f"K7 launched {launches} times for {frames} frames")

    lap("3")

    # -- phase 3b: the train paths, counted -------------------------------------
    def reset_soft():
        for key in SK.LAUNCHES:
            SK.LAUNCHES[key] = 0

    # an in-process fit: K1 and K2 launch once per step
    cfg_s, scene_s = IR.build(192, 96, 3)
    stages_s = list(AnnealSchedule().configs(cfg_s))
    scene_s, cam_s = scene_s.to(dev), default_camera().to(dev)
    target_s, target_as = IR.make_target(scene_s, cam_s, stages_s[-1], False)
    noise = torch.from_numpy(np.random.default_rng(0).normal(0, 1.0, (4, 3)).astype(np.float32))
    noise[3] = 0.0
    center = (scene_s.spheres.center + noise.to(dev)).requires_grad_(True)
    fit_steps = 30
    reset_soft()
    IR.fit(lambda: (scene_s.replace(spheres=scene_s.spheres.replace(center=center)), cam_s),
           [center], stages_s, fit_steps, 3e-2, target_s, target_as, 1.0, False)
    torch.cuda.synchronize()
    counts = dict(SK.LAUNCHES)
    print(f"phase 3b: in-process fit 192x96, {fit_steps} steps: launches {counts}")
    if not (counts["soft_fwd"] == counts["soft_bwd"] == counts["soft_grad_reduce"] == fit_steps
            and counts["soft_mse"] == 0):
        raise AssertionError(f"K1 / K2 launches {counts} for {fit_steps} steps")

    # the generic train path at full size, through the user's entry point
    ir_json = os.path.join(OUT_DIR, "inverse_render_1080p.json")
    ir_steps = 10
    reset_soft()
    t = time.perf_counter()
    rc = IR.main(["--width", "1920", "--height", "1080", "--spheres", "20", "--steps",
                  str(ir_steps), "--json-out", ir_json])
    torch.cuda.synchronize()
    generic_launches = dict(SK.LAUNCHES)
    with open(ir_json) as f:
        rec = json.load(f)
    losses = [st["loss"] for st in rec["phase_a_stages"] + rec["phase_b_stages"]]
    print(f"phase 3b: inverse_render 1920x1080 --spheres 20 --steps {ir_steps}: exit {rc} "
          f"(sub-pixel {rec['sub_pixel']}; {ir_steps} steps do not converge), "
          f"{time.perf_counter() - t:.1f} s, stage losses {losses}; launches {generic_launches}")
    steps_taken = 2 * ir_steps
    if not (all(np.isfinite(losses)) and generic_launches["soft_bwd"] == steps_taken
            and generic_launches["soft_grad_reduce"] == steps_taken
            and generic_launches["soft_fwd"] == steps_taken + 1      # + the target render
            and generic_launches["soft_mse"] == 0 and rec["device"] == name):
        raise AssertionError(f"generic train path: launches {generic_launches}, losses {losses}")

    # the fused train path: K3 under autograd, Adam on the sphere centres
    from rtwc_tpu_torch.render import render_frame_soft_kernel, render_soft_mse_loss

    scene20d, cam20 = scene20.to(dev), default_camera().to(dev)
    with torch.no_grad():
        tgt20 = render_frame_soft_kernel(scene20d, cam20, cfg20, tau=0.5).rgb
    noise = torch.from_numpy(np.random.default_rng(1).normal(0, 0.5, (20, 3)).astype(np.float32))
    c20 = (scene20d.spheres.center + noise.to(dev)).requires_grad_(True)
    opt = torch.optim.Adam([c20], lr=1e-2)
    fused_losses = []
    reset_soft()
    for _ in range(10):
        loss = render_soft_mse_loss(scene20d.replace(spheres=scene20d.spheres.replace(center=c20)),
                                    cam20, tgt20, cfg20, tau=0.5)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        fused_losses.append(loss.item())
    fused_launches = dict(SK.LAUNCHES)
    print(f"phase 3b: fused MSE loop 1920x1080 --spheres 20, 10 steps: losses "
          f"{fused_losses[0]!r} -> {fused_losses[-1]!r}; launches {fused_launches}")
    if not (fused_launches["soft_mse"] == fused_launches["soft_grad_reduce"] == 10
            and fused_launches["soft_fwd"] == fused_launches["soft_bwd"] == 0
            and all(np.isfinite(fused_losses)) and fused_losses[-1] < fused_losses[0]):
        raise AssertionError(f"fused train path: launches {fused_launches}, losses {fused_losses}")

    # the entry point in subprocesses, to sub-pixel convergence
    for extra in ([], ["--quantized"]):
        cmd = [sys.executable, "-m", "rtwc_tpu_torch.examples.inverse_render", "--steps", "150",
               "--width", "192", "--height", "96", "--perturb", "1.0", *extra]
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        last = [ln for ln in proc.stdout.splitlines() if ln.startswith("phase")][-3:]
        print(f"phase 3b: {' '.join(cmd[1:])}: exit {proc.returncode} in "
              f"{time.perf_counter() - t:.1f} s: {' | '.join(last)}")
        if proc.returncode != 0:
            raise AssertionError(f"inverse_render {extra} did not converge: "
                                 f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")

    lap("3b")

    # -- phase 3c: the shadowed train path, counted -------------------------------
    scene_hld, cam_hl = scene_hl.to(dev), default_camera().to(dev)
    tgt_hl = torch.zeros((1080, 1920, 3), device=dev)  # bench.py's target
    steps_hl = 5

    def adam_loop(kind, n):
        c = scene_hld.spheres.center.clone().requires_grad_(True)
        opt = torch.optim.Adam([c], lr=1e-3)
        losses = []
        for _ in range(n):
            sc = scene_hld.replace(spheres=scene_hld.spheres.replace(center=c))
            if kind == "generic":
                rgb = render_frame_soft_kernel(sc, cam_hl, cfg_hl, tau=0.5).rgb
                loss = torch.mean(((rgb - tgt_hl) / 255.0) ** 2)
            else:
                loss = render_soft_mse_loss(sc, cam_hl, tgt_hl, cfg_hl, tau=0.5)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return losses

    reset_soft()
    gl = adam_loop("generic", steps_hl)
    fl = adam_loop("fused", steps_hl)
    diag = SH.soft_tile_diagnostics(scene_hld, cam_hl, cfg_hl, tau=0.5)
    torch.cuda.synchronize()
    hl_launches = dict(SK.LAUNCHES)
    print(f"phase 3c: bench headline 1920x1080 random_scene(20) shadows, {steps_hl} generic and "
          f"{steps_hl} fused steps and soft_tile_diagnostics: losses {gl[0]!r} -> {gl[-1]!r} "
          f"(generic), {fl[0]!r} -> {fl[-1]!r} (fused); launches {hl_launches}")
    want = dict(soft_fwd=0, soft_bwd=0, soft_mse=0, soft_sh_fwd=steps_hl, soft_sh_bwd=steps_hl,
                soft_sh_mse=steps_hl, soft_sh_stats=1, soft_grad_reduce=2 * steps_hl)
    if hl_launches != want or not all(np.isfinite(gl + fl)) or abs(gl[0] - fl[0]) > 1e-5 * gl[0]:
        raise AssertionError(f"shadowed train path: launches {hl_launches} (want {want}), "
                             f"losses {gl}, {fl}")
    print(f"phase 3c: soft_tile_diagnostics: {len(diag['list_len'])} tiles, culled-in objects "
          f"per tile max {int(diag['main_applied'].max())}, applied occluders max "
          f"{int(diag['shadow_applied'].max())}, list length max {int(diag['list_len'].max())}, "
          f"shadow list length max {int(diag['shadow_list_len'].max())}")

    reset_soft()
    t = time.perf_counter()
    rc = FS.main([])
    torch.cuda.synchronize()
    fit_launches = dict(SK.LAUNCHES)
    print(f"phase 3c: fit_from_shadow in process at its defaults (320x96, 300 steps): exit {rc} "
          f"in {time.perf_counter() - t:.1f} s; launches {fit_launches}")
    want = dict(soft_fwd=2, soft_bwd=0, soft_mse=0, soft_sh_fwd=302, soft_sh_bwd=300,
                soft_sh_mse=0, soft_sh_stats=0, soft_grad_reduce=300)
    if rc != 0 or fit_launches != want:
        raise AssertionError(f"fit_from_shadow: exit {rc}, launches {fit_launches} (want {want})")
    cmd = [sys.executable, "-m", "rtwc_tpu_torch.examples.fit_from_shadow"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-3:]
    print(f"phase 3c: {' '.join(cmd[1:])}: exit {proc.returncode} in "
          f"{time.perf_counter() - t:.1f} s: {' | '.join(tail)}")
    if proc.returncode != 0 or not tail or tail[-1] != "FIT OK":
        raise AssertionError(f"fit_from_shadow failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")

    lap("3c")

    # -- phase 4 -----------------------------------------------------------------
    cmd = [sys.executable, "-m", "rtwc_tpu_torch", "--frames", "8", "--width", "400",
           "--height", "150", "--mode", "rgb_ascii", "--no-spawn", "--no-fps"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, timeout=300)
    print(f"phase 4: {' '.join(cmd[1:])}: exit {proc.returncode}, "
          f"{len(proc.stdout)} bytes of frames")
    if proc.returncode != 0 or b";2;" not in proc.stdout:
        raise AssertionError(f"CLI run failed: {proc.stderr.decode()[-2000:]}")

    lap("4")

    # -- phase 5 -----------------------------------------------------------------
    tag = f"[{card}]"
    timing = {}
    for label in ("a default 400x150", "c random 20 1920x1080 shadows",
                  "d random 200 3840x2160 shadows"):
        args, cfg = packed[label]
        k_ms = _time_ms(lambda: hard_kernel.hard_render_packed(*args, config=cfg, bh=bh, bw=bw))
        p_ms = _time_ms(lambda: hard_kernel.hard_render_plain(*args, config=cfg, bh=bh, bw=bw))
        sph, _, _, camv, _ = args
        b_ms = _time_ms(lambda: hard_kernel.tile_lists(sph, camv, cfg, bh, bw))
        dev_ms = _kernel_device_ms(lambda: hard_kernel.hard_render_packed(
            *args, config=cfg, bh=bh, bw=bw))
        timing[label] = (k_ms, p_ms, b_ms, dev_ms)
        print(f"phase 5: {label}: K7 kernel {k_ms!r} ms (device time alone {dev_ms!r} ms), "
              f"plain {p_ms!r} ms, broad phase {b_ms!r} ms {tag}")

    def engine_rate(rcfg, scene, n=60, warm=5):
        eng = Engine(rcfg, no_spawn, scene=scene, presenter=FramebufferSink(),
                     interactive=False, device=dev)
        eng.start()
        for _ in range(warm):
            eng.run_frame()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            eng.run_frame()
        eng.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        eng.cleanup()
        fps = n / dt
        return fps, fps * rcfg.width * rcfg.height * rcfg.supersample ** 2

    rates = {}
    for label, rcfg, scene in (
            ("400x150 default scene rgb_ascii",
             RenderConfig(width=400, height=150, mode=RenderMode.RGB_ASCII), None),
            ("1920x500 100 spheres rgb_ascii",
             RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII),
             random_scene(100, seed=0)),
            ("1920x500 100 spheres rgb_ascii supersample 2", hi, random_scene(100, seed=0))):
        fps, rps = engine_rate(rcfg, scene)
        rates[label] = (fps, rps)
        print(f"phase 5: engine {label}: {fps!r} frames/s, {rps!r} rays/s {tag}")

    # per-frame host breakdown: enqueue of the device step, wait for the
    # frame's cells, encode
    for label, rcfg, scene_fn in (
            ("400x150", RenderConfig(width=400, height=150, mode=RenderMode.RGB_ASCII),
             lambda: default_scene(RenderConfig(), device=dev)),
            ("1920x500", RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII),
             lambda: random_scene(100, seed=0, device=dev))):
        scene, cam = scene_fn(), default_camera()
        parts = {"enqueue": [], "wait": [], "encode": []}
        prev = None
        for i in range(45):
            t0 = time.perf_counter()
            scene, cells = _render_step(scene, cam, 0.016, rcfg)
            cur = _start_download(cells)
            t1 = time.perf_counter()
            if prev is not None:
                prev[1].synchronize()
                t2 = time.perf_counter()
                encode_frame(*(c.numpy() for c in prev[0]))
                t3 = time.perf_counter()
                if i >= 5:
                    parts["enqueue"].append(t1 - t0)
                    parts["wait"].append(t2 - t1)
                    parts["encode"].append(t3 - t2)
            prev = cur
        med = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
        print(f"phase 5: frame breakdown {label}: host enqueue {med['enqueue']!r} ms, "
              f"wait for cells {med['wait']!r} ms, encode {med['encode']!r} ms {tag}")

    # device busy share over a steady window of engine frames
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, rcfg, scene in (("400x150", RenderConfig(width=400, height=150,
                                                          mode=RenderMode.RGB_ASCII), None),
                               ("1920x500", RenderConfig(width=1920, height=500,
                                                         mode=RenderMode.RGB_ASCII),
                                random_scene(100, seed=0))):
        eng = Engine(rcfg, no_spawn, scene=scene, presenter=FramebufferSink(),
                     interactive=False, device=dev)
        eng.start()
        for _ in range(5):
            eng.run_frame()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                eng.run_frame()
            eng.flush()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
        eng.cleanup()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kern)
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
        with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=60))
            f.write("\n".join(f"{us / 20:10.1f} us/frame  {n}" for n, us in top))
        print(f"phase 5: profile {label}, 20 frames: {len(kern)} kernel records, device busy "
              f"{busy_us / wall_us!r} of {wall_us / 20 / 1e3!r} ms per frame "
              f"(profiler on) {tag}")
        print("phase 5: top device time: " + "; ".join(
            f"{n[:48]} {us / 20:.1f} us/frame" for n, us in top[:6]))

    # the soft kernels and the train steps at 1920x1080, 20 spheres, tau 0.5
    spec = SK.SoftSpec(cfg20, 0.5)
    sph, pl, camv = SK._packed(scene20d, cam20)
    lists = SK.build_lists(sph, camv, spec, True)
    offsets, pidx = SK.list_entries(lists)
    n = pidx.shape[0]
    Hp, Wp = spec.extent
    out, gates = SK.soft_fwd(sph, pl, camv, lists, spec=spec)
    tgt = torch.zeros((3, Hp, Wp), device=dev)
    tgt[:, :1080, :1920] = tgt20.permute(2, 0, 1)
    g_mse = torch.zeros_like(out)
    g_mse[:3] = (2.0 / (255.0 ** 2 * 3 * 1920 * 1080)) * (out[:3] - tgt)
    parts = SK.soft_bwd(sph, pl, camv, lists, offsets, gates, out, g_mse, spec=spec, n_entries=n)
    soft_calls = {
        "K1": ("soft_fwd_kernel", lambda: SK.soft_fwd(sph, pl, camv, lists, spec=spec),
               lambda: SK.soft_fwd_plain(sph, pl, camv, lists, spec=spec)),
        "K2": ("soft_bwd_kernel",
               lambda: SK.soft_bwd(sph, pl, camv, lists, offsets, gates, out, g_mse, spec=spec,
                                   n_entries=n),
               lambda: SK.soft_bwd_plain(sph, pl, camv, lists, offsets, gates, out, g_mse,
                                         spec=spec, n_entries=n)),
        "K3": ("soft_mse_kernel",
               lambda: SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec, n_entries=n),
               lambda: SK.soft_mse_plain(sph, pl, camv, lists, offsets, tgt, spec=spec,
                                         n_entries=n)),
        "reduce": ("soft_grad_reduce_kernel",
                   lambda: SK.soft_grad_reduce(parts[0], pidx, *parts[1:], sph.shape[1]),
                   lambda: SK.soft_grad_reduce_plain(parts[0][:n], pidx, *parts[1:],
                                                     sph.shape[1])),
    }
    soft_timing = {}
    for key, (kname, kfn, pfn) in soft_calls.items():
        k_ms = _time_ms(kfn)
        p_ms = _time_ms(pfn, reps=5, warm=1)
        d_ms = _kernel_device_ms(kfn, name=kname)
        soft_timing[key] = (k_ms, p_ms, d_ms)
        print(f"phase 5: {key} ({kname}) 1920x1080 --spheres 20 tau 0.5: {k_ms!r} ms a call "
              f"(device time alone {d_ms!r} ms), plain {p_ms!r} ms; {n} list entries {tag}")

    PlainRender, PlainMSE = _plain_autograd(SK)
    rays = 1920 * 1080

    def make_step(kind):
        c = scene20d.spheres.center.clone().requires_grad_(True)
        opt = torch.optim.Adam([c], lr=1e-3)

        def step():
            sc = scene20d.replace(spheres=scene20d.spheres.replace(center=c))
            if kind.startswith("generic"):
                if kind.endswith("plain"):
                    o = PlainRender.apply(*SK._packed(sc, cam20), spec)
                    rgb = o[:3, :1080, :1920].permute(1, 2, 0)
                else:
                    rgb = render_frame_soft_kernel(sc, cam20, cfg20, tau=0.5).rgb
                loss = torch.mean(((rgb - tgt20) / 255.0) ** 2)
            elif kind.endswith("plain"):
                loss = PlainMSE.apply(*SK._packed(sc, cam20), tgt, spec)
            else:
                loss = render_soft_mse_loss(sc, cam20, tgt20, cfg20, tau=0.5)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return step

    step_rates = {}
    for kind, reps in (("generic plain", 3), ("generic", 20), ("fused", 20), ("fused plain", 3),
                       ("generic", 20), ("fused", 20)):
        ms = _step_ms(make_step(kind), reps)
        step_rates.setdefault(kind, []).append(ms)
        print(f"phase 5: {kind} train step 1920x1080 --spheres 20 tau 0.5 (fwd + bwd + Adam): "
              f"{ms!r} ms, {rays / ms * 1e3!r} rays/s {tag}")

    for kind in ("generic", "fused"):
        _profile_steps(make_step(kind), f"profile_train_{kind}", f"{kind} train step", tag)

    lap("5")

    # -- phase 5b: the shadowed kernels and train steps ---------------------------
    spec_hl = SK.SoftSpec(cfg_hl, 0.5)
    sph_h, pl_h, cam_h = SK._packed(scene_hld, cam_hl)
    lists_h, shl_h = SH.build_lists(sph_h, pl_h, cam_h, spec_hl, True)
    offsets_h, pidx_h = SK.list_entries(lists_h)
    sh_offsets_h, pshidx_h = SK.list_entries(shl_h)
    sizes_h = dict(n_entries=pidx_h.shape[0], n_sh_entries=pshidx_h.shape[0])
    Hp, Wp = spec_hl.extent
    out_h, gates_h, cnt_h = SH.soft_sh_stats(sph_h, pl_h, cam_h, lists_h, shl_h, spec=spec_hl)
    tgt_h = torch.zeros((3, Hp, Wp), device=dev)
    g_h = torch.zeros_like(out_h)
    g_h[:3] = (2.0 / (255.0 ** 2 * 3 * 1920 * 1080)) * (out_h[:3] - tgt_h)
    bwd_h = (sph_h, pl_h, cam_h, lists_h, shl_h, offsets_h, sh_offsets_h, gates_h, out_h, g_h)
    mse_h = (sph_h, pl_h, cam_h, lists_h, shl_h, offsets_h, sh_offsets_h, tgt_h)
    parts_h = SH.soft_sh_bwd(*bwd_h, spec=spec_hl, **sizes_h)
    n_h, nsh_h = pidx_h.shape[0], pshidx_h.shape[0]
    fwd4 = (sph_h, pl_h, cam_h, lists_h, shl_h)
    sh_calls = {
        "K4": ("soft_sh_fwd_kernel", lambda: SH.soft_sh_fwd(*fwd4, spec=spec_hl),
               lambda: SH.soft_sh_fwd_plain(*fwd4, spec=spec_hl)),
        "K4-stats": ("soft_sh_fwd_kernel", lambda: SH.soft_sh_stats(*fwd4, spec=spec_hl),
                     lambda: SH.soft_sh_stats_plain(*fwd4, spec=spec_hl)),
        "K5": ("soft_sh_bwd_kernel", lambda: SH.soft_sh_bwd(*bwd_h, spec=spec_hl, **sizes_h),
               lambda: SH.soft_sh_bwd_plain(*bwd_h, spec=spec_hl, **sizes_h)),
        "K6": ("soft_sh_mse_kernel", lambda: SH.soft_sh_mse(*mse_h, spec=spec_hl, **sizes_h),
               lambda: SH.soft_sh_mse_plain(*mse_h, spec=spec_hl, **sizes_h)),
        "reduce sh": ("soft_grad_reduce_kernel",
                      lambda: SK.soft_grad_reduce(parts_h[0], pidx_h, parts_h[2], parts_h[3], 20,
                                                  psh=parts_h[1], pshidx=pshidx_h),
                      lambda: SK.soft_grad_reduce_plain(parts_h[0][:n_h], pidx_h, parts_h[2],
                                                        parts_h[3], 20, parts_h[1][:nsh_h],
                                                        pshidx_h)),
    }
    for key, (kname, kfn, pfn) in sh_calls.items():
        k_ms = _time_ms(kfn)
        p_ms = _time_ms(pfn, reps=1, warm=0)  # the plain versions are timed once
        d_ms = _kernel_device_ms(kfn, name=kname)
        soft_timing[key] = (k_ms, p_ms, d_ms)
        print(f"phase 5b: {key} ({kname}) bench headline 1920x1080 random_scene(20) shadows tau "
              f"0.5: {k_ms!r} ms a call (device time alone {d_ms!r} ms), plain {p_ms!r} ms; "
              f"{n_h} list entries, {nsh_h} shadow entries {tag}")
    print(f"phase 5b: bench headline: cache-fallback share of tiles {float((cnt_h[:, 0] > SH.NC).float().mean())!r} "
          f"(culled-in objects per tile max {int(cnt_h[:, 0].max())}, NC {SH.NC})")

    def sh_step(kind, scene, cam, cfg, tgt):
        c = scene.spheres.center.clone().requires_grad_(True)
        opt = torch.optim.Adam([c], lr=1e-3)

        def step():
            sc = scene.replace(spheres=scene.spheres.replace(center=c))
            if kind == "generic":
                rgb = render_frame_soft_kernel(sc, cam, cfg, tau=0.5).rgb
                loss = torch.mean(((rgb - tgt) / 255.0) ** 2)
            else:
                loss = render_soft_mse_loss(sc, cam, tgt, cfg, tau=0.5)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        return step

    sh_rates = {}
    for kind in ("generic", "fused", "generic", "fused"):
        ms = _step_ms(sh_step(kind, scene_hld, cam_hl, cfg_hl, tgt_hl), 20)
        sh_rates.setdefault(kind, []).append(ms)
        print(f"phase 5b: shadowed {kind} train step, bench headline 1920x1080 random_scene(20) "
              f"tau 0.5 (fwd + bwd + Adam): {ms!r} ms, {rays / ms * 1e3!r} rays/s {tag}")
    for kind in ("generic", "fused"):
        _profile_steps(sh_step(kind, scene_hld, cam_hl, cfg_hl, tgt_hl),
                       f"profile_train_shadowed_{kind}", f"shadowed {kind} train step", tag)

    # 4K with 200 spheres: the fused step, its peak memory, the cache demand
    cfg_4k = RenderConfig(width=3840, height=2160, max_spheres=200, max_planes=4, shadows=True,
                          **SOFT_KW)
    scene_4k = random_scene(200, max_spheres=200, max_planes=4, seed=0, device=dev)
    tgt_4k = torch.zeros((2160, 3840, 3), device=dev)
    step_4k = sh_step("fused", scene_4k, cam_hl, cfg_4k, tgt_4k)
    step_4k()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    step_4k()
    torch.cuda.synchronize()
    peak_4k = torch.cuda.max_memory_allocated(dev)
    ms_4k = _step_ms(step_4k, 5)
    spec_4k = SK.SoftSpec(cfg_4k, 0.5)
    sph_4, pl_4, cam_4 = SK._packed(scene_4k, cam_hl)
    lists_4, shl_4 = SH.build_lists(sph_4, pl_4, cam_4, spec_4k, True)
    _, _, cnt_4 = SH.soft_sh_stats(sph_4, pl_4, cam_4, lists_4, shl_4, spec=spec_4k)
    offsets_4, pidx_4 = SK.list_entries(lists_4)
    sh_offsets_4, pshidx_4 = SK.list_entries(shl_4)
    sizes_4 = dict(n_entries=pidx_4.shape[0], n_sh_entries=pshidx_4.shape[0])
    out_4, gates_4 = SH.soft_sh_fwd(sph_4, pl_4, cam_4, lists_4, shl_4, spec=spec_4k)
    k4_4k = _kernel_device_ms(lambda: SH.soft_sh_fwd(sph_4, pl_4, cam_4, lists_4, shl_4,
                                                     spec=spec_4k), reps=5,
                              name="soft_sh_fwd_kernel")
    k5_4k = _kernel_device_ms(lambda: SH.soft_sh_bwd(
        sph_4, pl_4, cam_4, lists_4, shl_4, offsets_4, sh_offsets_4, gates_4, out_4,
        torch.zeros_like(out_4), spec=spec_4k, **sizes_4), reps=5, name="soft_sh_bwd_kernel")
    k6_4k = _kernel_device_ms(lambda: SH.soft_sh_mse(
        sph_4, pl_4, cam_4, lists_4, shl_4, offsets_4, sh_offsets_4,
        torch.zeros((3,) + spec_4k.extent, device=dev), spec=spec_4k, **sizes_4), reps=5,
        name="soft_sh_mse_kernel")
    ms_4k_generic = _step_ms(sh_step("generic", scene_4k, cam_hl, cfg_4k, tgt_4k), 5)
    print(f"phase 5b: shadowed generic train step 3840x2160 random_scene(200): "
          f"{ms_4k_generic!r} ms, {3840 * 2160 / ms_4k_generic * 1e3!r} rays/s; device time K4 "
          f"{k4_4k!r} ms, K5 {k5_4k!r} ms {tag}")
    print(f"phase 5b: shadowed fused train step 3840x2160 random_scene(200): {ms_4k!r} ms, "
          f"{3840 * 2160 / ms_4k * 1e3!r} rays/s; K6 device time {k6_4k!r} ms; peak memory "
          f"{peak_4k / 2**20:.1f} MiB ({(peak_4k - base_mem) / 2**20:.1f} MiB above the "
          f"{base_mem / 2**20:.1f} MiB held before the step); cache-fallback share of tiles "
          f"{float((cnt_4[:, 0] > SH.NC).float().mean())!r} (culled-in per tile max "
          f"{int(cnt_4[:, 0].max())}); list entries {pidx_4.shape[0]}, shadow entries "
          f"{pshidx_4.shape[0]} {tag}")

    lap("5b")

    # -- phases 6a-6d: the roofline path ---------------------------------------------
    cal = _phase_6ab(dev, tag)
    lap("6a-6b")
    u_diag = {"list_len": lists[:, 0, 0].cpu().numpy(),
              "main_applied": gates[:, 0, :].sum(1).cpu().numpy(),
              "shadow_list_len": np.zeros(lists.shape[0]), "shadow_applied": np.zeros(lists.shape[0]),
              "bh": 16, "bw": 16, "n_planes": int(camv[0, P.C_NPL])}
    diag_4k = SH.soft_tile_diagnostics(scene_4k, cam_hl, cfg_4k, tau=0.5)
    floors = _phase_6c(
        [("1920x1080 --spheres 20", cfg20, u_diag,
          {"K1": soft_timing["K1"][2], "K2": soft_timing["K2"][2], "K3": soft_timing["K3"][2]}),
         ("bench headline", cfg_hl, diag,
          {"K4": soft_timing["K4"][2], "K5": soft_timing["K5"][2], "K6": soft_timing["K6"][2]}),
         ("3840x2160 random_scene(200)", cfg_4k, diag_4k, {"K4": k4_4k, "K5": k5_4k, "K6": k6_4k})],
        cal["calibration"], tag)
    lap("6c")
    bench_res = _phase_6d(tag)
    lap("6d")

    # -- the kernels line: every kernel with its bound ---------------------------
    px = 16 * 16
    args_c, cfg_c = packed["c random 20 1920x1080 shadows"]
    sph_c, pl_c, counts_c, cam_c, lists_c = args_c
    n_obj = int(counts_c.sum())
    hard_ops = px * float((OPS["raygen"] + lists_c[:, 0, 0].double() * OPS["hard_sphere"]
                           + int(counts_c[0, 1]) * OPS["hard_plane"] + OPS["hard_shade"]
                           + n_obj * OPS["hard_shadow"]).sum())
    hard_out = hard_kernel.hard_render_packed(*args_c, config=cfg_c, bh=bh, bw=bw)
    w20 = _soft_work(lists, gates, int(camv[0, P.C_NPL]), px)
    wsh = _soft_work(lists_h, gates_h, int(cam_h[0, P.C_NPL]), px, shl_h, cnt_h, SH.NC)
    red20 = soft_calls["reduce"][1]()
    red_h = sh_calls["reduce sh"][1]()
    k3_parts = SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec, n_entries=n)
    k6_parts = SH.soft_sh_mse(*mse_h, spec=spec_hl, **sizes_h)
    ins_h = (sph_h, pl_h, cam_h, lists_h, shl_h)
    # key: (bytes read once + written once, float32 operations). Only the
    # planes a kernel loads count: K1 writes gate row 0; K2 reads gate row 0,
    # the saved planes but alpha (0-6, m, s) and the cotangents of rgb,
    # depth, normal and alpha (0-7); K5 reads both gate rows, the saved
    # planes but alpha (0-6, 8-13) and the same eight cotangent planes.
    work = {
        "K7": (_nbytes(*args_c, hard_out), hard_ops),
        "K1": (_nbytes(sph, pl, camv, lists, out, gates[:, 0]), w20["fwd"]),
        "K2": (_nbytes(sph, pl, camv, lists, offsets, gates[:, 0], out[:7], out[8:10],
                       g_mse[:8], *parts), w20["bwd"]),
        "K3": (_nbytes(sph, pl, camv, lists, offsets, tgt, *k3_parts),
               w20["fwd"] + w20["bwd"] + px * OPS["loss"] * lists.shape[0]),
        "reduce": (_nbytes(*parts, pidx, *red20), 8.0 * float(parts[0].numel())),
        "K4": (_nbytes(*ins_h, out_h, gates_h), wsh["sh_fwd"]),
        "K4-stats": (_nbytes(*ins_h, out_h, gates_h, cnt_h), wsh["sh_fwd"]),
        "K5": (_nbytes(*bwd_h[:8], out_h[:7], out_h[8:], g_h[:8], *parts_h), wsh["sh_bwd"]),
        "K6": (_nbytes(*mse_h, *k6_parts), wsh["sh_fwd"] + wsh["sh_bwd"]
               + px * OPS["loss"] * lists_h.shape[0]),
        "reduce sh": (_nbytes(*parts_h, pidx_h, pshidx_h, *red_h),
                      8.0 * float(parts_h[0].numel() + parts_h[1].numel())),
    }
    soft_timing["K7"] = (timing["c random 20 1920x1080 shadows"][0],
                         timing["c random 20 1920x1080 shadows"][1],
                         timing["c random 20 1920x1080 shadows"][3])
    errs["K7"], errs["K4-stats"], errs["reduce sh"] = max_err, errs["K4"], errs["reduce"]
    shape_20 = "1920x1080, --spheres 20 layout + 1 plane, tau 0.5, unshadowed, 16x16 tiles"
    shape_hl = "1920x1080, random_scene(20, max_spheres=20, max_planes=4), shadows, tau 0.5, 16x16 tiles"
    sh_launch = {k: hl_launches[k] + fit_launches[k] for k in hl_launches}
    rows = (
        ("K7", "hard_render (K7, hard display forward)", "hard_render.cu",
         "rtwc_tpu/render/pallas_kernel.py:290", launches,
         "1920x1080, random_scene(20), shadows, 16x16 tiles"),
        ("K1", "soft_fwd (K1, soft forward, unshadowed)", "soft_render.cu",
         "rtwc_tpu/render/pallas_soft.py:2434", generic_launches["soft_fwd"], shape_20),
        ("K2", "soft_bwd (K2, soft backward, unshadowed)", "soft_render.cu",
         "rtwc_tpu/render/pallas_soft.py:2476", generic_launches["soft_bwd"], shape_20),
        ("K3", "soft_mse (K3, fused MSE step, unshadowed)", "soft_render.cu",
         "rtwc_tpu/render/pallas_soft.py:2526", fused_launches["soft_mse"], shape_20),
        ("reduce", "soft_grad_reduce (D3, deterministic two-float cross-block reduction)",
         "soft_render.cu", "tests/test_pallas_soft.py:283",
         generic_launches["soft_grad_reduce"] + fused_launches["soft_grad_reduce"]
         + sh_launch["soft_grad_reduce"], shape_20 + "; shadowed: see reduce_shadowed"),
        ("K4", "soft_sh_fwd (K4, soft forward, shadowed)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2434", sh_launch["soft_sh_fwd"], shape_hl),
        ("K5", "soft_sh_bwd (K5, soft backward, shadowed)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2476", sh_launch["soft_sh_bwd"], shape_hl),
        ("K6", "soft_sh_mse (K6, fused MSE step, shadowed)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2526", sh_launch["soft_sh_mse"], shape_hl),
        ("K4-stats", "soft_sh_stats (K4-stats, cache diagnostics)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2822", sh_launch["soft_sh_stats"], shape_hl),
    )
    # the reduction's whole function in PyTorch library calls on the same
    # inputs, held to the kernel's sums before it is timed
    lib_reduce = _reduce_library_ms(P, (parts[0], pidx, *parts[1:], sph.shape[1]), red20)
    lib_reduce_sh = _reduce_library_ms(
        P, (parts_h[0], pidx_h, parts_h[2], parts_h[3], 20, parts_h[1], pshidx_h), red_h)
    entries = []
    for key, kname, src, replaces, count, shape in rows:
        k_ms, p_ms, d_ms = soft_timing[key]
        b_ms, b_by = _bound(*work[key])
        floor_key = "K4" if key == "K4-stats" else key
        entry = {"name": kname, "route": "cuda", "source": f"rtwc_tpu_torch/csrc/{src}",
                 "replaces": replaces, "launches": count, "max_abs_err": errs[key], "ms": k_ms,
                 "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_reduce if key == "reduce" else None,
                 "floor_ms": floors.get(floor_key), "device_ms": d_ms, "shape": shape}
        if key == "reduce":
            r_ms, r_p, r_d = soft_timing["reduce sh"]
            rb_ms, rb_by = _bound(*work["reduce sh"])
            entry["reduce_shadowed"] = {"ms": r_ms, "plain_ms": r_p, "device_ms": r_d,
                                        "bound_ms": rb_ms, "bound_by": rb_by,
                                        "library_ms": lib_reduce_sh, "shape": shape_hl}
            entry["library"] = ("float64 index_add_ of the sphere (and shadow-occluder) "
                                "partials, sums of the plane rows and camera pairs over tiles")
        entries.append(entry)
        print(f"phase 5b: {key}: bound {b_ms!r} ms ({b_by}; {work[key][0] / 1e6:.1f} MB, "
              f"{work[key][1] / 1e9:.2f} GFLOP), calibrated floor {entry['floor_ms']!r} ms, "
              f"device {d_ms!r} ms, launches {count}, library {entry['library_ms']!r} ms")
    entries.append(cal["entry"])
    for e in entries:
        if e["launches"] < 1:
            raise AssertionError(f"{e['name']} was not launched on its path")
    with open(os.path.join(OUT_DIR, "train_steps.json"), "w") as f:
        json.dump({"unshadowed": step_rates, "shadowed": sh_rates, "shadowed_4k_fused_ms": ms_4k,
                   "shadowed_4k_generic_ms": ms_4k_generic, "shadowed_4k_peak_bytes": peak_4k,
                   "calibration": cal["calibration"], "floors_ms": floors, "bench": bench_res},
                  f)
    print(f"phase times (s): {json.dumps(laps)}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
