#!/usr/bin/env python3
"""Run the PyTorch port's display and train paths on one CUDA card and check them.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases (each prints its lines; any failure raises and exits non-zero):
  0  card name and power limit (nvidia-smi), torch and CUDA versions
  1  build csrc/hard_render.cu and csrc/soft_render.cu with nvcc for
     sm_90a, both at once; print build times and each kernel's ptxas
     registers and spills
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
  4  `python -m rtwc_tpu_torch` in a subprocess
  5  timings (CUDA events, host clock, profiler): K7 vs plain, broad phase,
     engine frames/s and rays/s, a per-frame host breakdown; K1, K2, K3 and
     the reduction vs plain at 1920x1080 with 20 spheres, the generic and
     fused train steps vs the same steps on the plain versions, and the
     device's busy share over 20 steps
Then a JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}. Imports nothing of JAX. TF32 is off.
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


def _kernel_device_ms(fn, reps=20, name="hard_render_kernel"):
    """Mean device time of the kernel `name` over `reps` calls of fn, from
    the profiler's CUDA kernel records (None if it records none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and e.name.startswith(name)]
    return sum(us) / len(us) / 1e3 if us else None


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)

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
    from rtwc_tpu_torch.render import soft_kernel as SK

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc for each source, at once
        libs = dict(zip(("hard_render", "soft_render"),
                        pool.map(_cuda.build, ("hard_render", "soft_render"))))
    hard_kernel._kernel_fn()
    for fn_name in ("rtwc_soft_fwd", "rtwc_soft_bwd", "rtwc_soft_mse", "rtwc_soft_grad_reduce"):
        SK._fn(fn_name)
    print(f"phase 1: built {', '.join(os.path.relpath(v, ROOT) for v in libs.values())} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{k} {_cuda.build_seconds[k]:.2f} s" for k in libs)
          + f"; {' '.join(_cuda.ARCH_FLAGS)})")
    for lib, so in libs.items():
        for kernel, regs, spill in _ptxas_report(so[:-3] + ".log"):
            print(f"phase 1: ptxas {lib}: {kernel}: {regs} registers; {spill}")

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

    # -- phase 4 -----------------------------------------------------------------
    cmd = [sys.executable, "-m", "rtwc_tpu_torch", "--frames", "8", "--width", "400",
           "--height", "150", "--mode", "rgb_ascii", "--no-spawn", "--no-fps"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, timeout=300)
    print(f"phase 4: {' '.join(cmd[1:])}: exit {proc.returncode}, "
          f"{len(proc.stdout)} bytes of frames")
    if proc.returncode != 0 or b";2;" not in proc.stdout:
        raise AssertionError(f"CLI run failed: {proc.stderr.decode()[-2000:]}")

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
        step = make_step(kind)
        step()
        step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / reps * 1e3
        step_rates.setdefault(kind, []).append(ms)
        print(f"phase 5: {kind} train step 1920x1080 --spheres 20 tau 0.5 (fwd + bwd + Adam): "
              f"{ms!r} ms, {rays / ms * 1e3!r} rays/s {tag}")

    for kind in ("generic", "fused"):
        step = make_step(kind)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                step()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kern)
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
        with open(os.path.join(OUT_DIR, f"profile_train_{kind}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=60))
            f.write("\n".join(f"{us / 20:10.1f} us/step  {nm}" for nm, us in top))
        print(f"phase 5: profile {kind} train step, 20 steps: device busy {busy_us / wall_us!r} "
              f"of {wall_us / 20 / 1e3!r} ms per step (profiler on) {tag}")
        print("phase 5: top device time: " + "; ".join(
            f"{nm[:40]} {us / 20:.1f} us/step" for nm, us in top[:6]))

    kc, pc, _, kdev = timing["c random 20 1920x1080 shadows"]
    soft_shape = "1920x1080, --spheres 20 layout + 1 plane, tau 0.5, unshadowed, 16x16 tiles"
    entries = [{
        "name": "hard_render (K7, hard display forward)",
        "route": "cuda",
        "source": "rtwc_tpu_torch/csrc/hard_render.cu",
        "replaces": "rtwc_tpu/render/pallas_kernel.py:290",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kc,
        "plain_ms": pc,
        "device_ms": kdev,
        "shape": "1920x1080, random_scene(20), shadows, 16x16 tiles",
    }]
    for key, kname, replaces, count in (
            ("K1", "soft_fwd (K1, soft forward, unshadowed)", "rtwc_tpu/render/pallas_soft.py:2434",
             generic_launches["soft_fwd"]),
            ("K2", "soft_bwd (K2, soft backward, unshadowed)", "rtwc_tpu/render/pallas_soft.py:2476",
             generic_launches["soft_bwd"]),
            ("K3", "soft_mse (K3, fused MSE step, unshadowed)",
             "rtwc_tpu/render/pallas_soft.py:2526", fused_launches["soft_mse"]),
            ("reduce", "soft_grad_reduce (D3, deterministic two-float cross-block reduction)",
             "tests/test_pallas_soft.py:283",
             generic_launches["soft_grad_reduce"] + fused_launches["soft_grad_reduce"])):
        k_ms, p_ms, d_ms = soft_timing[key]
        entries.append({"name": kname, "route": "cuda", "source": "rtwc_tpu_torch/csrc/soft_render.cu",
                        "replaces": replaces, "launches": count, "max_abs_err": errs[key],
                        "ms": k_ms, "plain_ms": p_ms, "device_ms": d_ms, "shape": soft_shape})
    with open(os.path.join(OUT_DIR, "train_steps.json"), "w") as f:
        json.dump({k: v for k, v in step_rates.items()}, f)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
