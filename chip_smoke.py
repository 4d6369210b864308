#!/usr/bin/env python3
"""Run the PyTorch port's display, train and roofline paths on one CUDA card and check them.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases (each prints its lines; any failure raises and exits non-zero):
  0  card name and power limit (nvidia-smi), torch and CUDA versions
  1  build csrc/hard_render.cu, csrc/soft_render.cu, csrc/soft_shadow.cu,
     csrc/calibrate.cu, csrc/broad_phase.cu, csrc/ansi_encode.cu and
     csrc/cell_heads.cu with nvcc for sm_90a, one nvcc each, all at once;
     print build times and each kernel's ptxas registers and spills
  2  the K7 kernel against its plain torch version on the card, on the
     same packed tables and broad-phase lists: planes bit-equal
     (torch.equal) and framebuffers within tolerance, in ten cases (the
     engine's 1920x500 at 2x supersampling, 3840x1000 with 100 spheres,
     and 720 planes, whose table takes K7's shared memory past 48 KB,
     among them) and six that stress its shadow cull (`_cull_scenes`:
     grazing occluders, shadow origins inside a sphere, the light inside a
     warp's box of hit points, occluders behind the light, a clump past
     the staging and the occluder list's capacities; the engine's scene
     after spawns doubled its capacity), each with the cull's admitted
     occluders and full-sweep warps; then one frame of the whole step
     (kernel path) against the plain reference renderer, cell by cell
  2b the soft kernels against their plain versions on the card, in nine
     cases (a slab overflow among them: the 40-sphere crowd at 96x32, where
     tiles gate more objects than SLAB) and one with culling off: K1's
     planes and gates, K2's tables under seeded random cotangents, K3's loss
     and tables (K2's and K3's partial tables bit-equal to the plain
     versions'), K3 against K1 + K2 with the MSE cotangents, the
     reduction bit-equal to its plain version on the same partials and
     against a float64 sum, and two launches giving bit-equal tables; then
     the kernel path end to end (forward and
     gradients) against the torch soft renderer at 400x150
  2c the shadowed kernels against their plain versions on the card: K4's
     14 planes and gates and K4-stats' counts bit-equal to the plain
     versions', K5's tables under seeded random
     cotangents, K6's loss and tables (K5's and K6's partial tables bit-equal
     to the plain versions', and the reduction of each bit-equal to its
     plain version's), K6 against K4 + K5 with the MSE cotangents and
     two launches bit-equal, in ten cases (96x32; 400x150 pitched; the bench
     headline 1920x1080 random_scene(20); a saturating light; a cache
     overflow past NC; a slab overflow past SLAB, 40 spheres; 3840x2160
     random_scene(200), where tiles take the exact re-walk; full darkness,
     where the early-out fires; culling off; an empty scene); then the
     shadowed kernel path
     against the torch soft renderer at bench.py's grad_cam_rot_rel config
     (640x360, 20 spheres): camera-rotation relative error <= 1.5e-2; and
     its rotation gradient against a float64 render on independently built
     rays: no farther than the farthest of five independent float32
     renders there, within 1.5e-2 at 400x150 with a posed camera
  3  the display path, counted: the engine with a FramebufferSink on the
     card, 400x150 in all five modes, a forced spawn with a capacity
     doubling, 1920x500 with 100 spheres and 2x supersampling; each frame
     replays the display's CUDA graph, and K7's launch count must equal
     two for each capture (its eager first frame and the capture); every
     published frame encoded on the card (the counter `encode.device`)
  3e the device encode (csrc/ansi_encode.cu): its stream against the plain
     version's and the C++ encoder's on the engine's 1920x500 cells in all
     five modes and on seeded cells (runs across rows, a width no multiple
     of 4, one row, one column, every digit count); graph and eager
     engines at 1920x500 x2 publishing the same bytes, the C++ encoder's
     on the same cells, through spawns and mode switches that re-capture;
     the kernel's device time beside its bound and the plain version's
  3h the heads kernel (csrc/cell_heads.cu): its cells against the plain
     version's (the engine's torch heads) on the same K7 planes, 1920x500
     x2 with shadows, 400x150 x1, 401x151 x3 and 320x100 x4, all five
     modes: kind, colour and char equal; graph and eager engines at 1920x500 x2 through mode switches:
     the same cells and bytes, one `heads.device` a published frame, one
     launch a replay; the kernel's device time beside its bound and the
     plain version's, in bit_pixel and rgb_pixel
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
  5  timings (CUDA events, host clock, profiler): K7 vs plain (also as a
     CUDA graph of 20 calls) at 400x150, 1080p/20 and 4K/200 with shadows
     and 3840x1000/100 without and with, broad phase, engine frames/s and
     rays/s (1920x500 at 2x supersampling also with shadows), a per-frame
     host breakdown; K1, K2, K3 and
     the reduction vs plain at 1920x1080 with 20 spheres (each soft kernel
     also as a CUDA graph of 20 calls, `_graph_ms`), the generic and
     fused train steps vs the same steps on the plain versions, and the
     device's busy share over 20 steps
  5b with shadows: K4, K5, K6, K4-stats and the reduction vs plain at the
     bench headline config (each kernel also as a CUDA graph); the generic
     and fused steps and the device's busy share; the fused step at
     3840x2160 with 200 spheres and its peak memory and K4 / K5 / K6 alone
     there (K4 also as a CUDA graph; K5 under the MSE cotangents of a
     zero target, as at the headline) and the reduction of K6's partials
     there; K4's shared memory a block and the blocks an SM its registers,
     shared memory and threads allow at both sizes; the cache-fallback share
     of tiles and K5's block barriers a tile at both sizes; the launches
     of one step of each train path and of one 1920x1080 engine frame
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
  7  the row-band sharded paths (rtwc_tpu_torch.dist): K7 at 1920x1080 with
     20 spheres and shadows as 2 and 4 bands (every band bit-equal to its
     plain version, the stitched bands torch.equal to the whole frame,
     render_frame_sharded eagerly over 4 bands equal to the frame, 4
     launches); render_frame_sharded as a CUDA graph over 2 and 4 bands (a
     capture, two replays, each torch.equal to render_frame_kernel; a
     replay launches K7 and the list kernel once a band);
     K1-K6 and the reduction on rows 540-1079 of the bench headline, as
     phases 2b / 2c; one eager sharded step of each train path on 2 bands,
     launches counted; the fused shadowed animated step at the scaling
     entry point's defaults (1920x1080, random_scene(100)) on 2 bands
     against 1: loss 1e-6 relative, every gradient rtol 2e-2 / atol 1e-6;
     the one-process sharded step there, fused and generic, on 1 and 2
     bands: 10 steps as one CUDA graph (9 replays under
     set_sync_debug_mode("error")) torch.equal to 10 eager ones, a replay's
     launches equal to an eager step's (K6, or K4 and K5, the reduction,
     the list kernel and the entry tables once a band); the scaling entry
     point's one-process step replayed and eager (graph=False), in turns,
     ms a step; `python -m rtwc_tpu_torch.benchmarks.scaling --ranks 2` (1
     process, then 2 gloo ranks sharing the card, each a graph up to the
     all-reduce and a graph after it): losses and parameters bit-equal
     across ranks, a replay launching K6, the reduction, the list kernel
     and the entry tables once and no step launching from Python, the
     first loss 1e-6 of the one rank's; ms a step and rays/s with the card
     line (the whole output in chip_smoke_out/scaling.log)
  8  the single-dispatch steps: the list kernel (csrc/broad_phase.cu)
     torch.equal to broad_phase.py (view lists, shadow lists, aux planes)
     and the entry tables' kernel to their plain version, at the headline,
     4K/200, the display's 3840x1000/100 lists, a pitched posed camera, the
     bands of rows 540-1079 and 270-539, phase 2's six cull scenes (hard and
     soft), the 40-sphere slab crowd, an empty scene and disable=True; an
     eager step of each train path and an eager display frame under
     torch.cuda.set_sync_debug_mode("error"); 10 graph-replayed steps of
     the shadowed fused headline and of the unshadowed generic step from
     _fit_start torch.equal to eager ones (losses and every parameter), 50
     engine frames at 1920x500 x2 with shadows, a capacity doubling and a
     spawn among them, the graph's cells torch.equal to the eager engine's;
     launches a replay; eager and graph ms a step at the headline, 4K/200
     and an empty scene, in turns, and lists_pack_ms
  9  the NCCL path (dist/mesh.py's one-graph layout), in a subprocess so
     that no process group outlives it: a one-rank NCCL group over a TCP
     store and make_mesh(2) over it; 10 fused (K6) and 3 generic (K4 / K5)
     shadowed animated steps at the scaling defaults, each as one CUDA
     graph with the all-reduce inside (one capture, the replays under
     set_sync_debug_mode("error")), torch.equal to as many eager steps
     (graph=False) and to the group-less graph's steps, losses and every
     leaf; a replay's launches equal to an eager step's, nothing counted
     while replaying, one cudaGraphLaunch and no collective call from the
     host a replayed step (profiler; chip_smoke_out/profile_graph_nccl*.txt,
     with NCCL's own device records), ms a step against the group-less
     graph in turns; render_frame_sharded over 2 bands with its all-gather
     in the graph: one capture, two replays, each torch.equal to
     render_frame_kernel; the scaling entry point as one spawned NCCL rank
     (`--ranks 1 --dist-backend nccl`) and under torchrun (`python -m
     torch.distributed.run --standalone --nproc-per-node 1 -m
     rtwc_tpu_torch.benchmarks.scaling --dist-backend nccl`): exit 0, one
     CUDA graph a step, ms a step; `--ranks 2 --dist-backend nccl` refused
     on one card with initialize_multihost's message before any rank
     starts (with two or more cards: run, ranks bit-equal)
Then a JSON line describing the kernels (each with its bound: the larger of
its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted
from this run's lists and gate tables, K4's, K5's and K6's also at 4K/200;
K7's from its lists and one occluder test for each hit pixel the shadow
changes (`_hard_work`), at 1080p/20, 4K/200 and 3840x1000/100 in `shapes`;
the chain kernel's is its FMAs over
SMs x 128 x the maximum clock; `launches` counts one main-path step at the
row's shape, each count set to 0 just before it: a generic or fused train
step, one engine frame at 1920x1080 for K7, one soft_tile_diagnostics call
for K4-stats; `launches_elsewhere` the other counted runs with their
shapes; `launches_sharded` those of phase 7's sharded paths;
`launches_nccl` those of phase 9's NCCL graph runs, each count set to 0
just before its run; the soft kernels add `floor_ms`, the calibrated floor of phase 6c
from this run's calibration, and `graph_device_ms`; the reduction's `library_ms` is its whole
function in float64 PyTorch calls, index_add_ and sums, held to the
kernel's sums, `library_device_ms` the same calls' device time, from CUDA
events around a CUDA graph of 20 calls, beside `function_device_ms`, the
port's wrapper measured the same way, at 1080p unshadowed and in
`reduce_shadowed` and `reduce_4k200`), the seconds of each phase, and as the last line
{"ok": true, "device": {...}}. Imports nothing of JAX. TF32 is off.
Longer tables go to chip_smoke_out/.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
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
OPS = dict(raygen=20, lb_sphere=40, lb_plane=43, geo_sphere=40, geo_plane=47, shade=78,
           acc7=31, acc10=40, final=20, light_ray=20, pre_a=23, pre_b=12, pre_plane=35,
           trans=23, corr=62, blend=18, cot=28, vjp_sphere=345, vjp_plane=360,
           sh_vjp_sphere=260, sh_vjp_plane=300, block_sum=5, tf_slot=40, loss=12,
           hard_sphere=32, hard_plane=25, hard_shade=70, hard_shadow=30)


# kernels-line keys -> soft_core.LAUNCHES keys of the kernels a sharded
# train step runs once a band (phase 7)
SHARDED_KEYS = {"K1": "soft_fwd", "K2": "soft_bwd", "K3": "soft_mse", "reduce": "soft_grad_reduce",
                "K4": "soft_sh_fwd", "K5": "soft_sh_bwd", "K6": "soft_sh_mse"}


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


def _device_records(prof) -> list:
    """The profiler's device records (kernels, copies, fills), without the
    device-side markers of host ranges (user annotations: the port's rtwc.*
    spans, torch's optimizer step)."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _kernel_device_ms(fn, reps=20, name="hard_render_kernel", tries=3, per_call=False):
    """Mean device time of the kernel `name` over `reps` calls of fn, from
    the profiler's CUDA kernel records whose name contains `name` (with
    per_call, the sum of those records a call: every kernel of a function
    that launches several). A profile that holds no such record is taken
    again, up to `tries` profiles in all (the profiler now and then returns
    a run without its device records); None if none holds one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in _device_records(prof)
              if name in e.name]
        if us:
            return sum(us) / (reps if per_call else len(us)) / 1e3
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


def _fit_start(center):
    """The --spheres 20 fit's starting centres (the fused train path's and
    phase 5's): each of `center` moved by normal(0, 0.5) from NumPy's seed
    1, so that a step against the target's render has nonzero cotangents."""
    import numpy as np
    import torch

    noise = np.random.default_rng(1).normal(0, 0.5, tuple(center.shape)).astype(np.float32)
    return center + torch.from_numpy(noise).to(center.device)


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


def _soft_case(SK, label, scene, cam, cfg, tau, dev, errs, cull=True, band=None):
    """Phase 2b for one case: K1, K2, K3 and the reduction against their
    plain versions on the same inputs, K3 against K1 + K2, determinism.
    cull=False runs every kernel without its culling (all live spheres
    listed, no gates); band = (row0, band_h) renders that band of rows
    (phase 7). Returns K1's (planes, gates)."""
    import torch

    spec = SK.SoftSpec(cfg, tau, cull=cull, bwd_cull=cull, band_h=band and band[1])
    sph, pl, camv = SK._packed(scene.to(dev), cam)
    if band:
        camv = SK._at_row(camv, band[0])
    lists = SK.build_lists(sph, camv, spec, cull)
    ent = SK.entry_tables(lists)
    offsets, pidx, counts = ent.offsets, ent.pidx, ent.counts
    n, ns = int(counts[0]), sph.shape[1]

    def red(parts):
        return SK.soft_grad_reduce(parts[0], pidx, parts[1], parts[2], ns, counts=counts)

    def red_plain(parts):
        return SK.soft_grad_reduce_plain(parts[0], pidx, parts[1], parts[2], ns, counts=counts)

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
    if not (torch.equal(gates_k, gates_p) and torch.equal(out_k, out_p)):
        raise AssertionError(f"{label}: K1's planes or gates differ from the plain version's")

    gen = torch.Generator().manual_seed(1234)
    g = torch.randn(out_p.shape, generator=gen).to(dev)
    bwd_args = (sph, pl, camv, lists, offsets, gates_p, out_p, g)
    p2k = SK.soft_bwd(*bwd_args, spec=spec)
    p2p = SK.soft_bwd_plain(*bwd_args, spec=spec)
    r2k, r2p = red(p2k), red_plain(p2p)
    k2 = _close_tables(_tables(r2k), _tables(r2p), f"{label}: K2 + reduction")

    Hp, Wp = spec.extent
    H, W = spec.rows, cfg.width
    tgt = (torch.rand((3, Hp, Wp), generator=gen) * 255.0).to(dev)
    p3k = SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec)
    p3p = SK.soft_mse_plain(sph, pl, camv, lists, offsets, tgt, spec=spec)
    r3k, r3p = red(p3k), red_plain(p3p)
    k3 = _close_tables(_tables(r3k), _tables(r3p), f"{label}: K3 + reduction")
    # K2's and K3's slab sums keep block_sum_plain's order: their partial
    # tables are bit-equal to the plain versions'; the reduction is bit-equal
    # to its plain version on the same partials (K2's and K3's)
    for what, pk, pp in (("K2", p2k, p2p), ("K3", p3k, p3p)):
        if not all(torch.equal(a, b) for a, b in zip(pk, pp)):
            raise AssertionError(f"{label}: {what}'s partial tables differ from its plain "
                                 f"version's")
    _reduce_bit_equal(red, red_plain, (r2k, r3k), (p2k, p3k), label)
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
    r12 = red(SK.soft_bwd(sph, pl, camv, lists, offsets, gates_k, out_k, g_mse, spec=spec))
    k3_vs = _close_tables(_tables(r3k), _tables(r12), f"{label}: K3 vs K1 + K2")

    # two launches on the same inputs give bit-equal tables
    again = (SK.soft_fwd(sph, pl, camv, lists, spec=spec),
             red(SK.soft_bwd(*bwd_args, spec=spec)),
             red(SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec)),
             SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec))
    same = (torch.equal(again[0][0], out_k) and torch.equal(again[0][1], gates_k)
            and all(torch.equal(a, b) for a, b in zip(again[1], r2k))
            and all(torch.equal(a, b) for a, b in zip(again[2], r3k))
            and all(torch.equal(a, b) for a, b in zip(again[3], p3k)))
    if not same:
        raise AssertionError(f"{label}: two launches gave different tables")
    errs["K1"] = max(errs["K1"], k1)
    errs["K2"] = max(errs["K2"], k2)
    errs["K3"] = max(errs["K3"], k3)
    print(f"phase 2b: {label} (tau {tau}): max abs diff K1 {k1!r}, K2 tables {k2!r}, "
          f"K3 tables {k3!r}, K3 vs K1+K2 {k3_vs!r}; K3 loss rel diff "
          f"{abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)!r}; list entries {n}, gated objects "
          f"a tile at most {int(gates_k[:, 0].sum(1).max())}; K2's and K3's partial tables and "
          f"the reduction bit-equal to the plain versions'; two launches bit-equal")
    return out_k, gates_k


def _reduce_bit_equal(red, red_plain, outs, parts, label):
    """The reduction's tables `outs` (of red(parts[i])) bit-equal to its plain
    version's on the same partials, and a second launch bit-equal to the
    first."""
    import torch

    for out, pp in zip(outs, parts):
        if not all(torch.equal(a, b) for a, b in zip(out, red_plain(pp))):
            raise AssertionError(f"{label}: the reduction differs from its plain version")
        if not all(torch.equal(a, b) for a, b in zip(out, red(pp))):
            raise AssertionError(f"{label}: two launches of the reduction differ")


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
            ent = SK.entry_tables(lists)
            parts = SK.soft_bwd_plain(sph, pl, cam, lists, ent.offsets, gates, out, g.contiguous(),
                                      spec=ctx.spec)
            dsph, dpl, dtf = SK.soft_grad_reduce_plain(parts[0], ent.pidx, parts[1], parts[2],
                                                       sph.shape[1], counts=ent.counts)
            return dsph, dpl, SK._dcam(dtf), None

    class PlainMSE(torch.autograd.Function):
        @staticmethod
        def forward(ctx, sph, pl, cam, tgt, spec):
            lists = SK.build_lists(sph, cam, spec, spec.cull)
            ent = SK.entry_tables(lists)
            parts = SK.soft_mse_plain(sph, pl, cam, lists, ent.offsets, tgt, spec=spec)
            dsph, dpl, dtf = SK.soft_grad_reduce_plain(parts[0], ent.pidx, parts[1], parts[2],
                                                       sph.shape[1], counts=ent.counts)
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


def _profile_steps(step, out_name: str, label: str, tag: str, reps: int = 20, phase: str = "5"):
    """Device busy share and kernel records of `reps` calls of step() under
    the profiler, with the per-kernel device time written to
    chip_smoke_out/<out_name>.txt."""
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
    kern = _device_records(prof)
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
    with open(os.path.join(OUT_DIR, f"{out_name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=60))
        f.write("\n".join(f"{us / reps:10.1f} us/step  {nm}" for nm, us in top))
    print(f"phase {phase}: profile {label}, {reps} steps: device busy {busy_us / wall_us!r} of "
          f"{wall_us / reps / 1e3!r} ms per step (profiler on), {busy_us / reps / 1e3!r} ms of "
          f"device time in {len(kern) / reps!r} kernel records a step {tag}")
    print(f"phase {phase}: top device time: " + "; ".join(
        f"{nm[:40]} {us / reps:.1f} us/step" for nm, us in top[:8]))
    host = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            host[e.name] = host.get(e.name, 0) + 1
    return {nm: us / reps for nm, us in by_name.items()}, {nm: n / reps for nm, n in host.items()}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _list_bytes(npl: int, *lists, gate_rows: bool = True) -> int:
    """Bytes of the tile lists a soft kernel reads and of the gate entries it
    writes or reads: each list row's n and n entries (not the row's unused
    tail), and, with gate_rows, one int a listed sphere and one a plane in
    the gate row that list fills (the wrappers' torch.zeros clears the rest)."""
    total = 0
    for lst in lists:
        n = int(lst[:, 0, 0].long().sum())
        total += 4 * (n + lst.shape[0]) + (4 * (n + lst.shape[0] * npl) if gate_rows else 0)
    return total


def _partial_bytes(gates, ns: int, npl: int, ntf: int, shadowed: bool = False) -> int:
    """Bytes of the partial rows a soft backward writes: the wrappers zero
    the tables, and the kernel writes the rows of the objects its tile
    gated, 8 floats a gated list entry (one 32-byte sector), 4 a gated
    shadow entry, 12 a plane gated in either sweep, and ntf two-float
    camera / loss slots a tile."""
    g0 = gates[:, 0].long()
    rows = 8 * int(g0[:, :ns].sum()) + 2 * ntf * gates.shape[0]
    planes = g0[:, ns:ns + npl]
    if shadowed:
        rows += 4 * int(gates[:, 1, :ns].long().sum())
        planes = planes | gates[:, 1, ns:ns + npl].long()
    return 4 * (rows + 12 * int(planes.sum()))


def _bound(nbytes: float, ops: float):
    """(least ms, what bounds it) for the work: bytes over 3.35 TB/s or
    float32 operations over 67 TFLOP/s, whichever takes longer."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _hard_work(hard_kernel, args, cfg, bh: int = 16, bw: int = 16):
    """(bytes, float32 operations) of one K7 launch on these inputs: the
    tables, the list rows it reads and the 8 planes it writes; per pixel the
    ray, its tile's list, the live planes and the shading, and with shadows
    one occluder test for each hit pixel whose colour the shadow changes
    (the least a sweep can do: a lit pixel's occluders can all be culled,
    a shadowed one needs the test that finds its blocker)."""
    sph, pl, counts, cam, lists = args
    out = hard_kernel.hard_render_plain(*args, config=cfg, bh=bh, bw=bw)
    per_pixel = (OPS["raygen"] + lists[:, 0, 0].double() * OPS["hard_sphere"]
                 + int(counts[0, 1]) * OPS["hard_plane"] + OPS["hard_shade"])
    ops = bh * bw * float(per_pixel.sum())
    if cfg.shadows:
        lit = hard_kernel.hard_render_plain(*args, config=cfg.replace(shadows=False), bh=bh,
                                            bw=bw)
        shadowed = (out[:3] != lit[:3]).any(0) & (out[3] < hard_kernel.MISS_DISTANCE)
        ops += float(shadowed.sum()) * OPS["hard_shadow"]
    return _nbytes(sph, pl, counts, cam, out) + _list_bytes(0, lists, gate_rows=False), ops


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


def _slab_crowd():
    """40 spheres packed into a short depth range over the floor: some
    16x16 tiles gate in more objects than the SLAB slots the backward
    sweeps sum at once (tests/test_torch_soft_kernel.py `_slab_crowd`)."""
    import numpy as np
    from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene

    rng = np.random.default_rng(3)
    s = empty_scene(48, 2)
    for _ in range(40):
        s = add_sphere(s, float(rng.uniform(2.0, 4.0)),
                       (float(rng.uniform(-3, 3)), float(rng.uniform(-1.5, 1.5)),
                        float(rng.uniform(20, 27))),
                       tuple(float(c) for c in rng.uniform(30, 220, 3)), speed=1.0)
    return add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)


def _dark_scene():
    """The 96x32 shadow scene under a ceiling slab that blocks the light:
    every floor and sphere pixel is in full shadow."""
    from rtwc_tpu_torch.scene import add_plane

    return add_plane(_shadow_scene_96(4, 3), (0.0, 20.0, 20.0), (0.0, -1.0, 0.0),
                     (80.0, 80.0, 80.0), 400.0, 400.0)


def _cull_scenes(width: int, height: int):
    """K7's shadow-cull cases, {label: (scene, config)} on the host, each
    with shadows, a floor and the default camera: spheres tangent to the
    shadow rays of floor points; a sphere around the camera, the light
    outside it, so that every shadow ray starts inside it (both roots must
    be >= 0 to block); the light just above the floor beside a sphere,
    inside some warp's box of hit points; spheres above the light (behind
    it, seen from the floor) and one between; and a clump of 300 small
    spheres that one tile lists whole (more than K7 stages at once) and
    that the floor's warps under its shadow admit whole (more than a warp's
    occluder list holds: those warps take the full sweep)."""
    import numpy as np
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene

    def floor(s):
        return add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 80.0,
                         80.0)

    def ball(s, r, c, rng):
        return add_sphere(s, float(r), tuple(float(v) for v in c),
                          tuple(float(v) for v in rng.uniform(30, 220, 3)), speed=1.0)

    cfg = RenderConfig(width=width, height=height, shadows=True)
    light = np.array(cfg.light_pos, np.float64)
    rng = np.random.default_rng(5)
    cases = {}
    s = empty_scene(8, 2)
    for x in (-6.0, 0.0, 6.0):
        for z in (22.0, 32.0):
            p = np.array([x, -3.0, z])
            l_dir = (light - p) / np.linalg.norm(light - p)
            n = np.cross(l_dir, [1.0, 0.0, 0.0])
            r = rng.uniform(0.5, 2.0)
            s = ball(s, r, p + l_dir * rng.uniform(3.0, 8.0) + n / np.linalg.norm(n) * r, rng)
    cases["grazing occluders"] = (floor(s), cfg)
    s = ball(empty_scene(4, 2), 50.0, (0.0, 0.0, 25.0), rng)
    s = ball(ball(s, 3.0, (-3.0, 2.0, 25.0), rng), 2.0, (4.0, 0.0, 30.0), rng)
    cases["shadow origins inside a sphere"] = (floor(s), cfg)
    s = ball(ball(empty_scene(8, 2), 2.0, (0.0, 0.0, 30.0), rng), 1.0, (3.0, -1.0, 36.0), rng)
    s = ball(s, 0.6, (2.0, -2.4, 34.0), rng)  # on the floor beside the light: casts on it
    for x in (-12.0, 12.0, 20.0):
        s = ball(s, 2.0, (x, 6.0, 40.0), rng)
    cases["the light inside a warp's hull"] = (floor(s), cfg.replace(light_pos=(0.0, -2.5, 33.0)))
    s = ball(empty_scene(12, 2), 2.0, (0.0, 4.0, 30.0), rng)
    for _ in range(8):
        s = ball(s, rng.uniform(1.0, 3.0), (rng.uniform(-10, 10), rng.uniform(14, 24),
                                            rng.uniform(20, 40)), rng)
    cases["occluders behind the light"] = (floor(s), cfg.replace(light_pos=(0.0, 10.0, 30.0)))
    s = empty_scene(320, 2)
    for _ in range(300):
        v = rng.normal(size=3)
        s = ball(s, 0.05, np.array([0.0, 2.0, 28.0]) + v / np.linalg.norm(v) * rng.uniform(0, 0.4),
                 rng)
    cases["a clump past the staging and occluder capacities"] = (floor(s), cfg)
    return cases


# The grazing cases of phase 8 (and of tests/test_torch_list_kernel.py):
# 256x128 images (16 x 8 tiles of 16x16) under the default camera, built so
# that many list decisions sit within an ulp of their thresholds. Each
# sphere's radius (or a plane's offset or tilt) is bisected until the plain
# broad phase's own float32 decision for one (tile, object) pair flips
# between two neighbouring float32 values, and one of the two is kept.
GRAZE_W, GRAZE_H = 256, 128


def _f32_flip(pred, lo: float, hi: float):
    """Neighbouring float32 values (a, b) in [lo, hi] (0 < lo < hi) with
    pred(a) != pred(b), by bisection over the float32 values between them;
    None when pred(lo) == pred(hi)."""
    import numpy as np

    def f(i):
        return float(np.int32(i).view(np.float32))

    a, b = int(np.float32(lo).view(np.int32)), int(np.float32(hi).view(np.int32))
    pa = pred(f(a))
    if pred(f(b)) == pa:
        return None
    while b - a > 1:
        m = (a + b) // 2
        if pred(f(m)) == pa:
            a = m
        else:
            b = m
    return f(a), f(b)


def _f64_flip(pred, lo: float, hi: float, steps: int = 64):
    """(a, b) with pred(a) != pred(b) and b - a at float64 resolution, by
    bisection; None when pred(lo) == pred(hi)."""
    pa = pred(lo)
    if pred(hi) == pa:
        return None
    for _ in range(steps):
        m = 0.5 * (lo + hi)
        if m in (lo, hi):
            break
        if pred(m) == pa:
            lo = m
        else:
            hi = m
    return lo, hi


def _graze_config(ns: int, npl: int):
    from rtwc_tpu_torch.config import RenderConfig

    return RenderConfig(width=GRAZE_W, height=GRAZE_H, max_spheres=ns, max_planes=npl,
                        shadows=True, **SOFT_KW)


def _add_plane_normal(n):
    """A plane's normal as `add_plane` stores it (normalised in float64)."""
    import numpy as np

    n = np.asarray(n, np.float64)
    return (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)


def _graze_tables(balls, planes=()):
    """Packed (sph [8, NS], pl [12, NP]) f32 tables on the host, the colours
    0, every object live (the tables `pack_scene` makes of `_graze_scene`'s
    scene); an inactive plane where there is none."""
    import torch

    sph = torch.zeros((8, len(balls)), dtype=torch.float32)
    for i, (c, r) in enumerate(balls):
        sph[0:3, i] = torch.tensor(c, dtype=torch.float32)
        sph[3, i], sph[7, i] = r, 1.0
    pl = torch.zeros((12, max(1, len(planes))), dtype=torch.float32)
    for k, (c, n, hw) in enumerate(planes):
        pl[0:3, k] = torch.tensor(c, dtype=torch.float32)
        pl[3:6, k] = torch.from_numpy(_add_plane_normal(n))
        pl[6, k] = pl[7, k] = hw
        pl[11, k] = 1.0
    return sph, pl


def _graze_scene(cfg, balls, planes=(), seed=0):
    """The Scene of the tables `_graze_tables` packs (slot order kept)."""
    import numpy as np
    from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene

    rng = np.random.default_rng(seed)
    s = empty_scene(cfg.max_spheres, cfg.max_planes)
    for c, r in balls:
        s = add_sphere(s, r, tuple(float(v) for v in c),
                       tuple(float(v) for v in rng.uniform(30, 220, 3)), speed=1.0)
    for c, n, hw in planes:
        s = add_plane(s, tuple(float(v) for v in c), tuple(float(v) for v in n),
                      (100.0, 100.0, 100.0), 2.0 * hw, 2.0 * hw)
    return s


def _graze_camera(cfg):
    """(default camera, its packed [1, 16] vector, the tile grid, the tile
    cones (axis, cos, corner directions), the origin in float64)."""
    import numpy as np
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.render import broad_phase as BP
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.scene import empty_scene

    cam = default_camera()
    camv = SK._packed(empty_scene(1, 1), cam)[2]
    grid = BP.tile_grid(cfg.height, cfg.width, 16, 16)
    cones = BP._tile_cones(camv, cfg, 16, 16, grid)
    return cam, camv, grid, cones, camv[0, :3].double().numpy()


def _unit_perp(a, rng):
    import numpy as np

    p = np.cross(a, rng.normal(size=3))
    return p / np.linalg.norm(p)


def _graze_view(hard: bool, n: int, seed: int):
    """n spheres, each tangent to one tile's view cone as the view test sees
    it: `ang` at `cone + alpha` (kind geom), at `cone + alpha40` (geom40, the
    sky test), with r_eff / dist within 1e-5 of 1 where asin's argument is
    clamped (clamp), or the camera at `r_eff + reach` from the centre (near)."""
    import numpy as np
    import torch
    from rtwc_tpu_torch.render import broad_phase as BP

    rng = np.random.default_rng(seed)
    cfg = _graze_config(n, 1)
    tau = 0.0 if hard else 0.5
    cam, camv, grid, (axis, cos_cone, _), o = _graze_camera(cfg)
    cone = torch.arccos(cos_cone).double().numpy()
    axis = axis.double().numpy()
    mp, far = cfg.soft_miss_penalty, cfg.far
    reach = 0.0 if hard else (far + 16.0 * tau) / mp
    r_scale = 1.0 if hard else float(np.sqrt(1.0 + reach))
    kinds = ("geom", "clamp") if hard else ("geom", "clamp", "near", "geom40")
    balls = []
    for i in range(n):
        kind = kinds[i % len(kinds)]
        ti, tj = int(rng.integers(grid[0])), int(rng.integers(grid[1]))
        a = axis[ti, tj]
        if kind in ("geom", "geom40"):
            theta, dist = cone[ti, tj] + rng.uniform(0.01, 0.3), rng.uniform(4.0, 60.0)
            lo, hi = 1e-3, 0.99 * dist / r_scale
        elif kind == "clamp":
            theta, dist = cone[ti, tj] + np.pi / 2 + rng.uniform(-2e-3, 2e-3), rng.uniform(2, 20)
            lo, hi = 0.9 * dist / r_scale, 1.1 * dist / r_scale
        else:
            theta, dist = cone[ti, tj] + rng.uniform(1.2, 1.5), rng.uniform(2.0, 6.0)
            lo, hi = 0.5 * (dist - reach) / r_scale, 1.05 * (dist - reach) / r_scale
        c = (o + dist * (np.cos(theta) * a + np.sin(theta) * _unit_perp(a, rng))).astype(
            np.float32)

        def pred(r, c=c, ti=ti, tj=tj, kind=kind):
            sph, _ = _graze_tables([(c, r)])
            lists, aux = BP.sphere_tile_lists(sph, camv, cfg, tau, 16, 16, grid, hard=hard)
            if kind == "geom40":
                return not bool(aux[1][ti, tj])
            return int(lists[ti * grid[1] + tj, 0, 0]) == 1
        flip = _f32_flip(pred, lo, hi)
        if flip is not None:
            balls.append((c, flip[int(rng.integers(2))]))
    return _graze_scene(cfg, balls, seed=seed), cam, cfg, tau


def _graze_occluders(n: int, seed: int):
    """A sphere around the camera (every tile lists it: no sky tile, and no
    plane, so every tile's hull runs to `far`) and n occluders, each within
    an ulp of its radius of entering one tile's shadow list: min over the
    tile's balls of d - R at r_keep."""
    import numpy as np
    from rtwc_tpu_torch.render import broad_phase as BP

    rng = np.random.default_rng(seed)
    cfg = _graze_config(n + 1, 1)
    tau = 0.5
    cam, camv, grid, (axis, cos_cone, _), o = _graze_camera(cfg)
    axis, cc = axis.double().numpy(), cos_cone.double().numpy()
    light = np.asarray(cfg.light_pos, np.float64)
    ks = cfg.soft_shadow_k
    keep_s, keep_c = np.sqrt(1.0 + 16.0 / ks), 16.0 / ks
    half = cfg.far / 16.0
    around = (o.astype(np.float32), 1000.0)
    balls = [around]
    for _ in range(n):
        for _attempt in range(20):
            ti, tj = int(rng.integers(grid[0])), int(rng.integers(grid[1]))
            b = int(rng.integers(8))
            tan = np.sqrt(max(1.0 - cc[ti, tj] ** 2, 0.0)) / max(cc[ti, tj], 0.05)
            t_mid = (2 * b + 1) * half
            v = o + axis[ti, tj] * t_mid - light
            R = np.hypot(half, (t_mid + half) * tan)
            r0 = rng.uniform(0.3, 2.0)
            rho = R + r0 * keep_s + r0 + keep_c + 0.02
            c = (light + rng.uniform(0.2, 0.8) * v + rho * _unit_perp(v, rng)).astype(np.float32)

            def pred(r, c=c, t=ti * grid[1] + tj):
                sph, pl = _graze_tables([around, (c, r)])
                _, shl = BP.build_tile_lists(sph, pl, camv, cfg, tau, 16, 16, grid, True)
                return 1 in shl[t, 0, 1:1 + int(shl[t, 0, 0])].tolist()
            flip = _f32_flip(pred, 1e-3, 3.0 * r0 + 1.0)
            if flip is not None:
                balls.append((c, flip[int(rng.integers(2))]))
                break
    return _graze_scene(cfg, balls, seed=seed), cam, cfg, tau


def _graze_planes(seed: int):
    """Ten spheres and eight planes: four facing the camera at the offset
    where one tile's `covered` certificate (t_max + pen <= cover_lim) flips,
    two tilted to where one tile's corner rays give dn_u = -1e-3 (front_all)
    and two to +1e-3 (back_pos)."""
    import numpy as np
    import torch
    from rtwc_tpu_torch.render import broad_phase as BP

    rng = np.random.default_rng(seed)
    cfg = _graze_config(12, 8)
    tau = 0.5
    cam, camv, grid, (axis, _, d_raw), o = _graze_camera(cfg)
    axis = axis.double().numpy()
    balls = [((rng.uniform(-8, 8), rng.uniform(-2, 4), rng.uniform(15, 40)),
              float(np.float32(rng.uniform(0.5, 2.5)))) for _ in range(10)]
    balls = [(np.asarray(c, np.float32), r) for c, r in balls]
    cover_lim = cfg.far - 16.0 * tau - 1.0

    def unit32(v):
        return _add_plane_normal(_add_plane_normal(v))

    planes = []
    for _ in range(4):
        ti, tj = int(rng.integers(grid[0])), int(rng.integers(grid[1]))
        a = axis[ti, tj]
        n32 = unit32(-a)

        def pred(s, ti=ti, tj=tj, a=a, n32=n32):
            _, pl = _graze_tables([], [((o + a * s).astype(np.float32), n32, 1000.0)])
            return bool(BP.plane_depth_bounds(pl, camv, cfg, tau, d_raw)[1][ti, tj])
        flip = _f64_flip(pred, 1.0, cover_lim + 30.0)
        if flip is not None:
            s = flip[int(rng.integers(2))]
            planes.append(((o + a * s).astype(np.float32), n32, 1000.0))
    for sign in (-1.0, -1.0, 1.0, 1.0):
        # a tile corner's ray u and p _|_ (u, z) pointing away from the tile's other
        # corners (p . d < 0 there): n = sign (p cos(phi) - u sin(phi)) has dn_u =
        # -sign sin(phi) at u, beyond the threshold at the other corners, and n_z ~
        # sin(phi) ~ 1e-3, whose float32 steps move dn_u by about one float32 step of
        # 1e-3: a bisection over phi, then one over n_z, puts u's dn_u within a step
        # or two of -sign 1e-3
        found = None
        while found is None:
            ti, tj = int(rng.integers(grid[0])), int(rng.integers(grid[1]))
            corners = d_raw[ti, tj]
            dq = corners.double().numpy()
            for q in range(4):
                u = dq[q] / np.linalg.norm(dq[q])
                for ps in (1.0, -1.0):
                    p = ps * np.cross(u, (0.0, 0.0, 1.0))
                    p /= np.linalg.norm(p)
                    if all(p @ dq[r] < -1e-3 for r in range(4) if r != q):
                        found = (u, p)
        u, p = found

        def past(n, corners=corners, sign=sign):
            n = torch.from_numpy(unit32(n))
            dn = corners[:, 0] * n[0] + corners[:, 1] * n[1] + corners[:, 2] * n[2]
            dn_u = dn / BP._norm3(corners)[:, 0]
            return bool((dn_u <= -1e-3).all()) if sign < 0 else bool((dn_u >= 1e-3).all())

        def normal(phi, u=u, p=p, sign=sign):
            return unit32(-sign * (p * np.cos(phi) - u * np.sin(phi)))
        flip = _f64_flip(lambda phi: past(normal(phi)), 0.0, 0.01)
        if flip is None:
            continue
        n0 = normal(flip[0])
        zs = 1.0 if n0[2] > 0 else -1.0

        def with_z(m, n0=n0, zs=zs):
            return np.array([n0[0], n0[1], zs * m], np.float32)
        fine = _f32_flip(lambda m: past(with_z(m)), 0.5 * abs(float(n0[2])),
                         2.0 * abs(float(n0[2])))
        n = unit32(with_z(fine[int(rng.integers(2))])) if fine else n0
        a = axis[ti, tj]
        planes.append(((o + a * 40.0 + p * 3.0).astype(np.float32), n, 20.0))
    return _graze_scene(cfg, balls, planes, seed=seed), cam, cfg, tau


def _graze_ties(scene, cam, cfg, tau: float, hard: bool, k: int = 4) -> dict:
    """Near-ties of a case, counted with the plain broad phase on the host:
    (tile, sphere) pairs whose view-list or shadow-list membership differs
    between every radius k float32 steps down and k up; with planes, tile
    corners whose dn_u lies within k float32 steps of -1e-3 or 1e-3, and
    (tile, plane) pairs whose `covered` certificate differs between the
    plane's offset from the camera scaled by (1 -+ k 2^-24)."""
    import numpy as np
    import torch
    from rtwc_tpu_torch.render import broad_phase as BP
    from rtwc_tpu_torch.render import soft_kernel as SK

    sph, pl, camv = SK._packed(scene, cam)
    grid = BP.tile_grid(cfg.height, cfg.width, 16, 16)

    def members(r_step, p=pl):
        s = sph.clone()
        bits = s[3].numpy().view(np.int32) + r_step
        s[3] = torch.from_numpy(bits.view(np.float32).copy())
        lists, shl = BP.build_tile_lists(s, p, camv, cfg, tau, 16, 16, grid, not hard)
        if hard:
            lists, _ = BP.sphere_tile_lists(s, camv, cfg, tau, 16, 16, grid, hard=True)
        out = []
        for t in (lists, shl):
            if t is None:
                continue
            m = torch.zeros((t.shape[0], s.shape[1] + 1), dtype=torch.bool)
            slot = torch.arange(t.shape[2] - 1)[None, :] < t[:, 0, :1]
            m.scatter_(1, torch.where(slot, t[:, 0, 1:].long(), s.shape[1]), slot)
            out.append(m[:, :-1])
        return out
    lo, hi = members(-k), members(k)
    ties = {"view": int((lo[0] != hi[0]).sum())}
    if not hard:
        ties["shadow"] = int((lo[1] != hi[1]).sum())
    live = int((pl[11] > 0.5).sum())
    if live:
        _, _, d_raw = BP._tile_cones(camv, cfg, 16, 16, grid)
        n = pl[3:6, :live].T
        dn = (d_raw[..., None, 0] * n[:, 0] + d_raw[..., None, 1] * n[:, 1]
              + d_raw[..., None, 2] * n[:, 2])
        dn_u = (dn / BP._norm3(d_raw)).numpy().ravel()
        ulp = np.spacing(np.float32(1e-3))
        ties["dn_u"] = int((np.minimum(np.abs(dn_u + np.float32(1e-3)),
                                       np.abs(dn_u - np.float32(1e-3))) <= k * ulp).sum())
        o = camv[0, :3]
        covered = []
        for sgn in (-1.0, 1.0):
            cov = []
            for j in range(live):
                q = pl[:, j:j + 1].clone()
                q[0:3, 0] = (o.double() + (q[0:3, 0].double() - o.double())
                             * (1.0 + sgn * k * 2.0 ** -24)).float()
                cov.append(BP.plane_depth_bounds(q, camv, cfg, tau, d_raw)[1])
            covered.append(torch.stack(cov))
        ties["covered"] = int((covered[0] != covered[1]).sum())
    return ties


def _grazing_scenes():
    """{label: (scene, camera, config, tau, hard)}: phase 8's grazing cases,
    built on the host from fixed seeds."""
    scenes = {}
    for hard in (False, True):
        scene, cam, cfg, tau = _graze_view(hard, 48, 11 + hard)
        scenes[f"grazing view cones ({'hard' if hard else 'soft'})"] = (scene, cam, cfg, tau,
                                                                        hard)
    scene, cam, cfg, tau = _graze_occluders(32, 13)
    scenes["grazing occluder balls"] = (scene, cam, cfg, tau, False)
    scene, cam, cfg, tau = _graze_planes(14)
    scenes["grazing planes (cover_lim, dn_u at +-1e-3)"] = (scene, cam, cfg, tau, False)
    return scenes


def _many_planes(n: int):
    """The default scene's spheres over n small tiles of floor in a grid."""
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.scene import add_plane, default_scene, grow_scene

    s = grow_scene(default_scene(RenderConfig(max_planes=1)), max_planes=n)
    side = int(n ** 0.5) + 1
    for i in range(n - 1):
        x, z = -20.0 + 40.0 * (i % side) / side, 10.0 + 40.0 * (i // side) / side
        s = add_plane(s, (x, -3.0 - 0.01 * (i % 7), z), (0.0, 1.0, 0.0),
                      (60.0 + i % 150, 100.0, 100.0), 1.5, 1.5)
    return s


def _grown_scene(dev, width: int = 400, height: int = 150):
    """The engine's scene after spawns that doubled its capacity: 8 sphere
    slots grown by the engine's forced 1 Hz spawn over 10 frames."""
    from rtwc_tpu_torch.config import EngineConfig, RenderConfig
    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.io import FramebufferSink

    eng = Engine(RenderConfig(width=width, height=height, max_spheres=8),
                 EngineConfig(spawn=True, show_fps=False, seed=1), presenter=FramebufferSink(),
                 interactive=False, device=dev)
    eng.telemetry.interval = 0.0
    eng.run(max_frames=10)
    if eng.scene.spheres.capacity <= 8:
        raise AssertionError("the engine's spawns did not grow the scene's capacity")
    return eng.scene


def _cull_stats(HK, args, cfg, bh: int = 16, bw: int = 16) -> dict:
    """K7's shadow cull on these inputs (the plain version's, which the
    kernel's equals), by warp: live spheres, warps with a hit, admitted
    occluders a warp (mean, max), warps past the occluder list (the full
    sweep), warps whose box of hit points holds the light, the longest list."""
    import torch

    sph, pl, counts, cam, lists = args
    o3, d3, t_best, _, _ = HK._trace(sph, pl, counts, cam, lists, cfg, bh, bw, None)
    p3, _, _ = HK._light(cfg, o3, d3, t_best)
    hit = t_best < HK.MISS_DISTANCE
    _, count, any_hit = HK.shadow_occluders(p3, hit, sph, int(counts[0, 0]), cfg.light_pos,
                                            bh, bw)
    inf = torch.tensor(float("inf"), device=sph.device)
    holds = any_hit.clone()
    for v, lc in zip(p3, cfg.light_pos):
        holds &= ((HK._by_warp(torch.where(hit, v, inf), bh, bw).amin(1) <= lc)
                  & (HK._by_warp(torch.where(hit, v, -inf), bh, bw).amax(1) >= lc))
    lit = count[any_hit].double()
    return {"live_spheres": int(counts[0, 0]), "warps_with_a_hit": int(any_hit.sum()),
            "mean_admitted": float(lit.mean()) if lit.numel() else 0.0,
            "max_admitted": int(lit.max()) if lit.numel() else 0,
            "full_sweep_warps": int((lit > HK.OCC_CAP).sum()),
            "warps_holding_the_light": int(holds.sum()),
            "longest_list": int(lists[:, 0, 0].max())}


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


def _shadow_case(SK, SH, label, scene, cam, cfg, tau, dev, errs, cull=True, band=None):
    """Phase 2c for one case: K4, K4-stats, K5, K6 and the reduction against
    their plain versions on the same inputs, K6 against K4 + K5, two
    launches bit-equal; band = (row0, band_h) renders that band of rows
    (phase 7). Returns (K4's planes, gates, K4-stats' counts)."""
    import torch

    spec = SK.SoftSpec(cfg, tau, cull=cull, bwd_cull=cull, band_h=band and band[1])
    sph, pl, camv = SK._packed(scene.to(dev), cam)
    if band:
        camv = SK._at_row(camv, band[0])
    lists, shl = SH.build_lists(sph, pl, camv, spec, cull)
    ent = SK.entry_tables(lists, shl)
    offsets, pidx, sh_offsets, pshidx, counts = ent
    n, nsh, ns = int(counts[0]), int(counts[1]), sph.shape[1]

    def red(parts):
        return SK.soft_grad_reduce(parts[0], pidx, parts[2], parts[3], ns, psh=parts[1],
                                   pshidx=pshidx, counts=counts)

    def red_plain(parts):
        return SK.soft_grad_reduce_plain(parts[0], pidx, parts[2], parts[3], ns, parts[1],
                                         pshidx, counts)

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
    if not (torch.equal(out_k, out_p) and torch.equal(gates_k, gates_p)
            and torch.equal(cnt_k, cnt_p) and torch.equal(out_s, out_k)
            and torch.equal(gates_s, gates_k)):
        raise AssertionError(f"{label}: K4's planes or gates or K4-stats' counts differ from the "
                             f"plain version's, or K4-stats' planes from K4's")

    gen = torch.Generator().manual_seed(1234)
    g = torch.randn(out_p.shape, generator=gen).to(dev)
    bwd_args = (sph, pl, camv, lists, shl, offsets, sh_offsets, gates_p, out_p, g)
    p5k = SH.soft_sh_bwd(*bwd_args, spec=spec)
    p5p = SH.soft_sh_bwd_plain(*bwd_args, spec=spec)
    r5k, r5p = red(p5k), red_plain(p5p)
    k5 = _close_tables(_tables(r5k), _tables(r5p), f"{label}: K5 + reduction")

    Hp, Wp = spec.extent
    H, W = spec.rows, cfg.width
    tgt = (torch.rand((3, Hp, Wp), generator=gen) * 255.0).to(dev)
    mse_args = (sph, pl, camv, lists, shl, offsets, sh_offsets, tgt)
    p6k = SH.soft_sh_mse(*mse_args, spec=spec)
    p6p = SH.soft_sh_mse_plain(*mse_args, spec=spec)
    r6k, r6p = red(p6k), red_plain(p6p)
    k6 = _close_tables(_tables(r6k), _tables(r6p), f"{label}: K6 + reduction")
    # K5's and K6's slab sums keep block_sum_plain's order: every partial
    # table bit-equal to the plain version's
    for what, pk, pp in (("K5", p5k, p5p), ("K6", p6k, p6p)):
        if not all(torch.equal(a, b) for a, b in zip(pk, pp)):
            raise AssertionError(f"{label}: {what}'s partial tables differ from its plain "
                                 f"version's")
    _reduce_bit_equal(red, red_plain, (r5k, r6k), (p5k, p6k), label)
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
                             g_mse, spec=spec))
    k6_vs = _close_tables(_tables(r6k), _tables(r45), f"{label}: K6 vs K4 + K5")

    again = (SH.soft_sh_fwd(sph, pl, camv, lists, shl, spec=spec),
             red(SH.soft_sh_bwd(*bwd_args, spec=spec)),
             red(SH.soft_sh_mse(*mse_args, spec=spec)),
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
          f"{int((cnt_k[:, 0] > SH.NC).sum())} of {cnt_k.shape[0]}, over SLAB={SH.SLAB}: "
          f"{int((cnt_k[:, 0] > SH.SLAB).sum())}); list entries {n}, shadow entries {nsh} (at most "
          f"{int(shl[:, 0, 0].max())} a tile); K4's planes and gates, K4-stats' counts, K5's and "
          f"K6's partial tables and the reduction bit-equal to the plain versions'; two launches "
          f"bit-equal")
    return out_k, gates_k, cnt_k


def _reduce_library(pvals, pidx, ppl, ptf, ns, psh=None, pshidx=None):
    """soft_grad_reduce's function in PyTorch library calls, in float64:
    (dsph [NS, 8], dpl [NP, 12], camera sums hi + lo [NTF]). pidx and
    pshidx hold the real entries alone (`_real_entries`)."""
    import torch

    dsph = torch.zeros((ns, 8), dtype=torch.float64, device=pvals.device)
    dsph.index_add_(0, pidx.long(), pvals[:pidx.shape[0]].double())
    if psh is not None:
        dsph[:, :4].index_add_(0, pshidx.long(), psh[:pshidx.shape[0]].double())
    return dsph, ppl.double().sum(0), ptf.double().sum((0, 2))


def _real_entries(parts, ent, ns):
    """soft_grad_reduce's arguments cut to the real entries, for the
    library calls: (pvals, pidx, ppl, ptf, ns[, psh, pshidx]) from a
    kernel's partials (pvals, ppl, ptf) or (pvals, psh, ppl, ptf)."""
    n = int(ent.counts[0])
    if ent.pshidx is None:
        return (parts[0][:n], ent.pidx[:n], parts[1], parts[2], ns)
    nsh = int(ent.counts[1])
    return (parts[0][:n], ent.pidx[:n], parts[2], parts[3], ns, parts[1][:nsh],
            ent.pshidx[:nsh])


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


def _graph_ms(fn, calls=20, runs=5):
    """(median device ms a call of fn, the ms of each run): CUDA events
    around the replay of a CUDA graph of `calls` calls of fn, `runs`
    replays. A replay queues the calls' device work with no host work
    between them, so the time is the device's, the gaps between its
    kernels included; no profiler record can go missing."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times), times


def _k5_barriers(shl, gates, ns: int) -> dict:
    """Block barriers of a K5 block, mean and max over the tiles, counted
    from its gate tables: one after the plane staging; then either two a
    gated object (a block sum each, the design before the slab) or two a
    sweep that gates any (a slab flush each, csrc/soft_block.cuh `Slab`);
    then two (one thread's camera sum, before the slab) or one
    (block_tf_rows) for the camera sums.
    K6's backward runs the same; its forward's barriers are K4's."""
    import torch

    main = gates[:, 0].sum(1).double()
    listed = torch.arange(ns, device=shl.device)[None, :] < shl[:, 0, 0].long()[:, None]
    entries = torch.where(listed, shl[:, 0, 1:1 + ns], 0).long()  # past a count: anything
    rows = gates[:, 1].gather(1, entries)
    shadow = (rows * listed).sum(1).double() + gates[:, 1, ns:].sum(1).double()
    per_object = 1 + 2 * (main + shadow) + 2
    slab = 1 + 2 * (shadow > 0).double() + 2 * (main > 0).double() + 1
    return {"block_sum_mean": per_object.mean().item(), "block_sum_max": per_object.max().item(),
            "slab_mean": slab.mean().item(), "slab_max": slab.max().item()}


# K6 as one kernel, before its split by tile class (PERF.md section 6): profiler
# means, a CUDA graph of 20 calls (headline); 4K/200
K6_UNSPLIT_MS = {"headline": "0.2809-0.2814", "graph": "0.2846-0.2886", "4k200": "1.500-1.501"}


def _k6_split(SH, libs, k6_ms, k6_graph_ms, k6_4k_ms, mse_h, hl, r4k, spec_hl):
    """Phase 5b's K6 lines: its device time beside the figures before its
    split, each variant's registers, spills, shared memory and blocks an
    SM (by registers, by shared memory, by threads), each class's share of
    the tiles at the headline and at 4K/200, and the tile counters over one
    call against the classes the lists give."""
    print(f"phase 5b: K6 (the classes and both variants) bench headline: {k6_ms!r} ms device a "
          f"call, {k6_graph_ms!r} ms a call of a CUDA graph of 20 (before the split "
          f"{K6_UNSPLIT_MS['headline']}, graph {K6_UNSPLIT_MS['graph']}); 3840x2160 "
          f"random_scene(200): {k6_4k_ms!r} ms (before {K6_UNSPLIT_MS['4k200']})")
    log = libs["soft_shadow"][:-3] + ".log"
    with open(log) as f:
        lines = f.read().splitlines()
    for flag, variant in (("ILb0E", "full"), ("ILb1E", "plane-only")):
        at = next(i for i, line in enumerate(lines)
                  if "Compiling entry function" in line and "soft_sh_mse_kernel" + flag in line)
        spill = next(line for line in lines[at:] if "spill" in line).strip()
        used = next(line for line in lines[at:] if "registers" in line)
        regs = int(used.split("Used")[1].split("registers")[0])
        static = int(used.split("bytes smem")[0].split(",")[-1])
        by_regs = 65536 // (-(-regs * 32 // 256) * 256 * 8)
        for label, (lists, shl, pl, sph) in (("bench headline", hl), ("4K/200", r4k)):
            smem = SH.k6_shared_bytes(sph.shape[1], pl.shape[1], lists.shape[2],
                                      variant == "plane-only")
            by_smem = (228 * 1024) // (smem + static + 1024)
            print(f"phase 5b: K6 {variant} variant at {label}: {regs} registers, {spill}; "
                  f"{smem} + {static} B of shared memory a block; blocks an SM by registers "
                  f"{by_regs}, by shared memory {by_smem}, by threads 8")
    for label, (lists, shl, _, _) in (("bench headline", hl), ("4K/200", r4k)):
        po, full = SH.tile_classes(lists, shl)
        print(f"phase 5b: K6 tile classes at {label}: {po.numel()} plane-only, {full.numel()} "
              f"full, plane-only share {po.numel() / lists.shape[0]!r}")
    before = SH.tile_counts()
    SH.soft_sh_mse(*mse_h, spec=spec_hl)
    after = SH.tile_counts()
    got = tuple(after[k] - before[k] for k in ("k6.tiles_plane_only", "k6.tiles_full"))
    want = tuple(x.numel() for x in SH.tile_classes(hl[0], hl[1]))
    if got != want:
        raise AssertionError(f"phase 5b: K6's tile counters advanced by {got}, the lists give "
                             f"{want}")
    print(f"phase 5b: K6 tile counters over one headline call {got}, as the lists give")


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


def _phase_7(dev, tag, errs):
    """Phase 7: the row-band sharded paths (rtwc_tpu_torch.dist) on the card.
    7a K7 at 1920x1080 with 20 spheres and shadows as 2 and 4 bands, each
    band bit-equal to its plain version, the stitched bands torch.equal to
    the whole frame, and render_frame_sharded over 4 bands equal to
    render_frame_kernel; 7b K1-K3 and K4-K6 with the reduction on one band
    of the bench headline (rows 540-1079) against their plain versions, as
    phases 2b / 2c; 7c one sharded step of each train path on a 2-band mesh
    in this process, launches counted; the fused shadowed step at the
    scaling entry point's defaults on 2 bands against 1 (loss, every
    gradient); `python -m rtwc_tpu_torch.benchmarks.scaling --ranks 2`
    (1 rank, then 2 gloo ranks sharing the card): bit-equal losses and
    parameters across ranks, K6 and the reduction once a step in each
    rank, the first loss equal to the one rank's. Returns the launches of
    one sharded step by kernel key, and K7's over 4 bands."""
    import torch

    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.dist import make_mesh, make_sharded_train_step, render_frame_sharded
    from rtwc_tpu_torch.benchmarks import scaling
    from rtwc_tpu_torch.dist import mesh as MESH
    from rtwc_tpu_torch.dist.mesh import _leaves
    from rtwc_tpu_torch.render import hard_kernel as HK
    from rtwc_tpu_torch.render import pack as P
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.render.step_graph import launch_counts, launch_delta
    from rtwc_tpu_torch.scene import random_scene

    # 7a: K7 a band
    cfg = RenderConfig(width=1920, height=1080, shadows=True)
    scene, cam = random_scene(20, seed=0, device=dev), default_camera()
    sph, pl, counts = P.pack_scene(scene)
    camv = P.pack_camera(cam, dev)
    whole = HK.hard_render_packed(sph, pl, counts.reshape(1, 2), camv,
                                  HK.tile_lists(sph, camv, cfg, 16, 16), config=cfg, bh=16,
                                  bw=16)[:, :cfg.height, :cfg.width]
    for n in (2, 4):
        rows = cfg.height // n
        bands = []
        for b in range(n):
            cam_b = SK._at_row(camv, b * rows)
            args = (sph, pl, counts.reshape(1, 2), cam_b,
                    HK.tile_lists(sph, cam_b, cfg, 16, 16, rows=rows))
            ker = HK.hard_render_packed(*args, config=cfg, bh=16, bw=16, band_h=rows)
            if not torch.equal(ker, HK.hard_render_plain(*args, config=cfg, bh=16, bw=16,
                                                         band_h=rows)):
                raise AssertionError(f"phase 7: K7 band {b} of {n} differs from its plain version")
            bands.append(ker[:, :rows, :cfg.width])
        if not torch.equal(torch.cat(bands, 1), whole):
            raise AssertionError(f"phase 7: K7's {n} stitched bands differ from the whole frame")
    single = HK.render_frame_kernel(scene, cam, cfg)
    fields = ("rgb", "normal", "depth", "shading", "hit", "coverage", "alpha")
    HK.LAUNCHES = 0
    fb = render_frame_sharded(scene, cam, cfg, make_mesh(4), backend="pallas", graph=False)
    torch.cuda.synchronize()
    k7_bands = HK.LAUNCHES
    for f in fields:
        if not torch.equal(getattr(fb, f), getattr(single, f)):
            raise AssertionError(f"phase 7: render_frame_sharded's {f} differs from the frame's")
    if k7_bands != 4:
        raise AssertionError(f"phase 7: K7 launched {k7_bands} times for 4 bands")
    print(f"phase 7: K7 1920x1080 random_scene(20) shadows as 2 and 4 bands (540 / 270 rows, "
          f"partial last tiles): every band bit-equal to its plain version, the stitched bands "
          f"torch.equal to the whole frame; render_frame_sharded (eager) over 4 bands equal to "
          f"render_frame_kernel, K7 launched {k7_bands} times")
    # the sharded frame as one CUDA graph: a capture, then replays, each equal
    # to the whole frame; a replay launches the list kernel and K7 once a band
    for n in (2, 4):
        for i in range(3):  # the warm-up and capture, then two replays
            fr = render_frame_sharded(scene, cam, cfg, make_mesh(n), backend="pallas")
            if not all(torch.equal(getattr(fr, f), getattr(single, f)) for f in fields):
                raise AssertionError(f"phase 7: sharded frame {i} over {n} bands (graph) "
                                     f"differs from render_frame_kernel")
        fg = MESH._frame_graph(cfg, n, range(n), scene.device, None)
        if fg.call.captures != 1 or fg.call.replay_launches != {"hard_render": n,
                                                                "tile_lists": n}:
            raise AssertionError(f"phase 7: sharded frame over {n} bands: {fg.call.captures} "
                                 f"captures, a replay launches {fg.call.replay_launches}")
        print(f"phase 7: render_frame_sharded over {n} bands (a new mesh each call) as a CUDA "
              f"graph (a capture, two replays): every frame torch.equal to "
              f"render_frame_kernel in all 7 fields; a replay launches "
              f"{fg.call.replay_launches}")
    frame_ms = {}
    for graph in (None, False, False, None):  # in turns
        frame_ms.setdefault("graph" if graph is None else "eager", []).append(_step_ms(
            lambda: render_frame_sharded(scene, cam, cfg, make_mesh(4), backend="pallas",
                                         graph=graph), 20))
    print(f"phase 7: render_frame_sharded over 4 bands, 1920x1080 random_scene(20) shadows: "
          f"ms a frame replayed {frame_ms['graph']}, eager {frame_ms['eager']} (in turns) {tag}")

    # 7b: K1-K6 and the reduction on one band of the bench headline
    cfg_hl = RenderConfig(width=1920, height=1080, max_spheres=20, max_planes=4, shadows=True,
                          **SOFT_KW)
    scene_hl = random_scene(20, max_spheres=20, max_planes=4, seed=0)
    for key in SK.LAUNCHES:
        SK.LAUNCHES[key] = 0
    _soft_case(SK, "band 540-1079 of the headline, unshadowed", scene_hl, cam,
               cfg_hl.replace(shadows=False), 0.5, dev, errs, band=(540, 540))
    _shadow_case(SK, SH, "band 540-1079 of the headline", scene_hl, cam, cfg_hl, 0.5, dev,
                 errs, band=(540, 540))
    torch.cuda.synchronize()
    print(f"phase 7: band kernel launches in 7b's checks: "
          f"{ {k: v for k, v in SK.LAUNCHES.items() if v} }")

    # 7c: one sharded step of each train path on a 2-band mesh, counted
    scene_hld, tgt = scene_hl.to(dev), torch.zeros((1080, 1920, 3), device=dev)
    paths = {("shadows", "fused"): {"soft_sh_mse": 2, "soft_grad_reduce": 2},
             ("shadows", "generic"): {"soft_sh_fwd": 2, "soft_sh_bwd": 2, "soft_grad_reduce": 2},
             ("unshadowed", "fused"): {"soft_mse": 2, "soft_grad_reduce": 2},
             ("unshadowed", "generic"): {"soft_fwd": 2, "soft_bwd": 2, "soft_grad_reduce": 2}}
    launches = {}
    for (sh, kind), want in paths.items():
        step = make_sharded_train_step(cfg_hl.replace(shadows=sh == "shadows"), make_mesh(2),
                                       tau=0.5, backend="pallas", graph=False,
                                       loss_scale=1.0 / 255.0 if kind == "fused" else 1.0 / 256.0)
        params = (scene_hld, cam)
        state = step.init(params)
        for key in SK.LAUNCHES:
            SK.LAUNCHES[key] = 0
        _, _, loss = step(params, state, tgt)
        torch.cuda.synchronize()
        got = {k: v for k, v in SK.LAUNCHES.items() if v}
        if got != want or not torch.isfinite(loss):
            raise AssertionError(f"phase 7: {sh} {kind} sharded step launched {got}, loss {loss}")
        for k, v in got.items():
            launches.setdefault(k, {})[f"{sh} {kind}"] = v
        print(f"phase 7: one {sh} {kind} sharded step, 1920x1080 random_scene(20), 2 bands in "
              f"this process: launches {got}, loss {float(loss)!r}")

    # the fused shadowed step at the scaling entry point's defaults: 2 bands against 1
    cfg_s = RenderConfig(width=1920, height=1080, max_spheres=100, max_planes=4, shadows=True,
                         **SOFT_KW)
    scene_s = random_scene(100, max_spheres=100, max_planes=4, seed=0, device=dev)
    lr = 2.0 ** 16

    def sgd_grads(n):
        step = make_sharded_train_step(
            cfg_s, make_mesh(n), tau=0.5, backend="pallas", animate=True,
            optimizer=lambda leaves: torch.optim.SGD(list(leaves.values()), lr=lr))
        params = (scene_s, cam)
        new, _, loss = step(params, step.init(params), tgt, 1.0 / 60.0)
        old_l, new_l = _leaves(params), _leaves(new)
        return float(loss), {k: ((old_l[k].to(dev) - new_l[k].to(dev)) / lr).double()
                             for k in old_l}

    (l1, g1), (l2, g2) = sgd_grads(1), sgd_grads(2)
    if abs(l2 - l1) > 1e-6 * abs(l1):
        raise AssertionError(f"phase 7: 2-band loss {l2!r} vs 1-band {l1!r}")
    worst = {}
    for k in g1:
        d = (g2[k] - g1[k]).abs()
        if bool((d > 1e-6 + 2e-2 * torch.maximum(g2[k].abs(), g1[k].abs())).any()):
            raise AssertionError(f"phase 7: 2-band gradient {k} differs from the 1-band one")
        worst[k] = float(d.max() / g1[k].abs().max()) if bool(g1[k].abs().max() > 0) else 0.0
    print(f"phase 7: fused shadowed animated step at the scaling defaults (1920x1080, "
          f"random_scene(100), tau 0.5), 2 bands vs 1: loss {l2!r} vs {l1!r}; every gradient "
          f"within rtol 2e-2 / atol 1e-6; largest difference over the leaf's largest value "
          f"{json.dumps({k: v for k, v in worst.items() if v})}; camera gradient 2 bands "
          f"{g2['camera.rot'].tolist()} vs 1 band {g1['camera.rot'].tolist()}")

    # 7d: the one-process sharded step as one CUDA graph against the eager step
    cam_d = cam.to(dev)
    tick = 1.0 / 60.0
    band_kernels = {"fused": ("soft_sh_mse",), "generic": ("soft_sh_fwd", "soft_sh_bwd")}
    for kind, kernels in band_kernels.items():
        for n in (1, 2):
            runs = []
            for graph in (False, True):
                step = make_sharded_train_step(
                    cfg_s, make_mesh(n), tau=0.5, backend="pallas", animate=True, graph=graph,
                    loss_scale=1.0 / 255.0 if kind == "fused" else 1.0 / 256.0)
                params = (scene_s, cam_d)
                state = step.init(params)
                params, state, loss = step(params, state, tgt, tick)
                losses = [loss]
                torch.cuda.synchronize()
                before = launch_counts()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for i in range(9):
                        params, state, loss = step(params, state, tgt, tick)
                        losses.append(loss)
                        if i == 0:
                            counted = launch_delta(before)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                runs.append((torch.stack(losses), [v.detach().clone()
                                                   for v in state.leaves.values()],
                             counted, state))
            (le, pe, eager_counts, _), (lg, pg, replay_counted, gstate) = runs
            want = {k: n for k in kernels + ("soft_grad_reduce", "tile_lists", "entry_tables")}
            if not (torch.equal(le, lg) and all(torch.equal(a, b) for a, b in zip(pe, pg))):
                raise AssertionError(f"phase 7: {kind} sharded step on {n} bands: 10 replayed "
                                     f"steps differ from eager ones ({le.tolist()} vs "
                                     f"{lg.tolist()})")
            if eager_counts != want or gstate.replay_launches != want or replay_counted:
                raise AssertionError(f"phase 7: {kind} sharded step on {n} bands: an eager step "
                                     f"launched {eager_counts}, a replay {gstate.replay_launches}"
                                     f" (counted while replaying: {replay_counted}); want {want}")
            print(f"phase 7: {kind} shadowed animated sharded step at the scaling defaults on {n} "
                  f"band{'s' if n > 1 else ''} in one process: 10 steps as one CUDA graph "
                  f"({gstate.phases[0].captures} capture, 9 replays under "
                  f"set_sync_debug_mode('error')) torch.equal to 10 eager steps in every loss "
                  f"({float(le[0])!r} -> {float(le[-1])!r}) and all {len(pe)} leaves; a replay "
                  f"launches {gstate.replay_launches}, an eager step {eager_counts}")
    # where the device time of a replayed one-process step at the scaling
    # defaults goes (chip_smoke_out/profile_graph_sharded.txt)
    step = make_sharded_train_step(cfg_s, make_mesh(1), tau=0.5, backend="pallas", animate=True)
    box = [(scene_s, cam_d), None]
    box[1] = step.init(box[0])

    def sharded_step():
        box[0], box[1], _ = step(box[0], box[1], tgt, tick)
    _profile_steps(sharded_step, "profile_graph_sharded", "one-process sharded step at the "
                   "scaling defaults, graph-replayed", tag, phase="7")
    # the scaling entry point's one-process step, replayed and eager, in turns
    sargs = scaling._parser().parse_args(["--iters", "20"])
    step_ms = {"graph": [], "eager": []}
    for graph in (None, False, False, None):
        rec = scaling.run_rank(sargs, "cuda", graph=graph)
        step_ms["graph" if rec["graph"] else "eager"].append(rec["ms_per_step"])
    print(f"phase 7: scaling defaults (1920x1080 random_scene(100), shadows, animated, fused "
          f"K6, Adam on every leaf) in one process: ms a step replayed {step_ms['graph']}, "
          f"eager (graph=False) {step_ms['eager']} (in turns) {tag}")

    # the scaling entry point: one rank, then two gloo ranks sharing the card
    iters = 5
    cmd = [sys.executable, "-m", "rtwc_tpu_torch.benchmarks.scaling", "--ranks", "2", "--iters",
           str(iters)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "scaling.log"), "w") as f:
        f.write(proc.stderr + "\n" + proc.stdout)
    if proc.returncode != 0:
        raise AssertionError(f"scaling exited {proc.returncode}: {proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = {r["mesh"]: r for r in rec["results"]}
    per_rank = {"soft_sh_mse": 1, "soft_grad_reduce": 1, "tile_lists": 1, "entry_tables": 1}
    for n, row in rows.items():
        if not (row["losses_bit_equal"] and row["params_bit_equal"]):
            raise AssertionError(f"phase 7: {n} ranks disagree: {row}")
        if not row["graph"] or any(lc != per_rank for lc in row["replay_launches"]) or any(
                row["launches_per_step"]):
            raise AssertionError(f"phase 7: {n} ranks: graph {row['graph']}, a replay launches "
                                 f"{row['replay_launches']}, counted a timed step "
                                 f"{row['launches_per_step']}")
    if sorted(rows) != [1, 2] or abs(rows[2]["losses"][0] - rows[1]["losses"][0]) > \
            1e-6 * abs(rows[1]["losses"][0]):
        raise AssertionError(f"phase 7: first losses {rows}")
    for n, row in sorted(rows.items()):
        print(f"phase 7: {' '.join(cmd[1:])}: mesh {n} ({n} process{'es' if n > 1 else ''}"
              f"{', gloo, sharing cuda:0, simulated' if row.get('simulated') else ''}): "
              f"{row['ms_per_step']!r} ms a step, {row['rays_per_s']!r} rays/s, losses "
              f"{row['losses'][0]!r} -> {row['losses'][-1]!r}, bit-equal across ranks, "
              f"parameters bit-equal after {2 + iters} steps, CUDA graphs, a replay launches "
              f"{row['replay_launches']} {tag}")
    print(f"phase 7: scaling entry point exit 0 in {secs:.1f} s")
    return launches, k7_bands


# The broad phase's float32 operations (render/broad_phase.py, which both
# list kernels compute), counted as OPS counts them, each part as often as
# these inputs need it: once a live sphere, its tile-independent view terms
# (the vector to it, its distance and direction, the two radii's asin, the
# near tests, dist + r) and occluder terms (w, ww, r_keep); once a tile, its
# cone (four corner rays, the axis, the angle) and, with shadow lists, the
# eight balls; once a (tile, live plane), the plane's corner bounds and its
# four penalties; once a (tile, live sphere), the view test (the angle and
# the two compares) and, with shadow lists, the test against each of the NB
# balls.
LIST_OPS = dict(sphere=28, occluder_sphere=12, cone=160, balls=182, plane=190, view=14,
                ball=19)


def _list_args(SK, BP, scene, cam, cfg, dev, band=None):
    """(sph, pl, cam vector, grid) of a case, band = (row0, rows)."""
    sph, pl, camv = SK._packed(scene.to(dev), cam)
    rows = cfg.height
    if band:
        camv, rows = SK._at_row(camv, band[0]), band[1]
    return sph.detach(), pl.detach(), camv.detach(), BP.tile_grid(rows, cfg.width, 16, 16)


def _list_case(LK, BP, SK, label, scene, cam, cfg, tau, dev, shadows=True, hard=False,
               disable=False, band=None):
    """The list kernel against broad_phase.py on the card, on the same packed
    tables: the view lists' and the shadow lists' counts and listed prefixes
    and the aux planes torch.equal (the kernel writes no slot past a count:
    no card consumer reads there, and the plain versions mask those slots;
    the plain lists keep their excluded tails). Then the
    entry tables' kernel against their plain version on the kernel's lists,
    in three launches (the scratch's epoch advances): offsets and counts
    torch.equal, the entries below the counts torch.equal (the card writes
    nothing past them, and no card consumer reads there: the reduction's
    red_key / warp_key_rounds in csrc/soft_render.cu stop at the counts), and
    the partial tables, filled with NaN first, zero below the counts and
    untouched past them. Returns (view entries, shadow entries)."""
    import torch

    sph, pl, camv, grid = _list_args(SK, BP, scene, cam, cfg, dev, band)
    got = LK.tile_lists_with_aux(sph, pl, camv, cfg, tau, 16, 16, grid, shadows, hard=hard,
                                 disable=disable)
    want = LK.tile_lists_plain(sph, pl, camv, cfg, tau, 16, 16, grid, shadows, hard=hard,
                               disable=disable)
    for what, a, b in (("view lists", got[0], want[0]), ("shadow lists", got[1], want[1])):
        if (a is None) != (b is None):
            raise AssertionError(f"{label}: the list kernel's {what}: one of the two is None")
        if a is None:
            continue
        listed = torch.arange(a.shape[2], device=a.device)[None, :] <= b[:, 0, :1]
        diff = (a[:, 0] != b[:, 0]) & listed
        if bool(diff.any()):
            bad = diff.any(1).nonzero()[:3, 0].tolist()
            raise AssertionError(f"{label}: the list kernel's {what} differ from broad_phase.py's"
                                 f" in count or listed prefix (tiles {bad}: kernel "
                                 f"{[a[t, 0].tolist() for t in bad]}, plain "
                                 f"{[b[t, 0].tolist() for t in bad]})")
    if (got[2] is None) != (want[2] is None) or (
            got[2] is not None and not all(torch.equal(x, y) for x, y in zip(got[2], want[2]))):
        raise AssertionError(f"{label}: the list kernel's aux planes differ from broad_phase.py's")
    ent_p = LK.entry_tables_plain(got[0], got[1])
    n, nsh = (int(x) for x in ent_p.counts)
    for launch in range(3):
        tables = [t.fill_(float("nan")) if t is not None else None
                  for t in LK.partial_tables(got[0], got[1])]
        ent_k = LK.entry_tables(got[0], got[1], *tables)
        for f, a, b in (("offsets", ent_k.offsets, ent_p.offsets),
                        ("sh_offsets", ent_k.sh_offsets, ent_p.sh_offsets),
                        ("counts", ent_k.counts, ent_p.counts),
                        ("pidx below the count", ent_k.pidx[:n], ent_p.pidx[:n]),
                        ("pshidx below the count", None if ent_k.pshidx is None
                         else ent_k.pshidx[:nsh], None if ent_p.pshidx is None
                         else ent_p.pshidx[:nsh])):
            if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
                raise AssertionError(f"{label}: launch {launch}: the entry tables' {f} differ "
                                     f"from the plain version's")
        for name, t, k in (("pvals", tables[0], n), ("psh", tables[1], nsh)):
            if t is not None and not (bool((t[:k] == 0).all()) and bool(t[k:].isnan().all())):
                raise AssertionError(f"{label}: launch {launch}: {name} is not zero below the "
                                     f"count {k} and untouched past it")
    T, ns = got[0].shape[0], sph.shape[1]
    print(f"phase 8: {label} ({'hard' if hard else f'tau {tau}'}"
          f"{', shadows' if shadows else ''}{', disable' if disable else ''}"
          f"{f', rows {band[0]}-{band[0] + band[1] - 1}' if band else ''}): {T} tiles, "
          f"{int((sph[7] > 0.5).sum())} live of {ns} spheres; list kernel torch.equal to "
          f"broad_phase.py in count and listed prefix (view lists"
          f"{', shadow lists' if shadows else ''}; the slots past a count, which no card "
          f"consumer reads, are not written){', and in the aux planes' if not disable else ''}; "
          f"entry tables in 3 launches: offsets, counts and "
          f"the entries below the counts torch.equal to the plain version's (compared below "
          f"the counts: the card writes nothing past them and the reduction reads nothing "
          f"there), the partial tables zero below the counts and untouched past them; "
          f"{n} entries, {nsh} shadow entries")
    return n, nsh


def _sum3_orders(dev) -> dict:
    """How torch's CUDA reduction sums the broad phase's two three-element
    `.sum(-1)`s (broad_phase.shadow_tile_lists): ww over the transposed
    sphere table's [NS, 3] (strided last dimension; contiguous for NS = 1)
    and vv over the balls' contiguous [Ti, Tj, NB, 3]; for each, the share
    of values equal to (x0 + x1) + x2 and to (x0 + x2) + x1, on random
    inputs. The list kernel mirrors the order found here."""
    import torch

    gen = torch.Generator().manual_seed(5)
    light = torch.tensor([1.0, 50.0, 0.0], device=dev)
    out = {}
    for ns in (1, 2, 20, 200, 3000):  # NS = 1: 64 tables of one sphere
        out[f"ww ns={ns}"] = [(torch.randn((8, ns), generator=gen) * 30.0).to(dev)[0:3].T - light
                              for _ in range(64 if ns == 1 else 1)]
    out["vv 68x120x8"] = [(torch.randn((68, 120, 8, 3), generator=gen) * 30.0).to(dev) - light]
    shares = {}
    for label, xs in out.items():
        got = torch.cat([(x * x).sum(-1).reshape(-1) for x in xs])
        sq = torch.cat([(x * x).reshape(-1, 3) for x in xs])
        shares[label] = (float((got == (sq[:, 0] + sq[:, 1]) + sq[:, 2]).double().mean()),
                         float((got == (sq[:, 0] + sq[:, 2]) + sq[:, 1]).double().mean()))
    return shares


def _list_cases(dev):
    """Phase 8a: the list kernel and the entry tables against their plain
    versions (`_list_case`) in every case: the bench headline, 4K/200, the
    display's lists, a pitched posed camera, two bands, K7's cull cases
    (hard and soft), the slab crowd, an empty scene, culling off, 4096
    sphere slots (hard and soft), and the grazing cases (`_grazing_scenes`), each with its near-ties counted on
    the host (`_graze_ties`)."""
    import torch

    from rtwc_tpu_torch.camera import Camera, default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.render import broad_phase as BP
    from rtwc_tpu_torch.render import list_kernel as LK
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.scene import empty_scene, random_scene

    cam = default_camera()
    cfg_hl = RenderConfig(width=1920, height=1080, max_spheres=20, max_planes=4, shadows=True,
                          **SOFT_KW)
    scene_hl = random_scene(20, max_spheres=20, max_planes=4, seed=0, device=dev)
    cfg_4k = cfg_hl.replace(width=3840, height=2160, max_spheres=200)
    scene_4k = random_scene(200, max_spheres=200, max_planes=4, seed=0, device=dev)
    posed = Camera(pos=torch.tensor([3.0, 2.0, -5.0]), rot=torch.tensor([0.25, 2.8, 0.0]))
    orders = _sum3_orders(dev)
    print(f"phase 8: torch's three-element sums, share equal to (x0 + x1) + x2 and to "
          f"(x0 + x2) + x1: {orders}")
    if not (all(v[0] == 1.0 for k, v in orders.items() if k.startswith("ww") and k != "ww ns=1")
            and orders["ww ns=1"][1] == 1.0 and orders["vv 68x120x8"][1] == 1.0):
        raise AssertionError("torch sums ww or vv in another order than the list kernel does")
    _list_case(LK, BP, SK, "bench headline 1920x1080 random_scene(20)", scene_hl, cam, cfg_hl,
               0.5, dev)
    _list_case(LK, BP, SK, "3840x2160 random_scene(200)", scene_4k, cam, cfg_4k, 0.5, dev)
    _list_case(LK, BP, SK, "3840x1000 random_scene(100), the display's lists",
               random_scene(100, seed=0), cam, RenderConfig(width=3840, height=1000), 0.0, dev,
               shadows=False, hard=True)
    _list_case(LK, BP, SK, "400x150 random_scene(24, seed=7), pitched posed camera",
               random_scene(24, max_spheres=24, max_planes=4, seed=7), posed,
               RenderConfig(width=400, height=150, max_spheres=24, shadows=True, **SOFT_KW),
               0.5, dev)
    _list_case(LK, BP, SK, "400x150 pitched posed camera, the display's lists",
               random_scene(24, max_spheres=24, max_planes=4, seed=7), posed,
               RenderConfig(width=400, height=150, max_spheres=24), 0.0, dev, shadows=False,
               hard=True)
    for band in ((540, 540), (270, 270)):
        _list_case(LK, BP, SK, "bench headline band", scene_hl, cam,
                   cfg_hl, 0.5, dev, band=band)
    cull = dict(_cull_scenes(400, 150))
    cull["the engine's scene after spawns doubled its capacity"] = (
        _grown_scene(dev), RenderConfig(width=400, height=150, shadows=True))
    for label, (scene, cfg) in cull.items():
        _list_case(LK, BP, SK, label, scene, cam, cfg, 0.0, dev, shadows=False, hard=True)
        _list_case(LK, BP, SK, label, scene, cam, cfg.replace(**SOFT_KW), 0.5, dev)
    _list_case(LK, BP, SK, "96x32 40-sphere slab crowd", _slab_crowd(), cam,
               RenderConfig(width=96, height=32, max_spheres=48, max_planes=2, shadows=True,
                            **SOFT_KW), 0.5, dev)
    _list_case(LK, BP, SK, "bench headline config, empty scene", empty_scene(20, 4, device=dev),
               cam, cfg_hl, 0.5, dev)
    _list_case(LK, BP, SK, "bench headline", scene_hl, cam, cfg_hl, 0.5, dev, disable=True)
    big = RenderConfig(width=400, height=150, max_spheres=4096, shadows=True)
    for hard in (True, False):  # the engine's largest scene: every slot staged at once
        _list_case(LK, BP, SK, "400x150 random_scene(300) in 4096 sphere slots",
                   random_scene(300, max_spheres=4096, seed=3), cam,
                   big if hard else big.replace(**SOFT_KW), 0.0 if hard else 0.5, dev,
                   shadows=not hard, hard=hard)
    for label, (scene, gcam, cfg, tau, hard) in _grazing_scenes().items():
        ties = _graze_ties(scene, gcam, cfg, tau, hard)
        print(f"phase 8: {label}: near-ties on the host (membership that differs between the "
              f"radii 4 float32 steps down and up; dn_u within 4 steps of +-1e-3; covered "
              f"under the offset scaled by 1 -+ 2^-22) {ties}")
        _list_case(LK, BP, SK, label, scene, gcam, cfg, tau, dev, shadows=not hard, hard=hard)


@contextlib.contextmanager
def _plain_broad_phase():
    """The train step's broad phase in its plain torch version on the card:
    broad_phase.py's lists, entry_tables_plain and zero-filled partial
    tables in place of the two kernels, by swapping the names the soft
    kernels' modules call."""
    import torch

    from rtwc_tpu_torch.render import broad_phase as BP
    from rtwc_tpu_torch.render import list_kernel as LK
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK

    def zeros(lists, shl=None):
        return tuple(None if t is None else torch.zeros_like(t)
                     for t in LK.partial_tables(lists, shl))
    swaps = ((SK, "sphere_tile_lists", BP.sphere_tile_lists),
             (SH, "build_tile_lists", BP.build_tile_lists),
             (SK, "entry_tables", LK.entry_tables_plain), (SK, "partial_tables", zeros))
    kept = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, f in swaps:
            setattr(m, name, f)
        yield
    finally:
        for m, name, f in kept:
            setattr(m, name, f)


def _replay_kernel_names(step) -> list:
    """The names of the device kernels of one replay of a CapturedStep
    (after its warm-up and capture), from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    step()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns a run without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        names = [e.name for e in _device_records(prof)]
        if names:
            return names
    raise AssertionError("the profiler recorded no kernel of the replay in three tries")


def _list_work(sph, pl, lists, shl, aux, ent):
    """(bytes, float32 operations) of one tile_lists launch and of one
    entry_tables launch on these inputs, the least these inputs need, the
    same for any design: tile_lists reads the tables and writes each row's
    count and listed entries (what any consumer reads) and the aux planes,
    with the work LIST_OPS counts; entry_tables reads each row's count and
    listed entries and writes the offsets, the entries, the counts and the
    zeroed rows of the partial tables the gradient kernels fill (8 floats a
    view entry, 4 a shadow entry)."""
    T = lists.shape[0]
    live = int((sph[7] > 0.5).sum())
    live_pl = int((pl[11] > 0.5).sum()) if pl is not None else 0
    n, nsh = (int(x) for x in ent.counts)
    n_lists = 1 if shl is None else 2
    lists_b = _nbytes(sph, pl, *(aux or ())) + 4 * (n_lists * T + n + nsh)
    ops = (live * LIST_OPS["sphere"] + T * LIST_OPS["cone"] + T * live * LIST_OPS["view"])
    if shl is not None:
        ops += (live * LIST_OPS["occluder_sphere"] + T * LIST_OPS["balls"]
                + T * live_pl * LIST_OPS["plane"] + T * live * 8 * LIST_OPS["ball"])
    ent_b = 4 * (n_lists * T + n + nsh) * 2 + _nbytes(ent.counts) + 32 * n + 16 * nsh
    return (lists_b, float(ops)), (ent_b, 0.0)


def _phase_8(dev, tag):
    """The single-dispatch steps: the list kernel against broad_phase.py,
    eager steps under set_sync_debug_mode("error"), CUDA graphs of the train
    step and the display frame against the eager ones, launches a replay,
    eager and graph ms a step. Returns what the kernels line needs."""
    import numpy as np
    import torch

    from rtwc_tpu_torch import bench as B
    from rtwc_tpu_torch.camera import Camera, default_camera
    from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.examples import inverse_render as IR
    from rtwc_tpu_torch.io import FramebufferSink
    from rtwc_tpu_torch.render import broad_phase as BP
    from rtwc_tpu_torch.render import list_kernel as LK
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.render.step_graph import CapturedStep, launch_counts, launch_delta
    from rtwc_tpu_torch.scene import empty_scene, random_scene

    cam = default_camera()
    cam_d = cam.to(dev)
    cfg_hl = RenderConfig(width=1920, height=1080, max_spheres=20, max_planes=4, shadows=True,
                          **SOFT_KW)
    scene_hl = random_scene(20, max_spheres=20, max_planes=4, seed=0, device=dev)
    cfg_4k = cfg_hl.replace(width=3840, height=2160, max_spheres=200)
    scene_4k = random_scene(200, max_spheres=200, max_planes=4, seed=0, device=dev)
    posed = Camera(pos=torch.tensor([3.0, 2.0, -5.0]), rot=torch.tensor([0.25, 2.8, 0.0]))

    # -- 8a: the list kernel against broad_phase.py
    before = launch_counts()
    _list_cases(dev)
    print(f"phase 8: launches of the comparisons {launch_delta(before)}")


    # the list kernels' timings at the bench headline (the train step's shape)
    sph, pl, camv, grid = _list_args(SK, BP, scene_hl, cam_d, cfg_hl, dev)
    lists_fn = lambda: LK.tile_lists_with_aux(sph, pl, camv, cfg_hl, 0.5, 16, 16, grid, True)  # noqa: E731
    lists, shl, aux = lists_fn()
    tables = LK.partial_tables(lists, shl)  # the step's [T NS] partial tables, zeroed below
    ent = LK.entry_tables(lists, shl, *tables)
    plain_tables = [torch.zeros_like(t) for t in tables]
    plain_lists = lambda: LK.tile_lists_plain(sph, pl, camv, cfg_hl, 0.5, 16, 16, grid, True)  # noqa: E731
    timings = {}
    for key, kname, kfn, pfn in (
            ("tile_lists", "tile_lists_kernel", lists_fn, plain_lists),
            ("entry_tables", "entry_tables_kernel", lambda: LK.entry_tables(lists, shl, *tables),
             lambda: LK.entry_tables_plain(lists, shl, *plain_tables))):
        k_ms, p_ms = _time_ms(kfn), _time_ms(pfn, reps=5, warm=1)
        d_ms, g_ms = _kernel_device_ms(kfn, name=kname), _graph_ms(kfn)[0]
        timings[key] = (k_ms, p_ms, d_ms, g_ms)
        print(f"phase 8: {key} ({kname}) at the bench headline: {k_ms!r} ms a call (device "
              f"time alone {d_ms!r} ms, profiler mean; {g_ms!r} ms a call of a CUDA graph of "
              f"20), plain {p_ms!r} ms {tag}")
    work = dict(zip(("tile_lists", "entry_tables"),
                    _list_work(sph, pl, lists, shl, aux, ent)))
    sph4, pl4, camv4, grid4 = _list_args(SK, BP, scene_4k, cam_d, cfg_4k, dev)
    fn4 = lambda: LK.tile_lists_with_aux(sph4, pl4, camv4, cfg_4k, 0.5, 16, 16, grid4, True)  # noqa: E731
    l4 = fn4()
    tables4 = LK.partial_tables(l4[0], l4[1])
    ent4 = LK.entry_tables(l4[0], l4[1], *tables4)
    work_4k = dict(zip(("tile_lists", "entry_tables"), _list_work(sph4, pl4, *l4, ent4)))
    ent4_fn = lambda: LK.entry_tables(l4[0], l4[1], *tables4)  # noqa: E731
    dev_4k = {"tile_lists": _kernel_device_ms(fn4, reps=5, name="tile_lists_kernel"),
              "entry_tables": _kernel_device_ms(ent4_fn, reps=5, name="entry_tables_kernel")}
    graph_4k = {"tile_lists": _graph_ms(fn4)[0], "entry_tables": _graph_ms(ent4_fn)[0]}
    print(f"phase 8: at 3840x2160 random_scene(200): tile_lists {dev_4k['tile_lists']!r} ms, "
          f"entry_tables {dev_4k['entry_tables']!r} ms device time (profiler mean); "
          f"{graph_4k['tile_lists']!r} / {graph_4k['entry_tables']!r} ms a call of a CUDA graph "
          f"of 20 {tag}")

    # -- 8b: eager steps of the four train paths and a display frame, no host sync
    cfg20, scene20 = IR.build(1920, 1080, 20)
    scene20 = scene20.to(dev)
    with torch.no_grad():
        fb20 = SK.render_frame_soft_kernel(scene20, cam_d, cfg20, tau=0.5)
    tgt20, tgt_a20 = fb20.rgb, fb20.alpha
    start20 = scene20.replace(spheres=scene20.spheres.replace(
        center=_fit_start(scene20.spheres.center)))
    zero_hl = torch.zeros((1080, 1920, 3), device=dev)
    paths = {"unshadowed generic": (cfg20, start20, tgt20, False),
             "unshadowed fused": (cfg20, start20, tgt20, True),
             "shadowed generic": (cfg_hl, scene_hl, zero_hl, False),
             "shadowed fused": (cfg_hl, scene_hl, zero_hl, True)}
    replay = {}
    for label, (cfg, scene, target, fused) in paths.items():
        step = B.train_step(cfg, scene, cam_d, target, fused=fused, graph=False)
        step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        g = B.train_step(cfg, scene, cam_d, target, fused=fused, graph=True)
        g()
        replay[label] = g.replay_launches
        print(f"phase 8: {label} train step: an eager step from pack to opt.step() ran under "
              f"set_sync_debug_mode('error'); launches a replay of its CUDA graph "
              f"{g.replay_launches}")
    # the fits' step: the render, inverse_render's loss, torch's default Adam
    c = start20.spheres.center.clone().requires_grad_(True)

    def fit_loss():
        fb = SK.render_frame_soft_kernel(start20.replace(spheres=start20.spheres.replace(center=c)),
                                         cam_d, cfg20, tau=0.5)
        return IR.loss_of(fb, tgt20, tgt_a20, 1.0, False)
    fit_step = CapturedStep(fit_loss, torch.optim.Adam([c], lr=3e-2), graph=False)
    fit_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("phase 8: inverse_render's step (render, RGB + IoU loss, backward, torch's default "
          "Adam) ran eagerly under set_sync_debug_mode('error')")
    hi_sh = RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII, supersample=2,
                         shadows=True)
    no_spawn = EngineConfig(spawn=False, show_fps=False, seed=1)
    eng = Engine(hi_sh, no_spawn, scene=random_scene(100, seed=0), presenter=FramebufferSink(),
                 interactive=False, device=dev, graph=False)
    eng.device_frame(0.016)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.device_frame(0.016)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("phase 8: an eager display frame at 1920x500 x2 with shadows (physics, pack, lists, "
          "K7, downsample, cells, the encode) ran under set_sync_debug_mode('error')")

    # a replay of the fused headline step: two broad-phase launches, no fill
    # of a [T NS] partial table (counted at the capture), no scan kernel
    broad = {k: v for k, v in replay["shadowed fused"].items()
             if k in ("tile_lists", "entry_tables", "partial_fill")}
    if broad != {"tile_lists": 1, "entry_tables": 1}:
        raise AssertionError(f"a replay of the fused headline step launches {broad} of the broad "
                             f"phase (want tile_lists 1, entry_tables 1, no partial_fill)")
    names = _replay_kernel_names(B.train_step(cfg_hl, scene_hl, cam_d, zero_hl, graph=True))
    scans = sorted({n for n in names if "scan" in n.lower() or "cumsum" in n.lower()})
    if scans:
        raise AssertionError(f"a replay of the fused headline step runs scan kernels {scans}")
    fills = sum("fill" in n.lower() for n in names)
    print(f"phase 8: a replay of the fused headline step: broad-phase launches {broad} (counters "
          f"at the capture; no partial_fill: no [T NS] table filled), {len(names)} kernel "
          f"records, none a scan or cumsum, {fills} fill kernels (the [T, NP, 12] and [T, 13, 2] "
          f"partials, the gates and the like)")

    # -- 8c: graph against eager, bit for bit
    for label, (cfg, scene, target, fused), n in (
            ("shadowed fused, bench headline", paths["shadowed fused"], 10),
            ("unshadowed generic from _fit_start", paths["unshadowed generic"], 10)):
        runs = []
        for graph in (False, True):
            step = B.train_step(cfg, scene, cam_d, target, fused=fused, graph=graph)
            losses = [step().clone() for _ in range(n)]
            runs.append((torch.stack(losses), [p.detach().clone()
                                               for p in step.opt.param_groups[0]["params"]]))
        (le, pe), (lg, pg) = runs
        if not (torch.equal(le, lg) and all(torch.equal(a, b) for a, b in zip(pe, pg))):
            raise AssertionError(f"{label}: {n} graph-replayed steps differ from eager ones "
                                 f"(losses {le.tolist()} vs {lg.tolist()})")
        print(f"phase 8: {label}: {n} graph-replayed steps torch.equal to {n} eager ones in "
              f"every loss ({float(le[0])!r} -> {float(le[-1])!r}) and all {len(pe)} parameters")
    # the card's broad phase against the plain one (broad_phase.py,
    # entry_tables_plain, zero-filled partial tables), eagerly: the plain
    # version copies host constants, which a capture refuses
    for label, cfg, scene, target in (
            ("shadowed fused, bench headline", cfg_hl, scene_hl, zero_hl),
            ("shadowed fused, 3840x2160 random_scene(200)", cfg_4k, scene_4k,
             torch.zeros((2160, 3840, 3), device=dev))):
        runs = []
        for plain in (False, True):
            with _plain_broad_phase() if plain else contextlib.nullcontext():
                step = B.train_step(cfg, scene, cam_d, target, graph=not plain)
                losses = torch.stack([step().clone() for _ in range(10)])
            runs.append((losses, [p.detach().clone() for p in step.opt.param_groups[0]["params"]]))
        (lk, pk), (lp, pp) = runs
        if not (torch.equal(lk, lp) and all(torch.equal(a, b) for a, b in zip(pk, pp))):
            raise AssertionError(f"{label}: 10 replayed steps with the card's broad phase differ "
                                 f"from 10 with the plain one (losses {lk.tolist()} vs "
                                 f"{lp.tolist()})")
        print(f"phase 8: {label}: 10 graph-replayed steps with the list kernel, the entry tables "
              f"and uninitialised partial tables zeroed below the counts torch.equal to 10 steps "
              f"with the plain broad phase and zero-filled tables, in every loss "
              f"({float(lk[0])!r} -> {float(lk[-1])!r}) and all {len(pk)} parameters")
    # inverse_render.fit: a graph of render, loss and backward a stage (the
    # key changes at the stage), torch's default Adam after each replay
    fits = []
    for graph in (False, True):
        c = start20.spheres.center.clone().requires_grad_(True)
        args = lambda c=c: (start20.replace(spheres=start20.spheres.replace(center=c)), cam_d)  # noqa: E731
        _, log = IR.fit(args, [c], [(2.0, cfg20), (0.5, cfg20)], 12, 3e-2, tgt20, tgt_a20, 1.0,
                        False, graph=graph)
        fits.append(([e["loss"] for e in log], c.detach().clone()))
    if not (fits[0][0] == fits[1][0] and torch.equal(fits[0][1], fits[1][1])):
        raise AssertionError(f"inverse_render.fit: 12 graph-replayed steps differ from eager "
                             f"ones (stage losses {fits[0][0]} vs {fits[1][0]})")
    print(f"phase 8: inverse_render.fit at 1920x1080, 20 spheres from _fit_start, 12 steps over "
          f"2 stages: graph (a capture a stage, default Adam after each replay) torch.equal to "
          f"eager in every stage loss {fits[0][0]} and every centre")
    engines = [Engine(hi_sh, no_spawn, scene=random_scene(100, seed=0), presenter=FramebufferSink(),
                      interactive=False, device=dev, graph=graph) for graph in (True, False)]
    cap0 = engines[0].scene.spheres.capacity
    for i in range(50):
        if i in (20, 35):  # a capacity doubling, then a spawn into the grown scene
            for e in engines:
                e._spawn()
        (cells_g, (buf_g, n_g)), (cells_e, (buf_e, n_e)) = [e.device_frame(0.016)[:2]
                                                            for e in engines]
        n = int(n_e)
        if not (all(torch.equal(a, b) for a, b in zip(cells_g, cells_e))
                and torch.equal(n_g, n_e) and torch.equal(buf_g[:n], buf_e[:n])):
            raise AssertionError(f"display frame {i}: the graph's cells or stream differ from "
                                 f"eager ones")
    disp = engines[0].display
    cap1 = engines[0].scene.spheres.capacity
    if not (cap1 == 2 * cap0 and disp.captures == 2
            and torch.equal(engines[0].scene.spheres.center, engines[1].scene.spheres.center)):
        raise AssertionError(f"display graph: capacity {cap0} -> {cap1}, captures "
                             f"{disp.captures}")
    print(f"phase 8: 50 engine frames at 1920x500 x2 with shadows, a capacity doubling "
          f"({cap0} -> {cap1} spheres) at frame 20 and a spawn at 35: every frame's cells and "
          f"encoded stream torch.equal to the eager engine's; {disp.captures} captures; launches a replay "
          f"{disp.replay_launches}")

    # -- 8d: eager and graph ms a step, the lists' and pack's host cost
    ms = {}
    for label, cfg, scene, target, reps in (
            ("headline", cfg_hl, scene_hl, zero_hl, 20),
            ("4k200", cfg_4k, scene_4k, torch.zeros((2160, 3840, 3), device=dev), 5),
            ("empty", cfg_hl, empty_scene(20, 4, device=dev), zero_hl, 20)):
        rays = cfg.width * cfg.height
        for graph in (False, True, True, False):
            step = B.train_step(cfg, scene, cam_d, target, graph=graph)
            t = _step_ms(step, reps)
            ms.setdefault(label, {}).setdefault("graph" if graph else "eager", []).append(t)
        if label == "headline":  # the fits' form: torch's default Adam after each replay
            leaves, rebuild = B._leaves(scene, cam_d)
            loss_of = B._loss(cfg, target, True, True, True)
            step = CapturedStep(lambda: loss_of(*rebuild()), torch.optim.Adam(leaves, lr=1e-3),
                                graph=True)
            ms[label]["graph, default Adam after the replay"] = [_step_ms(step, reps)]
        print(f"phase 8: shadowed fused step {label} ({cfg.width}x{cfg.height}): eager "
              f"{ms[label]['eager']} ms, graph {ms[label]['graph']} ms a step (in turns); "
              f"graph {rays / min(ms[label]['graph']) * 1e3!r} rays/s; "
              f"{ {k: v for k, v in ms[label].items() if k not in ('eager', 'graph')} } {tag}")
    for label, cfg, scene, target, reps in (
            ("headline", cfg_hl, scene_hl, zero_hl, 20),
            ("empty", cfg_hl, empty_scene(20, 4, device=dev), zero_hl, 20),
            ("4k200", cfg_4k, scene_4k, torch.zeros((2160, 3840, 3), device=dev), 5)):
        _profile_steps(B.train_step(cfg, scene, cam_d, target, graph=True),
                       f"profile_graph_{label}", f"shadowed fused step {label}, graph-replayed",
                       tag, reps=reps, phase="8")
    _profile_steps(lambda: engines[0].device_frame(0.016), "profile_graph_display",
                   "display frame 1920x500 x2 shadows, graph-replayed", tag, phase="8")
    lp = _step_ms(B.lists_loop(cfg_hl, 16, scene_hl, cam_d), 5) / 16
    print(f"phase 8: lists_pack_ms (pack and both lists, eager, 16 a sync) at the bench "
          f"headline: {lp!r} ms {tag}")
    return {"timings": timings, "work": work, "work_4k": work_4k, "dev_4k": dev_4k,
            "graph_4k": graph_4k,
            "replay": replay, "display_replay": disp.replay_launches, "step_ms": ms,
            "lists_pack_ms": lp}


def _collective_calls(host: dict) -> dict:
    """The host's collective calls a step in a profile's host records
    (c10d's all-reduce and all-gather, NCCL's)."""
    return {k: v for k, v in host.items()
            if any(w in k.lower() for w in ("allreduce", "all_reduce", "allgather",
                                             "all_gather", "nccl"))}


def _phase_9_rank() -> int:
    """Phase 9's process: one NCCL rank over a TCP store on cuda:0, the
    sharded step and frame with their collectives inside one CUDA graph
    each. Prints its lines, then one line "PHASE9 {json}" of the launches
    counted over each NCCL graph run (the counts set to 0 just before it)
    and the ms a step and a frame. Run by _phase_9 in a subprocess, so no
    process group outlives it."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from rtwc_tpu_torch.benchmarks.scaling import _free_port
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.dist import (initialize_multihost, make_mesh, make_sharded_train_step,
                                     render_frame_sharded)
    from rtwc_tpu_torch.dist import mesh as MESH
    from rtwc_tpu_torch.render import hard_kernel as HK
    from rtwc_tpu_torch.render.step_graph import (launch_counts, launch_delta,
                                                  reset_launch_counts)
    from rtwc_tpu_torch.scene import random_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tag = f"[{_card_line()}]"
    if not initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0, "nccl"):
        raise AssertionError("phase 9: initialize_multihost declined")
    mesh = make_mesh(2)
    if dist.get_backend(mesh.group) != "nccl" or mesh.world != 1 or mesh.size != 2:
        raise AssertionError(f"phase 9: mesh {mesh} over {dist.get_backend(mesh.group)}")
    print(f"phase 9: one NCCL rank (torch {torch.__version__}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}) over a TCP store on cuda:0, "
          f"make_mesh(2): 2 bands on 1 process")
    alone = MESH.Mesh(2)  # the same bands with no group
    cfg_s = RenderConfig(width=1920, height=1080, max_spheres=100, max_planes=4, shadows=True,
                         **SOFT_KW)
    scene_s = random_scene(100, max_spheres=100, max_planes=4, seed=0, device=dev)
    cam = default_camera().to(dev)
    tgt = torch.zeros((1080, 1920, 3), device=dev)
    tick = 1.0 / 60.0
    out = {"launches": {}, "ms": {}}

    def steps(kind, m, graph, n):
        """n steps from the same start: losses, leaves, the launches of the
        first step and those counted over the rest, the step and its state."""
        step = make_sharded_train_step(
            cfg_s, m, tau=0.5, backend="pallas", animate=True, graph=graph,
            loss_scale=1.0 / 255.0 if kind == "fused" else 1.0 / 256.0)
        box = [(scene_s, cam), None]
        box[1] = step.init(box[0])
        before = launch_counts()
        box[0], box[1], loss = step(box[0], box[1], tgt, tick)
        torch.cuda.synchronize()
        first, losses = launch_delta(before), [loss]
        before = launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(n - 1):
                box[0], box[1], loss = step(box[0], box[1], tgt, tick)
                losses.append(loss)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rest = launch_delta(before)
        return (torch.stack(losses), [v.detach().clone() for v in box[1].leaves.values()],
                first, rest, step, box)

    kernels = {"fused": ("soft_sh_mse",), "generic": ("soft_sh_fwd", "soft_sh_bwd")}
    for kind, n in (("fused", 10), ("generic", 3)):
        le, pe, eager_counts, _, _, est = steps(kind, mesh, False, n)
        reset_launch_counts()
        lg, pg, _, replay_counted, gstep, gbox = steps(kind, mesh, None, n)
        torch.cuda.synchronize()
        out["launches"][kind] = {k: v for k, v in launch_counts().items() if v}
        la, pa, _, _, astep, abox = steps(kind, alone, None, n)
        gst = gbox[1]
        want = {k: 2 for k in kernels[kind] + ("soft_grad_reduce", "tile_lists", "entry_tables")}
        if len(gst.phases) != 1 or gst.phases[0].captures != 1 or len(est[1].phases) != 1:
            raise AssertionError(f"phase 9: {kind} NCCL step: {len(gst.phases)} phases, "
                                 f"{gst.phases[0].captures} captures")
        if eager_counts != want or gst.replay_launches != want or replay_counted:
            raise AssertionError(f"phase 9: {kind} NCCL step: an eager step launched "
                                 f"{eager_counts}, a replay {gst.replay_launches} (counted "
                                 f"while replaying: {replay_counted}); want {want}")
        for label, (l2, p2) in (("eager NCCL", (le, pe)), ("group-less graph", (la, pa))):
            if not (torch.equal(lg, l2) and all(torch.equal(a, b) for a, b in zip(pg, p2))):
                raise AssertionError(f"phase 9: {kind} NCCL step: {n} replayed steps differ "
                                     f"from {n} {label} steps ({lg.tolist()} vs {l2.tolist()})")
        print(f"phase 9: {kind} shadowed animated step at the scaling defaults on the NCCL "
              f"mesh (2 bands): {n} steps as one CUDA graph with the all-reduce inside (1 "
              f"phase, 1 capture, {n - 1} replays under set_sync_debug_mode('error')) "
              f"torch.equal to {n} eager steps (graph=False) and to {n} steps of the group-less "
              f"graph, every loss ({float(lg[0])!r} -> {float(lg[-1])!r}) and all {len(pg)} "
              f"leaves; a replay launches {gst.replay_launches}, an eager step "
              f"{eager_counts}, nothing counted while replaying")
        if kind != "fused":
            continue

        def nccl_step(box=gbox, step=gstep):
            box[0], box[1], _ = step(box[0], box[1], tgt, tick)

        def alone_step(box=abox, step=astep):
            box[0], box[1], _ = step(box[0], box[1], tgt, tick)

        dev_n, host_n = _profile_steps(nccl_step, "profile_graph_nccl", "NCCL one-graph "
                                       "sharded step (2 bands, 1 rank), replayed", tag,
                                       phase="9")
        dev_a, host_a = _profile_steps(alone_step, "profile_graph_nccl_alone", "group-less "
                                       "sharded step (2 bands), replayed", tag, phase="9")
        nccl_dev = {k: v for k, v in dev_n.items() if "nccl" in k.lower()}
        calls = _collective_calls(host_n)
        graph_launches = host_n.get("cudaGraphLaunch", 0.0)
        if graph_launches != 1.0 or calls:
            raise AssertionError(f"phase 9: a replayed NCCL step makes {graph_launches} graph "
                                 f"launches and these collective calls from the host: {calls}")
        print(f"phase 9: a replayed NCCL step from the host: {graph_launches!r} cudaGraphLaunch, "
              f"{host_n.get('cudaLaunchKernel', 0.0)!r} cudaLaunchKernel (group-less "
              f"{host_a.get('cudaLaunchKernel', 0.0)!r}), no collective call; on the "
              f"device NCCL's own records {nccl_dev or 'none'}, kernels only in the NCCL step's "
              f"profile {sorted(set(dev_n) - set(dev_a)) or 'none'}")
        ms = {"nccl": [], "alone": []}
        for which in ("nccl", "alone", "alone", "nccl"):  # in turns
            ms[which].append(_step_ms(nccl_step if which == "nccl" else alone_step, 20))
        out["ms"]["step"] = ms
        print(f"phase 9: ms a replayed step, fused, 2 bands: NCCL one graph {ms['nccl']}, "
              f"group-less graph {ms['alone']} (in turns) {tag}")

    # the sharded frame over 2 bands, its all-gather in the graph
    cfg = RenderConfig(width=1920, height=1080, shadows=True)
    scene = random_scene(20, seed=0, device=dev)
    cam0 = default_camera()
    single = HK.render_frame_kernel(scene, cam0, cfg)
    fields = ("rgb", "normal", "depth", "shading", "hit", "coverage", "alpha")
    reset_launch_counts()
    ptrs = []
    for i in range(3):  # the warm-up and capture, then two replays
        fr = render_frame_sharded(scene, cam0, cfg, mesh, backend="pallas")
        if not all(torch.equal(getattr(fr, f), getattr(single, f)) for f in fields):
            raise AssertionError(f"phase 9: NCCL sharded frame {i} differs from "
                                 f"render_frame_kernel")
        ptrs.append(fr.rgb.data_ptr())
    torch.cuda.synchronize()
    out["launches"]["frame"] = {k: v for k, v in launch_counts().items() if v}
    fg = MESH._frame_graph(cfg, 2, range(2), scene.device, mesh.group)
    if not fg.gathers or fg.call.captures != 1 or fg.call.replay_launches != {
            "hard_render": 2, "tile_lists": 2} or ptrs[1] != ptrs[2]:
        raise AssertionError(f"phase 9: NCCL frame: gathers {fg.gathers}, {fg.call.captures} "
                             f"captures, a replay launches {fg.call.replay_launches}")
    _, host_f = _profile_steps(lambda: render_frame_sharded(scene, cam0, cfg, mesh,
                                                            backend="pallas"),
                               "profile_graph_nccl_frame", "NCCL sharded frame (2 bands), "
                               "replayed", tag, phase="9")
    calls = _collective_calls(host_f)
    if host_f.get("cudaGraphLaunch", 0.0) != 1.0 or calls:
        raise AssertionError(f"phase 9: a replayed NCCL frame: {host_f.get('cudaGraphLaunch')} "
                             f"graph launches, collective calls {calls}")
    fms = {"nccl": [], "alone": []}
    for which in ("nccl", "alone", "alone", "nccl"):
        m = mesh if which == "nccl" else alone
        fms[which].append(_step_ms(lambda: render_frame_sharded(scene, cam0, cfg, m,
                                                                backend="pallas"), 20))
    out["ms"]["frame"] = fms
    print(f"phase 9: render_frame_sharded over 2 bands on the NCCL mesh as one CUDA graph with "
          f"its all-gather inside (a capture, two replays): every frame torch.equal to "
          f"render_frame_kernel in all 7 fields, the replays' fields the graph's own buffers; a "
          f"replay launches {fg.call.replay_launches}, one cudaGraphLaunch and no collective "
          f"call from the host; ms a frame NCCL {fms['nccl']}, group-less {fms['alone']} "
          f"(in turns) {tag}")
    del fg, gstep, gbox, astep, abox
    MESH._frame_graph.cache_clear()  # no graph of the group outlives it
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print("PHASE9 " + json.dumps(out), flush=True)
    return 0


def _phase_9(tag: str) -> dict:
    """Phase 9: the NCCL path on the card (dist/mesh.py's one-graph
    layout). In a subprocess (_phase_9_rank): a one-rank NCCL group over a
    TCP store and make_mesh(2) over it; 10 fused and 3 generic shadowed
    steps at the scaling defaults as one CUDA graph each, the all-reduce
    inside, under set_sync_debug_mode("error") after the capture,
    torch.equal to eager steps and to the group-less graph's; a replay's
    launches equal an eager step's, nothing counted while replaying, one
    graph launch and no collective call from the host a step (profiler);
    the sharded frame over 2 bands with its all-gather in the graph, one
    capture, two replays, each torch.equal to render_frame_kernel. Then the
    scaling entry point spawned as one NCCL rank and under torchrun (exit
    0, one CUDA graph a step, ms a step); `--ranks 2 --dist-backend nccl`,
    refused on one card with initialize_multihost's message, run and held
    bit-equal on two or more; `--ranks 4` likewise on four or more, a card
    a rank. Returns the launches of each NCCL graph run
    by kernel."""
    import torch

    os.makedirs(OUT_DIR, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c",
                           "import sys, chip_smoke as C; sys.exit(C._phase_9_rank())"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    with open(os.path.join(OUT_DIR, "nccl_phase9.log"), "w") as f:
        f.write(proc.stdout + "\n" + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"phase 9's NCCL rank exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    res = None
    for line in proc.stdout.splitlines():
        if line.startswith("PHASE9 "):
            res = json.loads(line[7:])
        elif line.startswith("phase 9"):
            print(line)
    if res is None:
        raise AssertionError("phase 9's NCCL rank printed no result")

    per_rank = {"soft_sh_mse": 1, "soft_grad_reduce": 1, "tile_lists": 1, "entry_tables": 1}
    runs = {"spawned": ["-m", "rtwc_tpu_torch.benchmarks.scaling", "--ranks", "1"],
            "torchrun": ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
                         "-m", "rtwc_tpu_torch.benchmarks.scaling"]}
    cards = torch.cuda.device_count()
    for n in (2, 4):
        if cards >= n:
            runs[f"{n} ranks"] = ["-m", "rtwc_tpu_torch.benchmarks.scaling", "--ranks", str(n),
                                  "--sizes", str(n)]
    res["scaling"] = {}
    for label, argv in runs.items():
        cmd = [sys.executable] + argv + ["--dist-backend", "nccl", "--iters", "10"]
        t = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t
        with open(os.path.join(OUT_DIR, f"scaling_nccl_{label.replace(' ', '_')}.log"),
                  "w") as f:
            f.write(p.stderr + "\n" + p.stdout)
        if p.returncode != 0:
            raise AssertionError(f"phase 9: {' '.join(cmd[1:])} exited {p.returncode}: "
                                 f"{p.stderr[-3000:]}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        for row in rec["results"]:
            if not (row["graph"] and set(row["phases"]) == {1}
                    and all(lc == per_rank for lc in row["replay_launches"])
                    and not any(row["launches_per_step"]) and row["losses_bit_equal"]
                    and row["params_bit_equal"]):
                raise AssertionError(f"phase 9: {label} NCCL scaling row {row}")
            res["scaling"][label] = row["ms_per_step"]
            print(f"phase 9: {' '.join(cmd[1:])}: exit 0 in {secs:.1f} s, mesh {row['mesh']}, "
                  f"{row['ms_per_step']!r} ms a step, one CUDA graph a step with the "
                  f"all-reduce inside, a replay launches {row['replay_launches']}, losses "
                  f"{row['losses'][0]!r} -> {row['losses'][-1]!r} {tag}")
    if cards < 2:
        cmd = [sys.executable, "-m", "rtwc_tpu_torch.benchmarks.scaling", "--ranks", "2",
               "--dist-backend", "nccl", "--iters", "2"]
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        want = ("nccl needs a card a rank: 2 ranks on this host, 1 cards (ranks that share a "
                "card take backend='gloo')")
        if p.returncode == 0 or p.stderr.strip().splitlines()[-1:] != [want] or p.stdout \
                or "Traceback" in p.stderr:
            raise AssertionError(f"phase 9: {' '.join(cmd[1:])} on one card: exit "
                                 f"{p.returncode}, stderr {p.stderr[-2000:]!r}")
        print(f"phase 9: {' '.join(cmd[1:])} on one card: refused as expected, exit "
              f"{p.returncode}, before any rank started: {want!r}")
        print(f"phase 9: 2 NCCL ranks not run: {cards} card on this machine, and NCCL refuses "
              f"two ranks on one device")
    return res["launches"]


def _encode_cases(dev) -> dict:
    """Cells for the device encode on the card: the engine's 1920x500
    frame (2x supersampling, shadows, 100 spheres) in every mode, and
    seeded cells with runs across rows at 1920x500 and at 1917x501 (a
    width no multiple of 4: the kernel's scalar loads), one row, one
    column, one cell, and every digit count in every channel."""
    import numpy as np
    import torch

    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig, RenderMode
    from rtwc_tpu_torch.engine.engine import _render_step
    from rtwc_tpu_torch.scene import random_scene

    cases = {}
    for mode in (RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
                 RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS):
        cfg = RenderConfig(width=1920, height=500, mode=mode, supersample=2, shadows=True)
        _, cells = _render_step(random_scene(100, seed=0, device=dev), default_camera(), 0.016,
                                cfg)
        cases[f"engine 1920x500 {mode.value}"] = cells
    rng = np.random.default_rng(19)

    def seeded(H, W, truecolor):
        kind = rng.integers(0, 2, size=(H, W))
        color = rng.integers(0, 256, size=(H, W, 3) if truecolor else (H, W))
        flat_k, flat_c = kind.reshape(-1), color.reshape(H * W, -1)
        start = 0
        while start < H * W:  # constant runs of up to three rows
            end = start + int(rng.integers(1, 3 * W + 2))
            flat_k[start:end] = flat_k[start]
            flat_c[start:end] = flat_c[start]
            start = end
        char = rng.integers(32, 127, size=(H, W))
        return tuple(torch.from_numpy(c.astype(np.int32)).to(dev) for c in (kind, color, char))

    vals = np.array([0, 9, 10, 99, 100, 255])
    digits = np.stack(np.meshgrid(vals, vals, vals, indexing="ij"), -1).reshape(12, 18, 3)
    for tc in (False, True):
        name = "truecolor" if tc else "ansi256"
        for H, W in ((500, 1920), (501, 1917), (1, 1920), (500, 1), (1, 1)):
            cases[f"seeded {name} {W}x{H}"] = seeded(H, W, tc)
        color = digits if tc else np.tile(vals, 6).reshape(4, 9)
        H, W = color.shape[:2]
        kind = (np.arange(H * W) // 7 % 2).reshape(H, W)
        cases[f"digits {name}"] = tuple(torch.from_numpy(c.astype(np.int32)).to(dev) for c in
                                        (kind, color, np.full((H, W), 35)))
    return cases


def _phase_3e(dev, tag: str) -> dict:
    """Phase 3e: the device encode (csrc/ansi_encode.cu). The kernel's
    stream against the plain version's on the card and the native C++
    encoder's, in every `_encode_cases` case; two engines at 1920x500 x2
    with shadows, graph and eager, frame by frame through spawns (a
    capacity doubling) and mode switches: the same published bytes, equal
    to the C++ encoder's on the frame's cells, one `encode.device` a
    published frame, a capture for each mode and capacity; the kernel's
    device time (a CUDA graph of 20 calls, the profiler's records of its
    two kernels) at 1920x500 in 256 colours and in truecolor, beside its
    bound and the plain version's time."""
    import torch

    from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.heads import device_encode as DE
    from rtwc_tpu_torch.io import FramebufferSink
    from rtwc_tpu_torch.io.native import encode_frame_native
    from rtwc_tpu_torch.scene import random_scene
    from rtwc_tpu_torch.utils import telemetry

    out = {"streams": {}}
    cases = _encode_cases(dev)
    for label, cells in cases.items():
        buf, n = DE.encode_cells(*cells)
        pbuf, pn = DE.encode_cells_plain(*cells)
        torch.cuda.synchronize()
        n, pn = int(n), int(pn)
        host = [c.cpu().numpy() for c in cells]
        want = encode_frame_native(*host)
        got = bytes(buf[:n].cpu().numpy())
        if not (n == pn == len(want) and torch.equal(buf[:n], pbuf[:n]) and got == want):
            raise AssertionError(f"{label}: the kernel's stream ({n} B) differs from the plain "
                                 f"version's ({pn} B) or the C++ encoder's ({len(want)} B)")
        out["streams"][label] = n
        print(f"phase 3e: {label}: the kernel's {n} B equal the plain version's and the C++ "
              f"encoder's (bound {buf.numel()} B)")

    hi = RenderConfig(width=1920, height=500, mode=RenderMode.BIT_PIXEL, supersample=2,
                      shadows=True)
    no_spawn = EngineConfig(spawn=False, show_fps=False, seed=1)
    sinks = [FramebufferSink(keep_all=True) for _ in range(2)]
    engines = [Engine(hi, no_spawn, scene=random_scene(100, seed=0), presenter=sink,
                      interactive=False, device=dev, graph=graph)
               for sink, graph in zip(sinks, (True, False))]
    switches = {10: RenderMode.RGB_PIXEL, 20: RenderMode.BIT_ASCII, 30: RenderMode.RGB_ASCII,
                40: RenderMode.RGB_NORMALS, 50: RenderMode.BIT_PIXEL}
    spawns = (15, 35)
    before = telemetry.counters().get("encode.device", 0)
    copies = DE.LAUNCHES["ansi_copy"]
    cap0 = engines[0].scene.spheres.capacity
    n_frames = 60
    for i in range(n_frames):
        for e in engines:
            if i in switches:
                e.rcfg = e.rcfg.replace(mode=switches[i])
            if i in spawns:
                e._spawn()
        frames = [e.device_frame(0.016) for e in engines]
        downs = [e._start_download(f) for e, f in zip(engines, frames)]
        for e, d in zip(engines, downs):
            e._publish(d)
        want = encode_frame_native(*(c.cpu().numpy() for c in frames[1].cells))
        if not sinks[0].frames[-1] == sinks[1].frames[-1] == want:
            raise AssertionError(f"engine frame {i} ({engines[0].rcfg.mode.value}): the graph's "
                                 f"and the eager engine's bytes differ, or differ from the C++ "
                                 f"encoder's on the same cells")
    counted = telemetry.counters().get("encode.device", 0) - before
    copies = DE.LAUNCHES["ansi_copy"] - copies
    cap1 = engines[0].scene.spheres.capacity
    disp = engines[0].display
    grows = int(cap1 > cap0)
    if not (counted == copies == 2 * n_frames and grows
            and disp.captures == 1 + len(switches) + grows
            and disp.replay_launches.get("ansi_encode") == 2
            and "ansi_copy" not in disp.replay_launches):
        raise AssertionError(f"encode.device {counted} and {copies} copies over {n_frames} "
                             f"frames of two engines, capacity {cap0} -> {cap1}, captures "
                             f"{disp.captures}, a replay launches {disp.replay_launches}")
    print(f"phase 3e: {n_frames} frames of two engines at 1920x500 x2 shadows (graph, eager) "
          f"through 5 mode switches and 2 spawns (capacity {cap0} -> {cap1}): published bytes "
          f"equal, and equal to the C++ encoder's on the eager frame's cells; encode.device "
          f"{counted}, copies {copies}; {disp.captures} captures; a replay launches "
          f"{disp.replay_launches}")

    for label, key in (("ansi256", "engine 1920x500 bit_pixel"),
                       ("truecolor", "engine 1920x500 rgb_pixel")):
        cells = cases[key]
        n = out["streams"][key]
        graph_ms, runs = _graph_ms(lambda: DE.encode_cells(*cells))
        kernels_ms = _kernel_device_ms(lambda: DE.encode_cells(*cells), name="ansi_",
                                       per_call=True)
        plain_ms = _time_ms(lambda: DE.encode_cells_plain(*cells), reps=5, warm=1)
        stream = DE.encode_cells(*cells)
        host = (torch.empty(stream[0].numel(), dtype=torch.uint8, pin_memory=True),
                torch.empty(1, dtype=torch.int64, pin_memory=True))
        copy_ms = _kernel_device_ms(lambda: DE.copy_to_host(stream, *host), name="ansi_copy")
        memcpy_ms = _kernel_device_ms(lambda: host[0].copy_(stream[0], non_blocking=True),
                                      name="Memcpy")
        DE.copy_to_host(stream, *host)
        torch.cuda.synchronize()
        if bytes(host[0][:n].numpy()) != bytes(stream[0][:n].cpu().numpy()) or int(host[1]) != n:
            raise AssertionError(f"{key}: the copy kernel's host bytes differ from the stream")
        nbytes = sum(c.numel() * c.element_size() for c in cells) + n
        bound_ms = nbytes / 3.35e12 * 1e3
        out[label] = {"graph_ms": graph_ms, "kernels_ms": kernels_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bytes": nbytes, "stream_bytes": n,
                      "copy_ms": copy_ms, "bound_memcpy_ms": memcpy_ms}
        print(f"phase 3e: encode {key}: device {kernels_ms!r} ms (its two kernels, profiler), "
              f"graph {graph_ms!r} ms a call (runs {runs}); bound {bound_ms!r} ms (bytes: "
              f"{nbytes / 1e6:.2f} MB, the cells read once and {n} B written); plain version "
              f"{plain_ms!r} ms; the download: the copy kernel {copy_ms!r} ms for {n} B, a "
              f"memcpy of the whole {stream[0].numel()} B bound {memcpy_ms!r} ms {tag}")
    return out


def _phase_3h(dev, tag: str) -> dict:
    """Phase 3h: the heads kernel (csrc/cell_heads.cu). Its cells against
    the plain version's (the engine's torch heads) on the same K7 planes of
    random_scene(100) with shadows, in all five modes at 1920x500 x2,
    400x150 x1, 401x151 x3 and 320x100 x4 (the general path): kind, colour
    and char equal (the cells whose colour differs counted); a graph and an
    eager engine at 1920x500 x2 through mode switches: the same cells and
    bytes, one `heads.device` a published frame, one launch a replay; the
    kernel's device time (profiler records, and a CUDA graph of 20 calls)
    beside its bound and the plain version's (a CUDA graph of 20 chains),
    in bit_pixel and rgb_pixel."""
    import torch

    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.heads import device_heads as DH
    from rtwc_tpu_torch.io import FramebufferSink
    from rtwc_tpu_torch.render import hard_kernel as HK
    from rtwc_tpu_torch.render import pack as P
    from rtwc_tpu_torch.render.reference import supersampled_config
    from rtwc_tpu_torch.scene import random_scene
    from rtwc_tpu_torch.utils import telemetry

    modes = (RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
             RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS)
    scene = random_scene(100, seed=0, device=dev)
    cam = P.pack_camera(default_camera(), dev)
    out = {"color_diffs": {}}
    planes = {}
    for w, h, ss in ((1920, 500, 2), (400, 150, 1), (401, 151, 3), (320, 100, 4)):
        cfg = RenderConfig(width=w, height=h, supersample=ss, shadows=True)
        planes[(w, h, ss)] = HK.render_planes_packed(scene, cam, supersampled_config(cfg))
        for mode in modes:
            cfg = cfg.replace(mode=mode)
            got = DH.cells_from_planes(planes[(w, h, ss)], cfg)
            want = DH.cells_from_planes_plain(planes[(w, h, ss)], cfg)
            torch.cuda.synchronize()
            diff = got[1] != want[1]
            n = int((diff.any(-1) if diff.dim() == 3 else diff).sum())
            label = f"{mode.value} {w}x{h} x{ss}"
            out["color_diffs"][label] = n
            kind_off = int((got[0] != want[0]).sum())
            char_off = int((got[2] != want[2]).sum())
            print(f"phase 3h: {label}: kind {kind_off}, char {char_off} and colour {n} of "
                  f"{w * h} cells differ from the plain version's")
            if kind_off or char_off or n:
                raise AssertionError(f"{label}: the heads kernel's cells differ from the plain "
                                     f"version's: kind {kind_off}, char {char_off}, colour {n}")

    hi = RenderConfig(width=1920, height=500, mode=RenderMode.BIT_PIXEL, supersample=2,
                      shadows=True)
    no_spawn = EngineConfig(spawn=False, show_fps=False, seed=1)
    sinks = [FramebufferSink(keep_all=True) for _ in range(2)]
    engines = [Engine(hi, no_spawn, scene=random_scene(100, seed=0), presenter=sink,
                      interactive=False, device=dev, graph=graph)
               for sink, graph in zip(sinks, (True, False))]
    switches = {5: RenderMode.RGB_PIXEL, 10: RenderMode.BIT_ASCII, 15: RenderMode.RGB_ASCII,
                20: RenderMode.RGB_NORMALS, 25: RenderMode.BIT_PIXEL}
    before = telemetry.counters().get("heads.device", 0)
    n_frames = 30
    for i in range(n_frames):
        for e in engines:
            if i in switches:
                e.rcfg = e.rcfg.replace(mode=switches[i])
        frames = [e.device_frame(0.016) for e in engines]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(frames[0].cells, frames[1].cells))
        for e, f in zip(engines, frames):
            e._publish(e._start_download(f))
        if not (same and sinks[0].frames[-1] == sinks[1].frames[-1]):
            raise AssertionError(f"engine frame {i} ({engines[0].rcfg.mode.value}): the graph's "
                                 f"cells or bytes differ from the eager engine's")
    counted = telemetry.counters().get("heads.device", 0) - before
    disp = engines[0].display
    if counted != 2 * n_frames or disp.replay_launches.get("cell_heads") != 1:
        raise AssertionError(f"heads.device {counted} over {n_frames} frames of two engines, a "
                             f"replay launches {disp.replay_launches}")
    print(f"phase 3h: {n_frames} frames of two engines at 1920x500 x2 shadows (graph, eager) "
          f"through 5 mode switches: cells and bytes equal; heads.device {counted}; "
          f"{disp.captures} captures; a replay launches {disp.replay_launches}")

    for mode in (RenderMode.BIT_PIXEL, RenderMode.RGB_PIXEL):
        cfg = hi.replace(mode=mode)
        pl = planes[(1920, 500, 2)]
        cells = DH.cells_from_planes(pl, cfg)
        device_ms = _kernel_device_ms(lambda: DH.cells_from_planes(pl, cfg), name="cell_heads")
        graph_ms, runs = _graph_ms(lambda: DH.cells_from_planes(pl, cfg))
        plain_ms, plain_runs = _graph_ms(lambda: DH.cells_from_planes_plain(pl, cfg))
        read = 4 * 3840 * 1000 * 4  # r, g, b, depth of the 3840x1000 subpixels
        nbytes = read + sum(c.numel() * c.element_size() for c in cells)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        out[mode.value] = {"device_ms": device_ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bytes": nbytes}
        print(f"phase 3h: heads {mode.value} 1920x500 x2: device {device_ms!r} ms (profiler), "
              f"graph {graph_ms!r} ms a call (runs {runs}); bound {bound_ms!r} ms (bytes: "
              f"{nbytes / 1e6:.2f} MB, four planes read once and the cells written once; "
              f"{f'{100 * bound_ms / device_ms:.1f} %' if device_ms else 'not measured'} of "
              f"it); the plain version {plain_ms!r} ms a "
              f"call as a CUDA graph (runs {plain_runs}) {tag}")
    return out


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
    from rtwc_tpu_torch.engine.engine import _render_step, resolve_device
    from rtwc_tpu_torch.utils import telemetry
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

    from rtwc_tpu_torch.render import list_kernel as LK
    from rtwc_tpu_torch.heads import device_encode as DE
    from rtwc_tpu_torch.heads import device_heads as DH

    t0 = time.perf_counter()
    names = ("hard_render", "soft_render", "soft_shadow", "calibrate", "broad_phase",
             "ansi_encode", "cell_heads")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:  # one nvcc for each source, at once
        libs = dict(zip(names, pool.map(_cuda.build, names)))
    hard_kernel._kernel_fn()
    for fn_name in C._ENTRIES:
        C._fn(fn_name)
    LK._fn("rtwc_tile_lists", 7, LK.ListParams)
    LK._fn("rtwc_entry_tables", 8, LK.EntryParams)
    DE._fn()
    DH._fn()
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
        ("g random 100 3840x1000", random_scene(100, seed=0, device=dev), default_camera(),
         RenderConfig(width=3840, height=1000)),
        ("h random 100 3840x1000 shadows", random_scene(100, seed=0, device=dev),
         default_camera(), RenderConfig(width=3840, height=1000, shadows=True)),
        # K7's dynamic shared memory past 48 KB with its static occluder lists
        ("i 720 planes 400x150 shadows", _many_planes(720).to(dev), default_camera(),
         base.replace(shadows=True, max_planes=720)),
    ]
    # the shadow cull's cases at 400x150, and the engine's grown scene
    cases += [(f"cull: {label}", scene.to(dev), default_camera(), cfg)
              for label, (scene, cfg) in _cull_scenes(400, 150).items()]
    cases.append(("cull: the engine's grown scene", _grown_scene(dev), default_camera(),
                  base.replace(shadows=True)))
    bh = bw = 16
    max_err = 0.0
    packed, cull_stats = {}, {}
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
        if not torch.equal(ker, plain):
            n_diff = int((ker != plain).sum())
            raise AssertionError(f"{label}: K7's planes differ from the plain version's in "
                                 f"{n_diff} values")
        if cfg.shadows:
            cull_stats[label] = _cull_stats(hard_kernel, args, cfg, bh, bw)
            print(f"phase 2: {label}: K7 bit-equal to its plain version; shadow cull "
                  f"{json.dumps(cull_stats[label])}")
        else:
            print(f"phase 2: {label}: K7 bit-equal to its plain version")
        if label.startswith("f"):
            if fk.hit.any() or (fk.rgb != 0).any():
                raise AssertionError("empty scene must render all background")
            print("phase 2: f empty scene renders all background")
        packed[label] = (args, cfg)
    clump = cull_stats["cull: a clump past the staging and occluder capacities"]
    if not (clump["full_sweep_warps"] > 0 and clump["longest_list"] > hard_kernel.MAX_THREADS
            and cull_stats["cull: the light inside a warp's hull"]["warps_holding_the_light"]):
        raise AssertionError(f"the cull cases miss what they are named for: {cull_stats}")

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
        ("slab overflow 96x32, 40 spheres", _slab_crowd(), default_camera(),
         cfg96.replace(max_spheres=48), 0.5),
    ]
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "reduce": 0.0}
    for label, scene, cam, cfg, tau in soft_cases:
        out, gates_c = _soft_case(SK, label, scene, cam, cfg, tau, dev, errs)
        if label.startswith("empty") and (out[SK.SO_ALPHA] != 0).any():
            raise AssertionError("the empty scene must render all background")
        gated = gates_c[:, 0].sum(1)
        if label.startswith("slab overflow") and not (int(gated.max()) > SH.SLAB
                                                      >= int(gated.min())):
            raise AssertionError(f"{label}: no tile gates more objects than the {SH.SLAB} slab "
                                 f"slots, or every tile does")
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
    _reduce_bit_equal(lambda a: SK.soft_grad_reduce(*a, 20),
                      lambda a: SK.soft_grad_reduce_plain(*a, 20), (rk,),
                      ((pvals, pidx, ppl, ptf),), "phase 2b random partials")
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
        ("slab overflow 96x32, 40 spheres", _slab_crowd(), default_camera(),
         cfg96s.replace(max_spheres=48), 0.5, True),
        ("4K/200 3840x2160 random_scene(200)", random_scene(200, max_spheres=200, max_planes=4,
                                                            seed=0), default_camera(),
         RenderConfig(width=3840, height=2160, max_spheres=200, max_planes=4, shadows=True,
                      **SOFT_KW), 0.5, True),
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
        if label.startswith(("cache overflow", "4K")) and not int(cnt[:, 0].max()) > SH.NC:
            raise AssertionError(f"{label}: no tile overflows the {SH.NC} cache slots")
        if label.startswith("slab overflow") and not (int(cnt[:, 0].max()) > SH.SLAB
                                                      >= int(cnt[:, 0].min())):
            raise AssertionError(f"no tile gates more objects than the {SH.SLAB} slab slots, or "
                                 f"every tile does")
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
    # On the card the engine replays its frame as a CUDA graph: K7 launches
    # (is counted) once for the eager first frame of each capture and once
    # at the capture; every other frame is a replay of what the capture
    # counted.
    hard_kernel.LAUNCHES = 0
    frames = 0
    counted = [0]

    def run_engine(rcfg, ecfg, n, scene=None, force_spawn=False):
        sink = FramebufferSink(keep_all=True)
        eng = Engine(rcfg, ecfg, scene=scene, presenter=sink, interactive=False, device=dev)
        if force_spawn:
            eng.telemetry.interval = 0.0
        encoded = telemetry.counters().get("encode.device", 0)
        eng.run(max_frames=n)
        if eng.display is None:
            raise AssertionError("the engine on the card did not take the display graph")
        encoded = telemetry.counters().get("encode.device", 0) - encoded
        if encoded != n:
            raise AssertionError(f"{encoded} of {n} published frames encoded on the card")
        counted[0] += 2 * eng.display.captures
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
    print(f"phase 3: K7 launches {launches} (an eager frame and a capture for each of "
          f"{counted[0] // 2} captures), frames rendered {frames}, the rest graph replays")
    if launches != counted[0]:
        raise AssertionError(f"K7 launched {launches} times for {counted[0] // 2} captures")

    lap("3")
    p3e = _phase_3e(dev, f"[{card}]")
    lap("3e")
    p3h = _phase_3h(dev, f"[{card}]")
    lap("3h")

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
    fit_s_launches = dict(SK.LAUNCHES)
    # each stage of the ladder: an eager warm-up step and the capture of its
    # graph count; its other steps replay the graph
    fit_counted = 2 * len(stages_s)
    print(f"phase 3b: in-process fit 192x96, {fit_steps} steps over {len(stages_s)} stages, "
          f"one CUDA graph a stage: launches {fit_s_launches}")
    if not (fit_s_launches["soft_fwd"] == fit_s_launches["soft_bwd"]
            == fit_s_launches["soft_grad_reduce"] == fit_counted
            and fit_s_launches["soft_mse"] == 0):
        raise AssertionError(f"K1 / K2 launches {fit_s_launches} for {len(stages_s)} captures")

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
    steps_taken = 2 * (len(rec["phase_a_stages"]) + len(rec["phase_b_stages"]))  # per stage: 2
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
    start20 = _fit_start(scene20d.spheres.center)
    c20 = start20.clone().requires_grad_(True)
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
                soft_sh_mse=steps_hl, soft_sh_stats=1, soft_grad_reduce=2 * steps_hl,
                partial_fill=0)
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
    # 2 + 2 renders before the fit; its 300 steps: one eager warm-up step and
    # one capture, then 299 replays
    want = dict(soft_fwd=2, soft_bwd=0, soft_mse=0, soft_sh_fwd=4, soft_sh_bwd=2,
                soft_sh_mse=0, soft_sh_stats=0, soft_grad_reduce=2, partial_fill=0)
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
    timing, k7_graph = {}, {}
    for label in ("a default 400x150", "c random 20 1920x1080 shadows",
                  "d random 200 3840x2160 shadows", "g random 100 3840x1000",
                  "h random 100 3840x1000 shadows"):
        args, cfg = packed[label]

        def k7(args=args, cfg=cfg):
            return hard_kernel.hard_render_packed(*args, config=cfg, bh=bh, bw=bw)
        k_ms = _time_ms(k7)
        p_ms = _time_ms(lambda: hard_kernel.hard_render_plain(*args, config=cfg, bh=bh, bw=bw),
                        reps=5, warm=1)
        sph, _, _, camv, _ = args
        b_ms = _time_ms(lambda: hard_kernel.tile_lists(sph, camv, cfg, bh, bw))
        dev_ms = _kernel_device_ms(k7)
        k7_graph[label] = _graph_ms(k7)[0]
        timing[label] = (k_ms, p_ms, b_ms, dev_ms)
        print(f"phase 5: {label}: K7 kernel {k_ms!r} ms (device time alone {dev_ms!r} ms, "
              f"profiler mean; {k7_graph[label]!r} ms a call of a CUDA graph of 20), plain "
              f"{p_ms!r} ms, broad phase {b_ms!r} ms"
              + (f"; warps taking the full shadow sweep {cull_stats[label]['full_sweep_warps']}"
                 f" of {cull_stats[label]['warps_with_a_hit']} with a hit, admitted occluders "
                 f"a warp {cull_stats[label]['mean_admitted']!r} (mean) of "
                 f"{cull_stats[label]['live_spheres']} live" if cfg.shadows else "")
              + f" {tag}")

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
            ("1920x500 100 spheres rgb_ascii supersample 2", hi, random_scene(100, seed=0)),
            ("1920x500 100 spheres rgb_ascii supersample 2 shadows", hi.replace(shadows=True),
             random_scene(100, seed=0))):
        fps, rps = engine_rate(rcfg, scene)
        rates[label] = (fps, rps)
        print(f"phase 5: engine {label}: {fps!r} frames/s, {rps!r} rays/s {tag}")

    # per-frame host breakdown: enqueue of the device step (a replay of the
    # frame's CUDA graph, or the same launches eagerly, the encode included)
    # and the download, wait for the frame's stream, the host's part of the
    # encode (the length's read and the bytes' copy)
    for label, rcfg, scene_fn, graph in (
            ("400x150", RenderConfig(width=400, height=150, mode=RenderMode.RGB_ASCII),
             lambda: default_scene(RenderConfig(), device=dev), True),
            ("1920x500", RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII),
             lambda: random_scene(100, seed=0, device=dev), True),
            ("1920x500 eager", RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII),
             lambda: random_scene(100, seed=0, device=dev), False),
            ("1920x500 x2 shadows", hi.replace(shadows=True),
             lambda: random_scene(100, seed=0, device=dev), True),
            ("1920x500 x2 shadows eager", hi.replace(shadows=True),
             lambda: random_scene(100, seed=0, device=dev), False)):
        eng = Engine(rcfg, no_spawn, scene=scene_fn(), presenter=FramebufferSink(),
                     interactive=False, device=dev, graph=graph)
        parts = {"enqueue": [], "wait": [], "encode": []}
        prev = None
        for i in range(45):
            t0 = time.perf_counter()
            cur = eng._start_download(eng.device_frame(0.016))
            t1 = time.perf_counter()
            if prev is not None:
                prev.event.synchronize()
                t2 = time.perf_counter()
                eng._frame_bytes(prev)
                t3 = time.perf_counter()
                if i >= 5:
                    parts["enqueue"].append(t1 - t0)
                    parts["wait"].append(t2 - t1)
                    parts["encode"].append(t3 - t2)
            prev = cur
        med = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
        print(f"phase 5: frame breakdown {label}: host enqueue {med['enqueue']!r} ms, "
              f"wait for the stream {med['wait']!r} ms, bytes {med['encode']!r} ms {tag}")

    # device busy share over a steady window of engine frames
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
        kern = _device_records(prof)
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
    # the fit's first step: its starting centres against the target's render
    sph, pl, camv = SK._packed(scene20d.replace(spheres=scene20d.spheres.replace(center=start20)),
                               cam20)
    lists = SK.build_lists(sph, camv, spec, True)
    ent20 = SK.entry_tables(lists)
    offsets, pidx = ent20.offsets, ent20.pidx
    n = int(ent20.counts[0])
    Hp, Wp = spec.extent
    out, gates = SK.soft_fwd(sph, pl, camv, lists, spec=spec)
    tgt = torch.zeros((3, Hp, Wp), device=dev)
    tgt[:, :1080, :1920] = tgt20.permute(2, 0, 1)
    g_mse = torch.zeros_like(out)
    g_mse[:3] = (2.0 / (255.0 ** 2 * 3 * 1920 * 1080)) * (out[:3] - tgt)
    parts = SK.soft_bwd(sph, pl, camv, lists, offsets, gates, out, g_mse, spec=spec)
    soft_calls = {
        "K1": ("soft_fwd_kernel", lambda: SK.soft_fwd(sph, pl, camv, lists, spec=spec),
               lambda: SK.soft_fwd_plain(sph, pl, camv, lists, spec=spec)),
        "K2": ("soft_bwd_kernel",
               lambda: SK.soft_bwd(sph, pl, camv, lists, offsets, gates, out, g_mse, spec=spec),
               lambda: SK.soft_bwd_plain(sph, pl, camv, lists, offsets, gates, out, g_mse,
                                         spec=spec)),
        "K3": ("soft_mse_kernel",
               lambda: SK.soft_mse(sph, pl, camv, lists, offsets, tgt, spec=spec),
               lambda: SK.soft_mse_plain(sph, pl, camv, lists, offsets, tgt, spec=spec)),
        "reduce": ("soft_grad_reduce",
                   lambda: SK.soft_grad_reduce(parts[0], pidx, *parts[1:], sph.shape[1],
                                               counts=ent20.counts),
                   lambda: SK.soft_grad_reduce_plain(parts[0], pidx, *parts[1:], sph.shape[1],
                                                     counts=ent20.counts)),
    }
    soft_timing, graph_timing = {}, {}
    for key, (kname, kfn, pfn) in soft_calls.items():
        k_ms = _time_ms(kfn)
        p_ms = _time_ms(pfn, reps=5, warm=1)
        d_ms = _kernel_device_ms(kfn, name=kname, per_call=key == "reduce")
        soft_timing[key] = (k_ms, p_ms, d_ms)
        graph_timing[key] = _graph_ms(kfn)[0]
        print(f"phase 5: {key} ({kname}) 1920x1080 --spheres 20 tau 0.5: {k_ms!r} ms a call "
              f"(device time alone {d_ms!r} ms, profiler mean; {graph_timing[key]!r} ms a call "
              f"of a CUDA graph of 20), plain {p_ms!r} ms; {n} list entries {tag}")

    PlainRender, PlainMSE = _plain_autograd(SK)
    rays = 1920 * 1080

    def make_step(kind):
        c = start20.clone().requires_grad_(True)
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
    ent_h = SK.entry_tables(lists_h, shl_h)
    offsets_h, pidx_h, sh_offsets_h, pshidx_h, counts_h = ent_h
    Hp, Wp = spec_hl.extent
    out_h, gates_h, cnt_h = SH.soft_sh_stats(sph_h, pl_h, cam_h, lists_h, shl_h, spec=spec_hl)
    tgt_h = torch.zeros((3, Hp, Wp), device=dev)
    g_h = torch.zeros_like(out_h)
    g_h[:3] = (2.0 / (255.0 ** 2 * 3 * 1920 * 1080)) * (out_h[:3] - tgt_h)
    bwd_h = (sph_h, pl_h, cam_h, lists_h, shl_h, offsets_h, sh_offsets_h, gates_h, out_h, g_h)
    mse_h = (sph_h, pl_h, cam_h, lists_h, shl_h, offsets_h, sh_offsets_h, tgt_h)
    parts_h = SH.soft_sh_bwd(*bwd_h, spec=spec_hl)
    n_h, nsh_h = int(counts_h[0]), int(counts_h[1])
    fwd4 = (sph_h, pl_h, cam_h, lists_h, shl_h)
    sh_calls = {
        "K4": ("soft_sh_fwd_kernel", lambda: SH.soft_sh_fwd(*fwd4, spec=spec_hl),
               lambda: SH.soft_sh_fwd_plain(*fwd4, spec=spec_hl)),
        "K4-stats": ("soft_sh_fwd_kernel", lambda: SH.soft_sh_stats(*fwd4, spec=spec_hl),
                     lambda: SH.soft_sh_stats_plain(*fwd4, spec=spec_hl)),
        "K5": ("soft_sh_bwd_kernel", lambda: SH.soft_sh_bwd(*bwd_h, spec=spec_hl),
               lambda: SH.soft_sh_bwd_plain(*bwd_h, spec=spec_hl)),
        "K6": ("soft_sh_mse", lambda: SH.soft_sh_mse(*mse_h, spec=spec_hl),
               lambda: SH.soft_sh_mse_plain(*mse_h, spec=spec_hl)),
        "reduce sh": ("soft_grad_reduce",
                      lambda: SK.soft_grad_reduce(parts_h[0], pidx_h, parts_h[2], parts_h[3], 20,
                                                  psh=parts_h[1], pshidx=pshidx_h,
                                                  counts=counts_h),
                      lambda: SK.soft_grad_reduce_plain(parts_h[0], pidx_h, parts_h[2],
                                                        parts_h[3], 20, parts_h[1], pshidx_h,
                                                        counts_h)),
    }
    for key, (kname, kfn, pfn) in sh_calls.items():
        k_ms = _time_ms(kfn)
        p_ms = _time_ms(pfn, reps=1, warm=0)  # the plain versions are timed once
        d_ms = _kernel_device_ms(kfn, name=kname, per_call=key in ("reduce sh", "K6"))
        soft_timing[key] = (k_ms, p_ms, d_ms)
        graph_timing[key] = _graph_ms(kfn)[0]
        print(f"phase 5b: {key} ({kname}) bench headline 1920x1080 random_scene(20) shadows tau "
              f"0.5: {k_ms!r} ms a call (device time alone {d_ms!r} ms, profiler mean; "
              f"{graph_timing[key]!r} ms a call of a CUDA graph of 20), plain {p_ms!r} ms; "
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
    ent_4 = SK.entry_tables(lists_4, shl_4)
    offsets_4, pidx_4, sh_offsets_4, pshidx_4, counts_4 = ent_4
    out_4, gates_4 = SH.soft_sh_fwd(sph_4, pl_4, cam_4, lists_4, shl_4, spec=spec_4k)
    k4_4k_fn = lambda: SH.soft_sh_fwd(sph_4, pl_4, cam_4, lists_4, shl_4, spec=spec_4k)  # noqa: E731
    k4_4k = _kernel_device_ms(k4_4k_fn, reps=5, name="soft_sh_fwd_kernel")
    graph_timing["K4 4k"] = _graph_ms(k4_4k_fn)[0]
    g_4 = torch.zeros_like(out_4)  # the MSE cotangents of a zero target, as at the headline
    g_4[:3] = (2.0 / (255.0 ** 2 * 3 * 3840 * 2160)) * out_4[:3]
    k5_4k = _kernel_device_ms(lambda: SH.soft_sh_bwd(
        sph_4, pl_4, cam_4, lists_4, shl_4, offsets_4, sh_offsets_4, gates_4, out_4, g_4,
        spec=spec_4k), reps=5, name="soft_sh_bwd_kernel")
    k6_4k = _kernel_device_ms(lambda: SH.soft_sh_mse(
        sph_4, pl_4, cam_4, lists_4, shl_4, offsets_4, sh_offsets_4,
        torch.zeros((3,) + spec_4k.extent, device=dev), spec=spec_4k), reps=5,
        name="soft_sh_mse", per_call=True)
    # the reduction at 4K/200 on K6's partials of that step
    parts_4 = SH.soft_sh_mse(sph_4, pl_4, cam_4, lists_4, shl_4, offsets_4, sh_offsets_4,
                             torch.zeros((3,) + spec_4k.extent, device=dev), spec=spec_4k)
    n_4, nsh_4 = int(counts_4[0]), int(counts_4[1])
    bwd_4 = (sph_4, pl_4, cam_4, lists_4, shl_4, offsets_4, sh_offsets_4, gates_4, out_4, g_4)
    parts_5_4k = SH.soft_sh_bwd(*bwd_4, spec=spec_4k)
    red_4k = (lambda: SK.soft_grad_reduce(parts_4[0], pidx_4, parts_4[2], parts_4[3], 200,
                                          psh=parts_4[1], pshidx=pshidx_4, counts=counts_4),
              lambda: SK.soft_grad_reduce_plain(parts_4[0], pidx_4, parts_4[2], parts_4[3],
                                                200, parts_4[1], pshidx_4, counts_4))
    soft_timing["reduce 4k"] = (_time_ms(red_4k[0]), _time_ms(red_4k[1], reps=1, warm=0),
                                _kernel_device_ms(red_4k[0], reps=5, name="soft_grad_reduce",
                                                  per_call=True))
    ms_4k_generic = _step_ms(sh_step("generic", scene_4k, cam_hl, cfg_4k, tgt_4k), 5)
    print(f"phase 5b: shadowed generic train step 3840x2160 random_scene(200): "
          f"{ms_4k_generic!r} ms, {3840 * 2160 / ms_4k_generic * 1e3!r} rays/s; device time K4 "
          f"{k4_4k!r} ms (profiler mean; {graph_timing['K4 4k']!r} ms a call of a CUDA graph of "
          f"20), K5 {k5_4k!r} ms {tag}")
    # K4's shared memory a block and the blocks an SM each limit allows
    k4_regs = {k: int(r) for lib, so in libs.items() if lib == "soft_shadow"
               for k, r, _ in _ptxas_report(so[:-3] + ".log") if "soft_sh_fwd_kernel" in k}
    regs = max(k4_regs.values())
    by_regs = 65536 // (-(-regs * 32 // 256) * 256 * 8)  # 256 threads: 8 warps, 256-register units
    for label, np_, stride in (("bench headline", pl_h.shape[1], lists_h.shape[2]),
                               ("3840x2160 random_scene(200)", pl_4.shape[1], lists_4.shape[2])):
        smem = SH.fwd_shared_bytes(np_, stride)
        by_smem = (228 * 1024) // (smem + 1024)
        print(f"phase 5b: K4 at {label}: {smem} B of shared memory a block; blocks an SM by "
              f"registers ({regs}) {by_regs}, by shared memory {by_smem}, by threads 8")
    print(f"phase 5b: shadowed fused train step 3840x2160 random_scene(200): {ms_4k!r} ms, "
          f"{3840 * 2160 / ms_4k * 1e3!r} rays/s; K6 device time {k6_4k!r} ms; peak memory "
          f"{peak_4k / 2**20:.1f} MiB ({(peak_4k - base_mem) / 2**20:.1f} MiB above the "
          f"{base_mem / 2**20:.1f} MiB held before the step); cache-fallback share of tiles "
          f"{float((cnt_4[:, 0] > SH.NC).float().mean())!r} (culled-in per tile max "
          f"{int(cnt_4[:, 0].max())}); list entries {pidx_4.shape[0]}, shadow entries "
          f"{pshidx_4.shape[0]}; the reduction of K6's partials {soft_timing['reduce 4k']!r} ms "
          f"(a call, plain, device) {tag}")
    _k6_split(SH, libs, soft_timing["K6"][2], graph_timing["K6"], k6_4k, mse_h,
              (lists_h, shl_h, pl_h, sph_h), (lists_4, shl_4, pl_4, sph_4), spec_hl)
    for label, (shl_b, gates_b, ns_b) in (("bench headline", (shl_h, gates_h, sph_h.shape[1])),
                                          ("3840x2160 random_scene(200)",
                                           (shl_4, gates_4, sph_4.shape[1]))):
        print(f"phase 5b: K5 block barriers a tile, {label} (counted from the gate tables; a "
              f"block sum per gated object vs the slab): {_k5_barriers(shl_b, gates_b, ns_b)}")

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
    sharded, k7_bands = _phase_7(dev, tag, errs)
    lap("7")
    p8 = _phase_8(dev, tag)
    lap("8")
    p9 = _phase_9(tag)
    lap("9")
    nccl_runs = {
        "fused": ("10 fused shadowed steps at the scaling defaults on a one-rank NCCL mesh of 2 "
                  "bands, one CUDA graph with the all-reduce inside (phase 9; counted at the "
                  "eager warm-up and the capture, replays count nothing)",
                  ("soft_sh_mse", "soft_grad_reduce", "tile_lists", "entry_tables")),
        "generic": ("3 generic shadowed steps, the same way (phase 9)",
                    ("soft_sh_fwd", "soft_sh_bwd", "soft_grad_reduce", "tile_lists",
                     "entry_tables")),
        "frame": ("render_frame_sharded over 2 bands on the NCCL mesh, 1920x1080 "
                  "random_scene(20), shadows, the all-gather in the graph: a capture and two "
                  "replays (phase 9)", ("hard_render", "tile_lists"))}
    for run, (_, names) in nccl_runs.items():
        missing = [k for k in names if p9.get(run, {}).get(k, 0) < 1]
        if missing:
            raise AssertionError(f"phase 9: the NCCL {run} run launched no {missing}: {p9}")

    # -- launches per main-path step at each row's shape: every count set to
    # 0, one step (one engine frame for K7), the counts read
    from rtwc_tpu_torch.render.step_graph import launch_counts, reset_launch_counts

    def per_step(step):
        reset_launch_counts()
        step()
        torch.cuda.synchronize()
        return launch_counts()

    step_20 = {kind: per_step(make_step(kind)) for kind in ("generic", "fused")}
    step_hl = {kind: per_step(sh_step(kind, scene_hld, cam_hl, cfg_hl, tgt_hl))
               for kind in ("generic", "fused")}
    stats_call = per_step(lambda: SH.soft_tile_diagnostics(scene_hld, cam_hl, cfg_hl, tau=0.5))
    step_4k_launches = per_step(step_4k)
    reset_launch_counts()
    eng_hd = run_engine(RenderConfig(width=1920, height=1080, mode=RenderMode.RGB_ASCII,
                                     shadows=True),
                        no_spawn, 1, scene=random_scene(20, seed=0, device=dev))
    k7_captured = hard_kernel.LAUNCHES  # the eager first frame and the capture
    k7_frame = eng_hd.display.replay_launches["hard_render"]
    frame_launches = eng_hd.display.replay_launches
    print(f"phase 5b: launches per step: unshadowed 1080p {step_20}; shadowed headline "
          f"{step_hl}; soft_tile_diagnostics {stats_call}; one engine frame at 1920x1080 "
          f"random_scene(20) shadows: {frame_launches} a replay of its graph (K7 counted "
          f"{k7_captured} at its eager first frame and its capture)")
    want = {("generic", "soft_fwd"): 1, ("generic", "soft_bwd"): 1, ("generic", "soft_grad_reduce"): 1,
            ("fused", "soft_mse"): 1, ("fused", "soft_grad_reduce"): 1}
    want_sh = {("generic", "soft_sh_fwd"): 1, ("generic", "soft_sh_bwd"): 1,
               ("generic", "soft_grad_reduce"): 1, ("fused", "soft_sh_mse"): 1,
               ("fused", "soft_grad_reduce"): 1}
    for kind in ("generic", "fused"):  # the list kernel and the entry tables, once a step
        want[(kind, "tile_lists")] = want[(kind, "entry_tables")] = 1
        want_sh[(kind, "tile_lists")] = want_sh[(kind, "entry_tables")] = 1
    for steps, wants in ((step_20, want), (step_hl, want_sh)):
        for kind, counts in steps.items():
            got = {k: v for k, v in counts.items() if v}
            if got != {k: v for (kd, k), v in wants.items() if kd == kind}:
                raise AssertionError(f"one {kind} step launched {got}")
    if stats_call["soft_sh_stats"] != 1 or k7_frame != 1 or k7_captured != 2:
        raise AssertionError(f"K4-stats {stats_call}, K7 {k7_frame} a frame, {k7_captured} "
                             f"counted at the capture")
    # a replay launches what one eager step does, each kernel once
    per_path = {"unshadowed generic": step_20["generic"], "unshadowed fused": step_20["fused"],
                "shadowed generic": step_hl["generic"], "shadowed fused": step_hl["fused"]}
    for label, got in p8["replay"].items():
        if got != {k: v for k, v in per_path[label].items() if v}:
            raise AssertionError(f"a replay of the {label} step launches {got}, an eager step "
                                 f"{per_path[label]}")
    for label, got in (("1920x500 x2", p8["display_replay"]), ("1920x1080", frame_launches)):
        if got != {"hard_render": 1, "tile_lists": 1, "ansi_encode": 2, "cell_heads": 1}:
            raise AssertionError(f"a replay of the {label} display frame launches {got}")

    # -- the kernels line: every kernel with its bound ---------------------------
    px = 16 * 16
    hard_work = {label: _hard_work(hard_kernel, *packed[label])
                 for label in ("c random 20 1920x1080 shadows", "d random 200 3840x2160 shadows",
                               "g random 100 3840x1000", "h random 100 3840x1000 shadows")}
    npl20, npl_h, npl_4 = (int(c[0, P.C_NPL]) for c in (camv, cam_h, cam_4))
    ns20, ns_h, ns_4 = sph.shape[1], sph_h.shape[1], sph_4.shape[1]
    w20 = _soft_work(lists, gates, npl20, px)
    wsh = _soft_work(lists_h, gates_h, npl_h, px, shl_h, cnt_h, SH.NC)
    red20 = soft_calls["reduce"][1]()
    red_h = sh_calls["reduce sh"][1]()
    red_4k_out = red_4k[0]()
    # key: (bytes read once + written once, float32 operations). Only what a
    # kernel touches counts: its list rows and gate entries (_list_bytes),
    # the partial rows it writes (_partial_bytes) and the planes it loads.
    # K1 writes gate row 0; K2 reads gate row 0, the saved planes but alpha
    # (0-6, m, s) and the cotangents of rgb, depth, normal and alpha (0-7);
    # K3 and K6 read no gates (they gate in shared memory); K4 writes both
    # gate rows; K5 reads both, the saved planes but alpha (0-6, 8-13) and
    # the same eight cotangent planes.
    work = {
        "K7": hard_work["c random 20 1920x1080 shadows"],
        "K1": (_nbytes(sph, pl, camv, out) + _list_bytes(npl20, lists), w20["fwd"]),
        "K2": (_nbytes(sph, pl, camv, offsets, out[:7], out[8:10], g_mse[:8])
               + _list_bytes(npl20, lists) + _partial_bytes(gates, ns20, npl20, 12),
               w20["bwd"]),
        "K3": (_nbytes(sph, pl, camv, offsets, tgt) + _list_bytes(npl20, lists, gate_rows=False)
               + _partial_bytes(gates, ns20, npl20, 13),
               w20["fwd"] + w20["bwd"] + px * OPS["loss"] * lists.shape[0]),
        "reduce": (_nbytes(*_real_entries(parts, ent20, ns20)[:4], *red20),
                   8.0 * float(_real_entries(parts, ent20, ns20)[0].numel())),
        "K4": (_nbytes(sph_h, pl_h, cam_h, out_h) + _list_bytes(npl_h, lists_h, shl_h),
               wsh["sh_fwd"]),
        "K4-stats": (_nbytes(sph_h, pl_h, cam_h, out_h, cnt_h)
                     + _list_bytes(npl_h, lists_h, shl_h), wsh["sh_fwd"]),
        "K5": (_nbytes(sph_h, pl_h, cam_h, offsets_h, sh_offsets_h, out_h[:7], out_h[8:],
                       g_h[:8]) + _list_bytes(npl_h, lists_h, shl_h)
               + _partial_bytes(gates_h, ns_h, npl_h, 12, True), wsh["sh_bwd"]),
        "K6": (_nbytes(sph_h, pl_h, cam_h, offsets_h, sh_offsets_h, tgt_h)
               + _list_bytes(npl_h, lists_h, shl_h, gate_rows=False)
               + _partial_bytes(gates_h, ns_h, npl_h, 13, True),
               wsh["sh_fwd"] + wsh["sh_bwd"] + px * OPS["loss"] * lists_h.shape[0]),
        "reduce sh": (_nbytes(*_real_entries(parts_h, ent_h, ns_h)[:4],
                              *_real_entries(parts_h, ent_h, ns_h)[5:], *red_h),
                      8.0 * float(n_h * 8 + nsh_h * 4)),
        "reduce 4k": (_nbytes(*_real_entries(parts_4, ent_4, ns_4)[:4],
                              *_real_entries(parts_4, ent_4, ns_4)[5:], *red_4k_out),
                      8.0 * float(n_4 * 8 + nsh_4 * 4)),
    }
    # K4, K5 and K6 at 4K/200 on that shape's lists, gates and counts
    w4k = _soft_work(lists_4, gates_4, npl_4, px, shl_4, cnt_4, SH.NC)
    work_4k = {
        "K4": (_nbytes(sph_4, pl_4, cam_4, out_4) + _list_bytes(npl_4, lists_4, shl_4),
               w4k["sh_fwd"]),
        "K5": (_nbytes(sph_4, pl_4, cam_4, offsets_4, sh_offsets_4, out_4[:7], out_4[8:],
                       g_4[:8]) + _list_bytes(npl_4, lists_4, shl_4)
               + _partial_bytes(gates_4, ns_4, npl_4, 12, True), w4k["sh_bwd"]),
        "K6": (_nbytes(sph_4, pl_4, cam_4, offsets_4, sh_offsets_4)
               + 4 * 3 * spec_4k.extent[0] * spec_4k.extent[1]  # the target's planes
               + _list_bytes(npl_4, lists_4, shl_4, gate_rows=False)
               + _partial_bytes(gates_4, ns_4, npl_4, 13, True),
               w4k["sh_fwd"] + w4k["sh_bwd"] + px * OPS["loss"] * lists_4.shape[0]),
    }
    dev_4k = {"K4": k4_4k, "K5": k5_4k, "K6": k6_4k}
    soft_timing["K7"] = (timing["c random 20 1920x1080 shadows"][0],
                         timing["c random 20 1920x1080 shadows"][1],
                         timing["c random 20 1920x1080 shadows"][3])
    errs["K7"], errs["K4-stats"], errs["reduce sh"] = max_err, errs["K4"], errs["reduce"]
    shape_20 = "1920x1080, --spheres 20 layout + 1 plane, tau 0.5, unshadowed, 16x16 tiles"
    shape_hl = "1920x1080, random_scene(20, max_spheres=20, max_planes=4), shadows, tau 0.5, 16x16 tiles"
    # launches: one main-path step at the row's shape (the counts above);
    # elsewhere: the other counted runs, each with its own shape
    fit_sh = "fit_from_shadow at its defaults, 320x96, 300 steps (phase 3c)"
    hl_runs = f"{steps_hl} generic + {steps_hl} fused steps at the headline (phase 3c)"
    ir_runs = "inverse_render 1920x1080 --spheres 20, 2 x 10 steps (phase 3b)"
    fit_s = "in-process fit 192x96, 30 steps (phase 3b)"
    rows = (
        ("K7", "hard_render (K7, hard display forward)", "hard_render.cu",
         "rtwc_tpu/render/pallas_kernel.py:290", k7_frame,
         "1920x1080, random_scene(20), shadows, 16x16 tiles; launches: one engine frame (a "
         "replay of its CUDA graph, counted at the capture)",
         [("engine frames at 400x150 (160) and 1920x500 (10) (phase 3): eager first frames "
           "and captures", launches)]),
        ("K1", "soft_fwd (K1, soft forward, unshadowed)", "soft_render.cu",
         "rtwc_tpu/render/pallas_soft.py:2434", step_20["generic"]["soft_fwd"], shape_20,
         [(fit_s, fit_s_launches["soft_fwd"]), (ir_runs + " + the target", generic_launches["soft_fwd"])]),
        ("K2", "soft_bwd (K2, soft backward, unshadowed)", "soft_render.cu",
         "rtwc_tpu/render/pallas_soft.py:2476", step_20["generic"]["soft_bwd"], shape_20,
         [(fit_s, fit_s_launches["soft_bwd"]), (ir_runs, generic_launches["soft_bwd"])]),
        ("K3", "soft_mse (K3, fused MSE step, unshadowed)", "soft_render.cu",
         "rtwc_tpu/render/pallas_soft.py:2526", step_20["fused"]["soft_mse"], shape_20,
         [("fused MSE loop 1920x1080, 10 steps (phase 3b)", fused_launches["soft_mse"])]),
        ("reduce", "soft_grad_reduce (D3, deterministic two-float cross-block reduction)",
         "soft_render.cu", "tests/test_pallas_soft.py:283",
         step_20["generic"]["soft_grad_reduce"], shape_20 + "; shadowed: see reduce_shadowed",
         [(fit_s, fit_s_launches["soft_grad_reduce"]), (ir_runs, generic_launches["soft_grad_reduce"]),
          ("fused MSE loop 1920x1080, 10 steps (phase 3b)", fused_launches["soft_grad_reduce"]),
          (hl_runs, hl_launches["soft_grad_reduce"]), (fit_sh, fit_launches["soft_grad_reduce"])]),
        ("K4", "soft_sh_fwd (K4, soft forward, shadowed)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2434", step_hl["generic"]["soft_sh_fwd"], shape_hl,
         [(hl_runs, hl_launches["soft_sh_fwd"]), (fit_sh + " + the target and the start",
                                                  fit_launches["soft_sh_fwd"])]),
        ("K5", "soft_sh_bwd (K5, soft backward, shadowed)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2476", step_hl["generic"]["soft_sh_bwd"], shape_hl,
         [(hl_runs, hl_launches["soft_sh_bwd"]), (fit_sh, fit_launches["soft_sh_bwd"])]),
        ("K6", "soft_sh_mse (K6, fused MSE step, shadowed)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2526", step_hl["fused"]["soft_sh_mse"], shape_hl,
         [(hl_runs, hl_launches["soft_sh_mse"])]),
        ("K4-stats", "soft_sh_stats (K4-stats, cache diagnostics)", "soft_shadow.cu",
         "rtwc_tpu/render/pallas_soft.py:2822", stats_call["soft_sh_stats"],
         shape_hl + "; launches: one soft_tile_diagnostics call",
         [("soft_tile_diagnostics at the headline (phase 3c)", hl_launches["soft_sh_stats"])]),
        ("tile_lists", "tile_lists (the broad phase: view lists, aux and shadow lists)",
         "broad_phase.cu", "rtwc_tpu/render/pallas_soft.py:968 (_build_tile_lists, XLA code)",
         step_hl["fused"]["tile_lists"], shape_hl,
         [("a replay of the shadowed fused step's CUDA graph (phase 8)",
           p8["replay"]["shadowed fused"].get("tile_lists", 0)),
          ("a replay of the display frame's CUDA graph, 1920x500 x2 (phase 8)",
           p8["display_replay"].get("tile_lists", 0))]),
        ("entry_tables", "entry_tables (the partials' entry tables, counts on the device)",
         "broad_phase.cu", "rtwc_tpu/render/pallas_soft.py:2700 (the jitted step's entry "
         "bookkeeping, XLA code)", step_hl["fused"]["entry_tables"], shape_hl,
         [("a replay of the shadowed fused step's CUDA graph (phase 8)",
           p8["replay"]["shadowed fused"].get("entry_tables", 0))]),
    )
    for key in ("tile_lists", "entry_tables"):
        soft_timing[key] = p8["timings"][key][:3]
        graph_timing[key] = p8["timings"][key][3]
        work[key], work_4k[key], dev_4k[key] = p8["work"][key], p8["work_4k"][key], p8["dev_4k"][key]
        graph_timing[f"{key} 4k"] = p8["graph_4k"][key]
        errs[key] = 0.0  # torch.equal to broad_phase.py in every case of phase 8
    # the reduction's whole function in PyTorch library calls on the same
    # inputs, held to the kernel's sums before it is timed
    lib_args = _real_entries(parts, ent20, sph.shape[1])
    lib_args_sh = _real_entries(parts_h, ent_h, 20)
    lib_args_4k = _real_entries(parts_4, ent_4, 200)
    lib_reduce = _reduce_library_ms(P, lib_args, red20)
    lib_reduce_sh = _reduce_library_ms(P, lib_args_sh, red_h)
    lib_reduce_4k = _reduce_library_ms(P, lib_args_4k, red_4k_out)
    # device time of the whole function, from a CUDA graph of its calls: the
    # library calls, and the port's wrapper (its allocations and the kernels)
    lib_dev, port_dev = {}, {}
    for which, a, port in (("unshadowed", lib_args, soft_calls["reduce"][1]),
                           ("shadowed", lib_args_sh, sh_calls["reduce sh"][1]),
                           ("4k200", lib_args_4k, red_4k[0])):
        lib_dev[which], lib_runs = _graph_ms(lambda: _reduce_library(*a))
        port_dev[which], port_runs = _graph_ms(port)
        print(f"phase 5b: reduction ({which}), device ms a call of the whole function (CUDA "
              f"graph of 20 calls, median of the replays {lib_runs!r} / {port_runs!r}): library "
              f"calls {lib_dev[which]!r}, the port's wrapper {port_dev[which]!r} {tag}")
    print(f"phase 5b: reduction, its five kernels' device time a call (profiler) "
          f"{soft_timing['reduce'][2]!r} / {soft_timing['reduce sh'][2]!r} / "
          f"{soft_timing['reduce 4k'][2]!r} ms (unshadowed / shadowed / 4K/200) {tag}")
    for which in lib_dev:
        if not port_dev[which] < lib_dev[which]:
            print(f"phase 5b: NOTE the reduction ({which}) is not faster than its library calls")
    entries = []
    for key, kname, src, replaces, count, shape, elsewhere in rows:
        k_ms, p_ms, d_ms = soft_timing[key]
        b_ms, b_by = _bound(*work[key])
        floor_key = "K4" if key == "K4-stats" else key
        entry = {"name": kname, "route": "cuda", "source": f"rtwc_tpu_torch/csrc/{src}",
                 "replaces": replaces, "launches": count, "max_abs_err": errs[key], "ms": k_ms,
                 "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_reduce if key == "reduce" else None,
                 "floor_ms": floors.get(floor_key), "device_ms": d_ms,
                 "graph_device_ms": graph_timing.get(key), "shape": shape,
                 "launches_elsewhere": [{"run": r, "launches": c} for r, c in elsewhere]}
        counter = {"K7": "hard_render", "tile_lists": "tile_lists",
                   "entry_tables": "entry_tables", **SHARDED_KEYS}.get(key)
        nccl = [{"run": text, "launches": p9[run][counter]}
                for run, (text, _) in nccl_runs.items() if p9[run].get(counter)]
        if nccl:
            entry["launches_nccl"] = nccl
        if key == "K7":
            entry["launches_sharded"] = {
                "run": "render_frame_sharded over 4 bands, 1920x1080 random_scene(20), shadows "
                       "(phase 7)", "launches": k7_bands}
        elif key in SHARDED_KEYS:
            entry["launches_sharded"] = {
                "run": "one sharded train step of each path on 2 bands in one process, "
                       "1920x1080 random_scene(20), tau 0.5 (phase 7)",
                "launches": sharded[SHARDED_KEYS[key]]}
        if key in work_4k:
            entry["bound_ms_4k200"], entry["bound_by_4k200"] = _bound(*work_4k[key])
            entry["device_ms_4k200"] = dev_4k[key]
            print(f"phase 5b: {key} at 3840x2160 random_scene(200): bound "
                  f"{entry['bound_ms_4k200']!r} ms ({entry['bound_by_4k200']}; "
                  f"{work_4k[key][0] / 1e6:.1f} MB, {work_4k[key][1] / 1e9:.2f} GFLOP), device "
                  f"{dev_4k[key]!r} ms")
        if key in ("K4", "tile_lists", "entry_tables"):
            entry["graph_device_ms_4k200"] = graph_timing[f"{key} 4k"]
        if key == "K7":
            entry["graph_device_ms"] = k7_graph["c random 20 1920x1080 shadows"]
            entry["shapes"] = {}
            for label, (nbytes, ops) in hard_work.items():
                kb_ms, kb_by = _bound(nbytes, ops)
                entry["shapes"][label] = {
                    "device_ms": timing[label][3], "graph_device_ms": k7_graph[label],
                    "ms": timing[label][0], "plain_ms": timing[label][1], "bound_ms": kb_ms,
                    "bound_by": kb_by, "shadow_cull": cull_stats.get(label)}
                print(f"phase 5b: K7 at {label}: bound {kb_ms!r} ms ({kb_by}; "
                      f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP), device "
                      f"{timing[label][3]!r} ms, graph {k7_graph[label]!r} ms")
        if key == "reduce":
            r_ms, r_p, r_d = soft_timing["reduce sh"]
            rb_ms, rb_by = _bound(*work["reduce sh"])
            entry["reduce_shadowed"] = {"ms": r_ms, "plain_ms": r_p, "device_ms": r_d,
                                        "bound_ms": rb_ms, "bound_by": rb_by,
                                        "library_ms": lib_reduce_sh,
                                        "library_device_ms": lib_dev["shadowed"],
                                        "function_device_ms": port_dev["shadowed"],
                                        "launches": step_hl["generic"]["soft_grad_reduce"],
                                        "shape": shape_hl}
            r_ms, r_p, r_d = soft_timing["reduce 4k"]
            rb_ms, rb_by = _bound(*work["reduce 4k"])
            entry["reduce_4k200"] = {"ms": r_ms, "plain_ms": r_p, "device_ms": r_d,
                                     "bound_ms": rb_ms, "bound_by": rb_by,
                                     "library_ms": lib_reduce_4k,
                                     "library_device_ms": lib_dev["4k200"],
                                     "function_device_ms": port_dev["4k200"],
                                     "launches": step_4k_launches["soft_grad_reduce"],
                                     "shape": "3840x2160, random_scene(200), shadows, tau 0.5, "
                                              "16x16 tiles; K6's partials of a zero target"}
            entry["library_device_ms"] = lib_dev["unshadowed"]
            entry["function_device_ms"] = port_dev["unshadowed"]
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
                   "calibration": cal["calibration"], "floors_ms": floors, "bench": bench_res,
                   "graph_vs_eager_ms": p8["step_ms"], "lists_pack_ms": p8["lists_pack_ms"]},
                  f)
    print(f"phase times (s): {json.dumps(laps)}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
