"""Benchmark of the port on one CUDA card: rays/s of the shadowed fused train
step at 1920x1080 with 20 spheres (forward + backward + Adam), and every
other train and display configuration of the JAX package's bench.py, with
the calibrated roofline lenses of utils/roofline.py.

    python -m rtwc_tpu_torch.bench      # needs a CUDA card; ~1-2 minutes

Port of bench.py. It prints the human summary on stderr (with the minimum
and maximum of every timed call, and the kernels' launch counts) and ONE
JSON line on stdout with bench.py's keys (bench.py:461-502), two renamed:
the port has no tunnel, so `single_dispatch_breakdown.tunnel_floor_ms` is
`dispatch_floor_ms` (one trivial torch op and a synchronise), and no jnp
renderer, so `jnp_fwd_bwd` is `torch_soft_fwd_bwd` (render/softmin.py in 12
row bands). It adds `"device": {"name", "power_limit_w"}`.

Method, as bench.py: a warm-up, then the mean over timed calls; a train
"loop" is LOOP_K steps queued between synchronisations (torch Adam on every
float leaf of scene and camera), a "single" step one step and a
synchronise. On the card each train step of a loop is one replay of a CUDA
graph of the whole step (render/step_graph.py, the counterpart of JAX's
jitted step and its `lax.scan`); the headline is also timed eagerly, the
same launches queued from Python, for the summary's spread. Times are host-clock times of work that ends in
torch.cuda.synchronize(). The sizes below are module constants (the CPU
test patches them, and DEVICE, small); there is no flag, and on the default
device the bench fails without a card rather than run elsewhere.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from rtwc_tpu_torch.camera import Camera, camera_rays, default_camera, projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import hard_kernel
from rtwc_tpu_torch.render import shadow_kernel as SH
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.render.softmin import render_frame_soft, trace_soft
from rtwc_tpu_torch.render.step_graph import (CapturedStep, card_adam, launch_counts,
                                              reset_launch_counts)
from rtwc_tpu_torch.scene import empty_scene, random_scene
from rtwc_tpu_torch.utils import roofline

DEVICE = "cuda"
WIDTH, HEIGHT = 1920, 1080
WIDTH_4K, HEIGHT_4K, SPHERES_4K = 3840, 2160, 200
GRAD_WIDTH, GRAD_HEIGHT = 640, 360   # bench.py's grad_cam_rot_rel config
N_BANDS = 12
BASELINE_RAYS_PER_S = 1920 * 1080 * 60.0  # real-time 1080p fwd+bwd budget
TAU = 0.5
LOOP_K = 16

_SPREAD: dict = {}  # name -> (mean, min, max) ms of the timed calls


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(name: str, fn, dev, warmup: int, iters: int, per: int = 1) -> float:
    """Mean seconds per unit of `iters` calls of fn, each ending in a
    synchronise, after `warmup` calls; `per` units a call."""
    for _ in range(warmup):
        fn()
        _sync(dev)
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t) / per)
    _SPREAD[name] = tuple(x * 1e3 for x in (statistics.mean(times), min(times), max(times)))
    return statistics.mean(times)


def _leaves(scene, camera):
    """(every float leaf of scene and camera as a fresh tensor that needs a
    gradient, rebuild() -> (scene, camera) made of them)."""
    groups = {}
    for gname in ("spheres", "planes"):
        g = getattr(scene, gname)
        groups[gname] = {f.name: getattr(g, f.name).detach().clone().requires_grad_(True)
                         for f in dataclasses.fields(g) if getattr(g, f.name).is_floating_point()}
    cam = {k: getattr(camera, k).detach().clone().requires_grad_(True) for k in ("pos", "rot")}

    def rebuild():
        return (scene.replace(spheres=scene.spheres.replace(**groups["spheres"]),
                              planes=scene.planes.replace(**groups["planes"])), Camera(**cam))

    leaves = [t for g in groups.values() for t in g.values()] + list(cam.values())
    return leaves, rebuild


def _loss(cfg, target, fused: bool, cull: bool, bwd_cull: bool):
    def loss_of(scene, camera):
        if fused:
            # the one-pass MSE kernel (K3, K6 with shadows): the cotangent
            # planes never reach device memory
            return SK.render_soft_mse_loss(scene, camera, target, cfg, tau=TAU, cull=cull,
                                           bwd_cull=bwd_cull)
        # the GENERIC path: forward kernel, torch loss, backward kernel
        fb = SK.render_frame_soft_kernel(scene, camera, cfg, tau=TAU, cull=cull, bwd_cull=bwd_cull)
        return torch.mean(((fb.rgb - target) / 255.0) ** 2)
    return loss_of


def train_step(cfg, scene, camera, target, *, fused=True, cull=True, bwd_cull=True,
               graph=None):
    """One optimizer step (Adam 1e-3 on scene and camera) a call: a
    CapturedStep, replayed as a CUDA graph on the card unless graph=False."""
    leaves, rebuild = _leaves(scene, camera)
    opt = torch.optim.Adam(leaves, lr=1e-3, **card_adam(leaves))
    loss_of = _loss(cfg, target, fused, cull, bwd_cull)
    return CapturedStep(lambda: loss_of(*rebuild()), opt, graph=graph)


def grad_step(cfg, scene, camera, target, *, fused=True):
    """Loss and gradients of scene and camera, no optimizer (a single step)."""
    leaves, rebuild = _leaves(scene, camera)
    loss_of = _loss(cfg, target, fused, True, True)

    def step():
        loss = loss_of(*rebuild())
        return loss, torch.autograd.grad(loss, leaves, allow_unused=True)
    return step


def time_loop(name, cfg, K, dev, *, params, target, cull=True, bwd_cull=True, warmup=1,
              iters=4, fused=True, graph=None) -> float:
    """Per-step seconds of K train steps queued between synchronisations
    (the warm-up's first step captures the graph)."""
    step = train_step(cfg, *params, target, fused=fused, cull=cull, bwd_cull=bwd_cull,
                      graph=graph)

    def loop():
        for _ in range(K):
            step()
    return _timed(name, loop, dev, warmup, iters, per=K)


def fwd_loop(cfg, K, scene, camera, *, cull=True, hard=False):
    """K forward renders: the soft kernel path (K1 / K4), or K7 with hard=True."""
    def run():
        with torch.no_grad():
            for i in range(K):
                cam = Camera(pos=camera.pos + i * 1e-7, rot=camera.rot)
                if hard:
                    hard_kernel.render_frame_kernel(scene, cam, cfg)
                else:
                    SK.render_frame_soft_kernel(scene, cam, cfg, tau=TAU, cull=cull)
    return run


def lists_loop(cfg, K, scene, camera):
    """K times the per-step prologue alone: packing and both broad-phase
    lists (view cone and light cone)."""
    spec = SK.SoftSpec(cfg, TAU)

    def run():
        for _ in range(K):
            sph, pl, cam = SK._packed(scene, camera)
            SH.build_lists(sph, pl, cam, spec, True)
    return run


def torch_soft_step(cfg, scene, camera, target):
    """The torch soft renderer's loss and gradients in N_BANDS row bands,
    one backward a band (render/softmin.py, the semantic source of truth)."""
    leaves, rebuild = _leaves(scene, camera)
    e1, e2 = projection_elements(cfg)
    bands = torch.arange(cfg.height).chunk(N_BANDS)
    n = 3.0 * cfg.height * cfg.width

    def step():
        for t in leaves:
            t.grad = None
        for rows in bands:
            sc, cam = rebuild()
            r0, nr = int(rows[0]), len(rows)
            origin, dirs = camera_rays(cam, cfg.width, cfg.height, e1, e2, row_start=r0, n_rows=nr)
            rgb = trace_soft(sc, origin, dirs, cfg, tau=TAU)[0]
            (torch.sum(((rgb - target[r0:r0 + nr]) / 255.0) ** 2) / n).backward()
    return step


def _rot_grad(render, scene, camera, cfg):
    """d/d camera.rot of bench.py's grad_cam_rot_rel loss (bench.py:377-382)."""
    rot = camera.rot.clone().requires_grad_(True)
    fb = render(scene, Camera(pos=camera.pos, rot=rot), cfg, tau=TAU)
    loss = torch.mean((fb.rgb / 255.0) ** 2) + 0.01 * torch.mean(fb.depth) / cfg.far
    loss.backward()
    return rot.grad.double().cpu().numpy()


def _device_info(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit_w": None}
    from rtwc_tpu_torch.utils.calibrate import card_line

    watts = card_line().split(",")[-1].strip().split()[0]
    return {"name": torch.cuda.get_device_name(dev), "power_limit_w": float(watts)}


def main() -> int:
    dev = torch.device(DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("rtwc_tpu_torch.bench runs on a CUDA card; torch finds none", file=sys.stderr)
        return 2
    _SPREAD.clear()
    reset_launch_counts()
    base = dict(soft_miss_penalty=300.0, soft_mask_k=10.0)
    cfg_sh = RenderConfig(width=WIDTH, height=HEIGHT, max_spheres=20, max_planes=4, shadows=True,
                          **base)
    cfg_no = cfg_sh.replace(shadows=False)
    scene = random_scene(20, max_spheres=20, max_planes=4, seed=0, device=dev)
    camera = default_camera().to(dev)
    target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
    params = (scene, camera)
    rays = WIDTH * HEIGHT

    # Headline: the shadowed fused step, LOOP_K steps queued between syncs.
    dt_sh = time_loop("fused loop", cfg_sh, LOOP_K, dev, params=params, target=target)
    rps_sh = rays / dt_sh
    dt_sh_eager = time_loop("fused loop eager", cfg_sh, LOOP_K, dev, params=params,
                            target=target, graph=False)
    # Single steps: one step and a synchronise, fused and generic.
    dt_sh_1_fused = _timed("fused single", grad_step(cfg_sh, scene, camera, target), dev, 2, 6)
    dt_sh_1 = _timed("generic single", grad_step(cfg_sh, scene, camera, target, fused=False),
                     dev, 2, 6)
    one = torch.zeros((), device=dev)
    dt_dispatch = _timed("dispatch floor", lambda: one + 1.0, dev, 2, 10)
    dt_lists = _timed("lists + pack", lists_loop(cfg_sh, LOOP_K, scene, camera), dev, 2, 10,
                      per=LOOP_K)

    dt_gen = time_loop("generic loop", cfg_sh, LOOP_K, dev, params=params, target=target,
                       fused=False)
    dt_no = time_loop("unshadowed loop", cfg_no, LOOP_K, dev, params=params, target=target)

    # Culling: the shadowed forward culled and unculled, and the unculled step.
    dt_fwd = _timed("fwd culled", fwd_loop(cfg_sh, LOOP_K, scene, camera), dev, 2, 10,
                    per=LOOP_K)
    dt_fwd_nc = _timed("fwd unculled", fwd_loop(cfg_sh, LOOP_K, scene, camera, cull=False), dev,
                       2, 3, per=LOOP_K)
    dt_step_nc = time_loop("unculled loop", cfg_sh, LOOP_K, dev, cull=False, bwd_cull=False,
                           params=params, target=target, iters=3)
    dt_bwd_nc = max(dt_step_nc - dt_fwd_nc, 1e-9)

    # The display kernel and the torch soft renderer.
    dt_hard = _timed("hard fwd (K7)", fwd_loop(cfg_sh, LOOP_K, scene, camera, hard=True), dev,
                     2, 10, per=LOOP_K)
    dt_torch = _timed("torch soft fwd+bwd", torch_soft_step(cfg_no, scene, camera, target), dev,
                      2, 4)

    # 4K with SPHERES_4K spheres, shadows.
    cfg_4k = cfg_sh.replace(width=WIDTH_4K, height=HEIGHT_4K, max_spheres=SPHERES_4K)
    scene_4k = random_scene(SPHERES_4K, max_spheres=SPHERES_4K, max_planes=4, seed=0, device=dev)
    target_4k = torch.zeros((HEIGHT_4K, WIDTH_4K, 3), device=dev)
    rays_4k = WIDTH_4K * HEIGHT_4K
    dt_4k = time_loop("4K fused loop", cfg_4k, 4, dev, params=(scene_4k, camera),
                      target=target_4k, iters=2)
    dt_4k_nc = time_loop("4K unculled loop", cfg_4k, 2, dev, cull=False,
                         params=(scene_4k, camera), target=target_4k, iters=2)
    dt_4k_fwd_nc = _timed("4K fwd unculled", fwd_loop(cfg_4k, 2, scene_4k, camera, cull=False),
                          dev, 1, 2, per=2)
    dt_4k_bwd_nc = max(dt_4k_nc - dt_4k_fwd_nc, 1e-9)

    # Clamp-cache demand (per-tile culled-in objects against the NC slots) and
    # the per-tile work profile that prices the list-aware floor.
    diag_hd = SH.soft_tile_diagnostics(scene, camera, cfg_sh, tau=TAU)
    diag_4k = SH.soft_tile_diagnostics(scene_4k, camera, cfg_4k, tau=TAU)
    slots_hd = slots_4k = SH.NC
    cnt_hd, cnt_4k = diag_hd["main_applied"], diag_4k["main_applied"]
    fb_hd = float((cnt_hd > slots_hd).mean() * 100.0)
    fb_4k = float((cnt_4k > slots_4k).mean() * 100.0)
    floor_hd = roofline.culled_step_model(cfg_sh, TAU, diag_hd, fused=True)
    floor_4k = roofline.culled_step_model(cfg_4k, TAU, diag_4k, fused=True)
    sol_culled_hd = floor_hd["t_floor_s"] / dt_sh
    sol_culled_4k = floor_4k["t_floor_s"] / dt_4k
    # The same step on an EMPTY scene: the fixed cost every step pays.
    dt_empty = time_loop("empty-scene fused loop", cfg_sh, LOOP_K, dev,
                         params=(empty_scene(cfg_sh.max_spheres, cfg_sh.max_planes, device=dev),
                                 camera), target=target)
    # Undefined (None) where the empty-scene step is no faster than the full
    # one: the host's spread then hides the object work.
    floor_obj_hd = floor_hd["t_floor_s"] - floor_hd["t_fixed_s"]
    sol_marginal_hd = floor_obj_hd / (dt_sh - dt_empty) if dt_sh > dt_empty else None
    marginal = ("not measurable (the empty-scene step is no faster)" if sol_marginal_hd is None
                else f"{sol_marginal_hd*100:.1f}%")

    # Camera-rotation gradient: the kernel path against the torch renderer.
    cfg_g = RenderConfig(width=GRAD_WIDTH, height=GRAD_HEIGHT, max_spheres=24, max_planes=4,
                         shadows=True, **base)
    scene_g = random_scene(20, max_spheres=24, max_planes=4, seed=0, device=dev)
    gk = _rot_grad(SK.render_frame_soft_kernel, scene_g, camera, cfg_g)
    gt = _rot_grad(render_frame_soft, scene_g, camera, cfg_g)
    grad_cam_rot_rel = float(np.max(np.abs(gt - gk)) / max(np.abs(gt).max(), np.abs(gk).max(),
                                                            1e-12))

    # Roofline lenses (utils/roofline.py), at the live object counts.
    model = roofline.soft_step_model(cfg_sh, TAU, scene.n_spheres, scene.n_planes, fused=True)
    util = roofline.utilization(model, dt_sh)
    model_4k = roofline.soft_step_model(cfg_4k, TAU, scene_4k.n_spheres, scene_4k.n_planes,
                                        fused=True)
    util_4k = roofline.utilization(model_4k, dt_4k)
    sol_fwd = model["t_fwd_compute_bound_s"] / dt_fwd_nc
    sol_bwd = model["t_bwd_compute_bound_s"] / dt_bwd_nc
    sol_fwd_4k = model_4k["t_fwd_compute_bound_s"] / dt_4k_fwd_nc
    sol_bwd_4k = model_4k["t_bwd_compute_bound_s"] / dt_4k_bwd_nc
    _sync(dev)
    launches = launch_counts()
    device = _device_info(dev)

    single_breakdown = {
        "dispatch_floor_ms": round(dt_dispatch * 1e3, 3),
        "fused_amortized_ms": round(dt_sh * 1e3, 3),
        "fused_single_ms": round(dt_sh_1_fused * 1e3, 3),
        "fused_unexplained_ms": round((dt_sh_1_fused - dt_sh - dt_dispatch) * 1e3, 3),
        "generic_amortized_ms": round(dt_gen * 1e3, 3),
        "generic_single_ms": round(dt_sh_1 * 1e3, 3),
        "generic_unexplained_ms": round((dt_sh_1 - dt_gen - dt_dispatch) * 1e3, 3),
        "lists_pack_ms": round(dt_lists * 1e3, 3),
    }
    print(
        f"# HEADLINE shadowed fwd+bwd: {dt_sh*1e3:.2f} ms/step over {LOOP_K}-step loops "
        f"({rps_sh/1e6:.1f} Mrays/s; eager {dt_sh_eager*1e3:.2f} ms); single fused step "
        f"{dt_sh_1_fused*1e3:.2f} ms (dispatch "
        f"floor {dt_dispatch*1e3:.3f} ms) | generic path: {dt_gen*1e3:.2f} ms a step "
        f"({rays/dt_gen/1e6:.1f} Mrays/s), {dt_sh_1*1e3:.2f} ms single; pack + lists "
        f"{dt_lists*1e3:.2f} ms a step\n"
        f"# unshadowed fwd+bwd: {dt_no*1e3:.2f} ms ({rays/dt_no/1e6:.1f} Mrays/s) | hard fwd "
        f"(display): {dt_hard*1e3:.2f} ms ({rays/dt_hard/1e6:.1f} Mrays/s) | torch soft "
        f"fwd+bwd: {dt_torch*1e3:.2f} ms ({rays/dt_torch/1e6:.1f} Mrays/s)\n"
        f"# shadowed fwd only: {dt_fwd*1e3:.2f} ms culled / {dt_fwd_nc*1e3:.2f} ms unculled "
        f"(cull speedup {dt_fwd_nc/dt_fwd:.2f}x)\n"
        f"# 4K/{SPHERES_4K}-sphere shadowed fwd+bwd: {dt_4k*1e3:.2f} ms "
        f"({rays_4k/dt_4k/1e6:.1f} Mrays/s) culled / {dt_4k_nc*1e3:.2f} ms unculled "
        f"({dt_4k_nc/dt_4k:.2f}x)\n"
        f"# clamp-cache demand: 1080p max {int(cnt_hd.max())}/{slots_hd} slots ({fb_hd:.1f}% "
        f"tiles fall back) | 4K max {int(cnt_4k.max())}/{slots_4k} ({fb_4k:.1f}% fall back)\n"
        f"# roofline 1080p: modeled {model['ops_per_frame']/1e9:.2f} G FMA-slots/frame -> "
        f"{model['ops_per_frame']/dt_sh/1e12:.2f} effective T slots/s = {util['vpu_util']:.3f}x "
        f"the calibrated {roofline.FMA_PER_S/1e12:.2f} T FMA-slots/s (culling credited as "
        f"executed work), memory {util['hbm_util']*100:.2f}% -> {util['bound']}-bound | 4K: "
        f"{util_4k['vpu_util']:.3f}x\n"
        f"# speed of light, no culling credit: 1080p unculled fwd {sol_fwd*100:.1f}% / bwd "
        f"{sol_bwd*100:.1f}%; 4K unculled fwd {sol_fwd_4k*100:.1f}% / bwd {sol_bwd_4k*100:.1f}%\n"
        f"# list-aware floor: 1080p {floor_hd['t_floor_s']*1e3:.3f} ms -> "
        f"{sol_culled_hd*100:.1f}% | 4K {floor_4k['t_floor_s']*1e3:.3f} ms -> "
        f"{sol_culled_4k*100:.1f}%; empty-scene step {dt_empty*1e3:.2f} ms -> marginal "
        f"object-work efficiency {marginal}\n"
        f"# grad_cam_rot parity vs the torch soft renderer at {GRAD_WIDTH}x{GRAD_HEIGHT}: "
        f"{grad_cam_rot_rel:.3e}\n"
        "# spread (ms a step or call: mean / min / max): "
        + "; ".join(f"{k} {m:.3f} / {lo:.3f} / {hi:.3f}" for k, (m, lo, hi) in _SPREAD.items())
        + f"\n# kernel launches: {json.dumps(launches)}\n"
        f"# device {device['name']}, power limit {device['power_limit_w']} W",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "rays/sec/chip fwd+bwd, 1080p, 20 spheres, hard shadows, soft renderer",
        "value": round(rps_sh, 1),
        "unit": "rays/s",
        "vs_baseline": round(rps_sh / BASELINE_RAYS_PER_S, 4),
        "shadowed": round(rps_sh, 1),
        "generic_shadowed": round(rays / dt_gen, 1),
        "single_dispatch_ms": round(dt_sh_1_fused * 1e3, 3),
        "single_dispatch_generic_ms": round(dt_sh_1 * 1e3, 3),
        "single_dispatch_breakdown": single_breakdown,
        "unshadowed": round(rays / dt_no, 1),
        "fwd_hard_display": round(rays / dt_hard, 1),
        "torch_soft_fwd_bwd": round(rays / dt_torch, 1),
        "r4k_200sph_shadowed": round(rays_4k / dt_4k, 1),
        "r4k_200sph_nocull": round(rays_4k / dt_4k_nc, 1),
        "cull_speedup_fwd": round(dt_fwd_nc / dt_fwd, 3),
        "model_gops_per_frame": round(model["ops_per_frame"] / 1e9, 2),
        "vpu_sol_multiple": round(util["vpu_util"], 3),
        "sol_pct_nocull_fwd": round(sol_fwd * 100, 1),
        "sol_pct_nocull_bwd": round(sol_bwd * 100, 1),
        "sol_pct_nocull_fwd_4k": round(sol_fwd_4k * 100, 1),
        "sol_pct_nocull_bwd_4k": round(sol_bwd_4k * 100, 1),
        "sol_pct_culled_floor": round(sol_culled_hd * 100, 1),
        "sol_pct_culled_floor_4k": round(sol_culled_4k * 100, 1),
        "empty_scene_fixed_ms": round(dt_empty * 1e3, 3),
        "sol_pct_marginal_objects": (None if sol_marginal_hd is None
                                     else round(sol_marginal_hd * 100, 1)),
        "culled_floor_ms": {"r1080": round(floor_hd["t_floor_s"] * 1e3, 3),
                            "r4k": round(floor_4k["t_floor_s"] * 1e3, 3)},
        "tile_work_profile": {
            "r1080": {k: round(floor_hd[k], 2) for k in floor_hd if k.startswith("mean")},
            "r4k": {k: round(floor_4k[k], 2) for k in floor_4k if k.startswith("mean")}},
        "cache_slots": {"r1080": slots_hd, "r4k": slots_4k},
        "cache_demand_max": {"r1080": int(cnt_hd.max()), "r4k": int(cnt_4k.max())},
        "cache_fallback_tiles_pct": {"r1080": round(fb_hd, 2), "r4k": round(fb_4k, 2)},
        "grad_cam_rot_rel": round(grad_cam_rot_rel, 6),
        "hbm_util": round(util["hbm_util"], 4),
        "bound": util["bound"],
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
