"""Inverse rendering on the port: recover sphere geometry and camera pose
from a sharp target image by annealed gradient descent through K1 / K2.

    python -m rtwc_tpu_torch.examples.inverse_render [--steps 300] [--width 320]
        [--height 180] [--spheres 20] [--quantized] [--device cuda|cpu]

Counterpart: examples/inverse_render.py, with the same flags, phases,
printout, JSON artifact and exit code (0 iff both phases converge
sub-pixel), plus --device (default cuda; it raises without a card). Each
step renders with render_frame_soft_kernel and takes the RGB + IoU loss's
gradient through autograd. optax.adam with a cosine decay becomes
torch.optim.Adam with a cosine LambdaLR that decays to 0 over the phase's
steps; optax.multi_transform's freeze labels become "only the trained
tensors are leaves that require grad and sit in the optimizer". On the
card each step's render, loss and backward are one replay of a CUDA graph
(render/step_graph.py), captured again at each stage of the ladder;
torch's default Adam then steps eagerly, so the fit rounds as an eager
loop does. The
perturbation is drawn with NumPy from --seed exactly as the JAX script
draws it, so both start from the same point.

Two phases, because the joint problem is gauge-degenerate: A recovers
the perturbed sphere centres with the camera known, B the perturbed
rotation with the geometry known. An IoU silhouette loss on the soft alpha
joins the RGB loss at the coarse stages of the anneal ladder.
"""
from __future__ import annotations

import argparse
import colorsys
import json
import math
import sys
import time

import numpy as np
import torch

from rtwc_tpu_torch.camera import Camera, basis, default_camera, projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.engine.engine import resolve_device
from rtwc_tpu_torch.heads import quantize_rgb_ste
from rtwc_tpu_torch.render.anneal import AnnealSchedule
from rtwc_tpu_torch.render.soft_kernel import render_frame_soft_kernel
from rtwc_tpu_torch.render.step_graph import CapturedStep
from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene


def build(width: int, height: int, n_spheres: int = 3):
    """The demo scene of examples/inverse_render.py:61-126: 3 canonical
    spheres + a ground plane, or for n_spheres > 3 an image-space grid of
    fully visible spheres at varying depths. Built on the host."""
    n = max(3, n_spheres)
    cfg = RenderConfig(width=width, height=height, max_spheres=max(4, n), max_planes=2,
                       soft_miss_penalty=300.0, soft_mask_k=10.0)
    s = empty_scene(cfg.max_spheres, cfg.max_planes)
    if n <= 3:
        s = add_sphere(s, 5.0, (0.0, 1.0, 22.0), (220.0, 50.0, 50.0), speed=1.0)
        s = add_sphere(s, 3.0, (-5.0, -1.0, 30.0), (50.0, 220.0, 50.0), speed=1.0)
        s = add_sphere(s, 4.0, (6.0, 2.0, 34.0), (50.0, 50.0, 220.0), speed=1.0)
    else:
        e1, e2 = projection_elements(cfg)
        cam = default_camera()
        r_ax, u_ax, f_ax = (v.numpy() for v in basis(cam.rot))
        pos = cam.pos.numpy()
        cols = max(1, math.ceil(math.sqrt(n * width / height)))
        rows = math.ceil(n / cols)
        phi = 0.6180339887498949
        for k in range(n):
            col, row = k % cols, k // cols
            vx = (2.0 * (col + 0.5) / cols - 1.0) * e1 * 0.35
            vy = (2.0 * (row + 0.5) / rows - 1.0) * e2 * 0.6
            z = 22.0 + 20.0 * ((k * phi) % 1.0)
            c = pos + (vx * r_ax + vy * u_ax + f_ax) * z
            r = 0.30 * (0.35 * e1 / cols) * z * 2.0
            cr, cg, cb = colorsys.hsv_to_rgb((k * phi) % 1.0, 1.0, 1.0)
            s = add_sphere(s, r, (float(c[0]), float(c[1]), float(c[2])),
                           (30.0 + 215.0 * cr, 30.0 + 215.0 * cg, 30.0 + 215.0 * cb), speed=1.0)
    if n <= 3:
        ground_y = -4.0
    else:
        ground_y = float(np.min(s.spheres.center.numpy()[:n, 1]
                                - s.spheres.radius.numpy()[:n])) - 2.0
    s = add_plane(s, (0.0, ground_y, 30.0), (0.0, 1.0, 0.0), (120.0, 120.0, 120.0), 80.0, 80.0)
    return cfg, s


def make_target(scene, camera, stage, quantized: bool):
    """(target rgb, target alpha) at the sharpest stage, detached."""
    tau, cfg = stage
    with torch.no_grad():
        fb = render_frame_soft_kernel(scene, camera, cfg, tau=tau)
        rgb = quantize_rgb_ste(fb.rgb) if quantized else fb.rgb
    return rgb.detach(), fb.alpha.detach()


def loss_of(fb, target, target_a, w_sil: float, quantized: bool):
    """RGB MSE, plus w_sil * (1 - IoU) of the soft alpha."""
    rgb = quantize_rgb_ste(fb.rgb) if quantized else fb.rgb
    loss = torch.mean(((rgb - target) / 255.0) ** 2)
    if w_sil:
        inter = torch.sum(fb.alpha * target_a)
        union = torch.sum(fb.alpha + target_a - fb.alpha * target_a)
        loss = loss + w_sil * (1.0 - inter / torch.clamp(union, min=1e-6))
    return loss


def centre_noise(true_scene, perturb: float, seed: int) -> np.ndarray:
    """Phase A's perturbation of the centres [N, 3] f32, drawn from `seed`
    as examples/inverse_render.py draws it (0 on inactive slots)."""
    live = true_scene.spheres.active.numpy() > 0.5
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, perturb, size=(live.shape[0], 3)).astype(np.float32)
    noise[~live] = 0.0
    return noise


def centre_errors(cfg: RenderConfig, true_scene, fit_centers: np.ndarray):
    """(reprojection error, size error) in pixels of each live sphere's
    fitted centre under the default camera: the distance between the true
    and fitted centres' pixel positions, and the difference of the true
    radius's pixel size at the two depths."""
    e1, e2 = projection_elements(cfg)
    W, H = cfg.width, cfg.height
    cam = default_camera()
    r, u, f = basis(cam.rot)
    B = np.stack([r.numpy(), u.numpy(), f.numpy()])

    def project_px(pts):
        v = (pts - cam.pos.numpy()) @ B.T
        return np.stack([v[:, 0] / v[:, 2] / e1 * (W / 2),
                         v[:, 1] / v[:, 2] / e2 * (H / 2)], axis=1)

    idx = np.flatnonzero(true_scene.spheres.active.numpy() > 0.5)
    centers = true_scene.spheres.center.numpy()
    reproj = np.linalg.norm(project_px(centers[idx]) - project_px(fit_centers[idx]), axis=1)
    radii = true_scene.spheres.radius.numpy()[idx]
    size_px = np.abs(radii / fit_centers[idx, 2] - radii / centers[idx, 2]) / e1 * (W / 2)
    return reproj, size_px


def fit(render_args, params, stages, steps: int, lr: float, target, target_a,
        w_sil: float, quantized: bool, graph: bool | None = None, adam: dict | None = None,
        render=render_frame_soft_kernel, stage_end=None):
    """Adam with a cosine decay to 0 over `steps`, spread over the stages
    (remainder to the earliest); the silhouette term drops out at the last
    stage. render_args() -> (scene, camera) built around the trained
    leaves `params`. Each step is a CapturedStep (a CUDA graph of the
    render, the loss and the backward on the card unless graph=False,
    captured again at each stage), then torch's default Adam, eagerly.
    adam: torch.optim.Adam's options beside lr (default none: torch's
    default Adam); render(scene, camera, config, tau=) -> a framebuffer with
    rgb and alpha (default the kernel path); stage_end() -> a dict added to
    each stage's log entry at its end. Returns (final loss, per-stage
    log)."""
    opt = torch.optim.Adam(params, lr=lr, **(adam or {}))
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: 0.5 * (1.0 + math.cos(math.pi * min(i, steps) / steps)))
    stage = {}

    def step_loss():
        scene, cam = render_args()
        fb = render(scene, cam, stage["cfg"], tau=stage["tau"])
        return loss_of(fb, target, target_a, stage["ws"], quantized)

    step = CapturedStep(step_loss, opt, graph=graph)
    n_stages = len(stages)
    per = [steps // n_stages + (1 if i < steps % n_stages else 0) for i in range(n_stages)]
    log, loss = [], torch.zeros(())
    for si, ((tau, cfg), n) in enumerate(zip(stages, per)):
        stage.update(tau=tau, cfg=cfg, ws=w_sil if si < n_stages - 1 else 0.0)
        for _ in range(n):
            loss = step(key=si)
            sched.step()
        value = float(loss.detach())
        print(f"  stage tau={tau:7.3f}  loss {value:.6f}", flush=True)
        log.append({"tau": float(tau), "steps": n, "loss": value,
                    **(stage_end() if stage_end else {})})
    return float(loss.detach()), log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtwc_tpu_torch.examples.inverse_render")
    p.add_argument("--steps", type=int, default=300, help="steps per phase")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument("--tau0", type=float, default=20.0,
                   help="coarsest temperature of the anneal ladder")
    p.add_argument("--tau", type=float, default=0.05,
                   help="final display-sharp temperature (target rendered here)")
    p.add_argument("--anneal", type=int, default=5, help="ladder stages")
    p.add_argument("--lr", type=float, default=3e-2)
    p.add_argument("--w-sil", type=float, default=1.0,
                   help="IoU silhouette loss weight at coarse stages")
    p.add_argument("--perturb", type=float, default=1.5)
    p.add_argument("--quantized", action="store_true",
                   help="fit through the ANSI-256-quantized console image (straight-through "
                        "quantization head)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spheres", type=int, default=3,
                   help="number of spheres (20 @ 1080p = BASELINE config 3)")
    p.add_argument("--json-out", type=str, default=None,
                   help="write a JSON artifact (per-stage losses, final errors, wall clock) here")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device; cuda without a card raises")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg, true_scene = build(args.width, args.height, args.spheres)
    e1, _ = projection_elements(cfg)
    W, H = cfg.width, cfg.height
    stages = list(AnnealSchedule(n_stages=args.anneal, tau0=args.tau0, tau1=args.tau).configs(cfg))
    true_cam = default_camera()
    scene_d = true_scene.to(dev)
    cam_d = true_cam.to(dev)
    target, target_a = make_target(scene_d, cam_d, stages[-1], args.quantized)

    live = true_scene.spheres.active.numpy() > 0.5
    idx = np.flatnonzero(live)
    centers = true_scene.spheres.center.numpy()
    t0 = time.perf_counter()

    # ---- phase A: geometry (camera known) -----------------------------------
    noise = centre_noise(true_scene, args.perturb, args.seed)
    center = torch.from_numpy(centers + noise).to(dev).requires_grad_(True)
    print(f"phase A: recover sphere centers (max perturbation "
          f"{np.linalg.norm(noise[idx], axis=1).max():.2f} world units)")

    def scene_a():
        return scene_d.replace(spheres=scene_d.spheres.replace(center=center)), cam_d

    def stage_errors():
        """Every live sphere's reprojection error after a stage (px)."""
        return {"reproj_px": np.round(centre_errors(
            cfg, true_scene, center.detach().cpu().numpy())[0], 4).tolist()}

    _, log_a = fit(scene_a, [center], stages, args.steps, args.lr, target, target_a,
                   args.w_sil, args.quantized, stage_end=stage_errors)
    reproj, size_px = centre_errors(cfg, true_scene, center.detach().cpu().numpy())
    reproj0 = centre_errors(cfg, true_scene, centers + noise)[0]

    # ---- phase B: camera pose (geometry known); pitch / yaw only ------------
    rot = (true_cam.rot + torch.tensor([0.02, -0.03, 0.0])).to(dev).requires_grad_(True)
    print("phase B: recover camera rotation (perturbation 0.036 rad)")

    def scene_b():
        return scene_d, Camera(pos=cam_d.pos, rot=rot)

    _, log_b = fit(scene_b, [rot], stages[-2:], args.steps, 5e-3, target, target_a,
                   args.w_sil, args.quantized)
    rot_err = float(np.abs(rot.detach().cpu().numpy() - true_cam.rot.numpy()).max())
    px_angle = 2.0 * e1 / W  # one pixel's angular size at image centre

    dt = time.perf_counter() - t0
    print(f"\n2 x {args.steps} steps in {dt:.1f}s")
    print(f"phase A reprojection error: {np.round(reproj0, 2)} -> "
          f"{np.round(reproj, 3)} px; size error {np.round(size_px, 3)} px")
    print(f"phase B rotation error: {rot_err:.5f} rad ({rot_err / px_angle:.2f} pixel-angles)")
    ok_a = bool((reproj < 1.0).all() and (size_px < 1.0).all())
    ok_b = bool(rot_err < px_angle)
    print(f"phase A {'OK (sub-pixel)' if ok_a else 'DID NOT CONVERGE'} | "
          f"phase B {'OK (sub-pixel)' if ok_b else 'DID NOT CONVERGE'}")
    if args.json_out:
        rec = {
            "kind": "inverse_render_fit",
            "config": {"width": W, "height": H, "spheres": int(live.sum()), "planes": 1,
                       "steps_per_phase": args.steps, "anneal_stages": args.anneal,
                       "tau0": args.tau0, "tau": args.tau,
                       "perturb_world_units": args.perturb, "quantized": bool(args.quantized)},
            "backend": f"torch {torch.__version__} {dev.type}",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "phase_a_stages": log_a,
            "phase_b_stages": log_b,
            "phase_a_reproj_px_before": np.round(reproj0, 3).tolist(),
            "phase_a_reproj_px_after": np.round(reproj, 4).tolist(),
            "phase_a_size_err_px": np.round(size_px, 4).tolist(),
            "phase_b_rot_err_rad": rot_err,
            "phase_b_rot_err_pixel_angles": float(rot_err / px_angle),
            "wall_clock_s": round(dt, 1),
            "sub_pixel": bool(ok_a and ok_b),
        }
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if (ok_a and ok_b) else 1


if __name__ == "__main__":
    sys.exit(main())
