"""Fit an occluder you cannot see, from the shadow it casts, on the port.

    python -m rtwc_tpu_torch.examples.fit_from_shadow [--steps 300] [--width 320]
        [--height 96] [--device cuda|cpu]

Counterpart: examples/fit_from_shadow.py, with the same scene, flags,
printout and exit code (0 iff it prints FIT OK), plus --device (default
cuda; it raises without a card). The occluding sphere sits far above the
camera frustum: no primary ray hits it, so the unshadowed image is the same
with or without it (the script measures this). Its only trace is the soft
shadow it throws on the ground plane, and because the shadowed kernels
(K4 / K5 through render_frame_soft_kernel) differentiate through the
shadow term, gradient descent on the image loss recovers its position.
optax.adam becomes torch.optim.Adam with the same defaults.

A single point light leaves the occluder's position along the light ray
nearly unobservable, so the demo fits the well-posed coordinates, the
horizontal position at a known height, and reports the residual.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from rtwc_tpu_torch.camera import default_camera
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.engine.engine import resolve_device
from rtwc_tpu_torch.render.soft_kernel import render_frame_soft_kernel
from rtwc_tpu_torch.render.step_graph import CapturedStep
from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene

TRUE_OCCLUDER = (2.0, 26.0, 20.0)  # between the light (1, 50, 0) and the floor
OCCLUDER = 1                       # its sphere slot


def build(width: int, height: int):
    """(config, scene): a floor, one visible sphere, and the hidden occluder."""
    cfg = RenderConfig(width=width, height=height, max_spheres=2, max_planes=1,
                       soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=True)
    s = empty_scene(cfg.max_spheres, cfg.max_planes)
    s = add_plane(s, (0.0, -4.0, 40.0), (0.0, 1.0, 0.0), (120.0, 120.0, 120.0), 120.0, 120.0)
    s = add_sphere(s, 4.0, (-8.0, 0.0, 45.0), (220.0, 60.0, 60.0), speed=1.0)
    s = add_sphere(s, 4.0, TRUE_OCCLUDER, (60.0, 60.0, 220.0), speed=1.0)
    return cfg, s


def scene_at(scene, xz: torch.Tensor):
    """The scene with the occluder's centre at (x, TRUE_OCCLUDER[1], z),
    differentiable in xz."""
    centers = scene.spheres.center
    y = torch.full((1,), TRUE_OCCLUDER[1], dtype=torch.float32, device=xz.device)
    c = torch.cat([xz[:1], y, xz[1:]])[None, :]
    return scene.replace(spheres=scene.spheres.replace(
        center=torch.cat([centers[:OCCLUDER], c, centers[OCCLUDER + 1:]])))


def image_loss(scene, cam, cfg, tau: float, target: torch.Tensor) -> torch.Tensor:
    fb = render_frame_soft_kernel(scene, cam, cfg, tau=tau)
    return torch.mean(((fb.rgb - target) / 255.0) ** 2)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtwc_tpu_torch.examples.fit_from_shadow")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-1)
    p.add_argument("--offset", type=float, nargs=2, default=(3.0, 4.0),
                   help="initial occluder (x, z) displacement from the truth")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device; cuda without a card raises")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, true_scene = build(args.width, args.height)
    true_scene = true_scene.to(dev)
    cam = default_camera().to(dev)

    with torch.no_grad():
        # Prove the occluder is invisible to primary rays: without shadows
        # the image does not change when it is removed.
        active = true_scene.spheres.active.clone()
        active[OCCLUDER] = 0.0
        no_occ = true_scene.replace(spheres=true_scene.spheres.replace(active=active))
        lit_cfg = cfg.replace(shadows=False)
        img_with = render_frame_soft_kernel(true_scene, cam, lit_cfg, tau=args.tau).rgb
        img_without = render_frame_soft_kernel(no_occ, cam, lit_cfg, tau=args.tau).rgb
        occ_visible = float((img_with - img_without).abs().max())
        print(f"occluder silhouette contribution (unshadowed): {occ_visible:.2e} "
              f"(must be ~0: out of frustum)")
        target = render_frame_soft_kernel(true_scene, cam, cfg, tau=args.tau).rgb
        shadow_signal = float((target - render_frame_soft_kernel(
            no_occ, cam, cfg, tau=args.tau).rgb).abs().max())
        print(f"cast-shadow signal in the target: {shadow_signal:.1f}/255")

    true_xz = torch.tensor([TRUE_OCCLUDER[0], TRUE_OCCLUDER[2]], dtype=torch.float32, device=dev)
    xz = (true_xz + torch.tensor(args.offset, dtype=torch.float32, device=dev)).requires_grad_(True)
    opt = torch.optim.Adam([xz], lr=args.lr)
    # one CUDA graph a step on the card (render/step_graph.py), then Adam
    step = CapturedStep(lambda: image_loss(scene_at(true_scene, xz), cam, cfg, args.tau, target),
                        opt)

    err0 = float(torch.linalg.norm(torch.tensor(args.offset, dtype=torch.float64)))
    loss0 = loss = None
    t0 = time.perf_counter()
    for i in range(args.steps):
        loss = step()
        if i == 0:
            loss0 = loss.item()
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            err = float(torch.linalg.norm(xz.detach() - true_xz))
            print(f"step {i:4d}  loss {loss.item():.6f}  occluder error {err:.3f}", flush=True)
    dt = time.perf_counter() - t0

    err = float(torch.linalg.norm(xz.detach() - true_xz))
    print(f"\n{args.steps} steps in {dt:.1f}s")
    if loss is not None:
        print(f"loss: {loss0:.6f} -> {loss.item():.6f}")
    print(f"occluder (x, z) error: {err0:.3f} -> {err:.3f} "
          f"(recovered through its shadow alone)")
    ok = occ_visible < 1e-3 and err < 0.2 * err0
    print("FIT OK" if ok else "FIT DID NOT CONVERGE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
