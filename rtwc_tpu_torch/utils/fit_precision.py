"""Phase A of the inverse-render fit (examples/inverse_render.py: the sphere
centres, the camera known) under several forms of the same fit, to tell
float32 rounding amplified by Adam from a fault of the port's fit.

    python -m rtwc_tpu_torch.utils.fit_precision [--width 1920] [--height 1080]
        [--spheres 20] [--steps 400] [--tau0 2.0] [--perturb 0.5]
        [--variants default,single,fused,torch32,float64] [--bands 8] [--device cuda]

The anneal ladder's last tau, its stage count, the learning rate, the
silhouette weight and the seed are the entry point's defaults. Variants,
each from the same perturbed start and the same schedule:
  default  the entry point's fit: the kernel path (K1 / K2), torch's default
           Adam (its foreach form on a card), a CUDA graph a stage on a card
  single   the same with Adam(foreach=False)
  fused    the same with Adam(fused=True)
  torch32  the plain torch soft renderer (render/softmin.py) in row bands
           under torch.utils.checkpoint, float32, default Adam, eager
  float64  torch32 in float64: the scene, the target, the centres and
           Adam's state
Each renders its own target from the true scene at the sharpest stage.
Prints each stage loss as the fit does, a summary on stderr and one JSON
line on stdout: per variant each live sphere's reprojection and size error
after phase A in pixels, the stage losses, every sphere's reprojection
error after each stage and the seconds, and the
scatter of each sphere's reprojection error over the float32 variants.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.utils.checkpoint

from rtwc_tpu_torch.camera import Camera, default_camera
from rtwc_tpu_torch.engine.engine import resolve_device
from rtwc_tpu_torch.examples import inverse_render as IR
from rtwc_tpu_torch.render.anneal import AnnealSchedule
from rtwc_tpu_torch.render.softmin import _soft_rays, trace_soft
from rtwc_tpu_torch.utils.cam_grad_precision import _cast

VARIANTS = ("default", "single", "fused", "torch32", "float64")
_ADAM = {"default": {}, "single": {"foreach": False}, "fused": {"fused": True},
         "torch32": {}, "float64": {}}


def banded_render(bands: int):
    """render(scene, camera, config, tau=) -> rgb and alpha of the plain torch
    soft renderer, rows in `bands` bands, each under torch.utils.checkpoint
    (its intermediates are made again in the backward), in the scene's
    dtype."""
    def render(scene, camera, config, tau):
        origin, dirs = _soft_rays(camera, config, scene.device)
        parts = [torch.utils.checkpoint.checkpoint(
            lambda d: tuple(trace_soft(scene, origin, d, config, tau=tau)[i] for i in (0, 3)),
            dirs[int(r[0]):int(r[-1]) + 1], use_reentrant=False)
            for r in np.array_split(np.arange(config.height), bands)]
        return SimpleNamespace(rgb=torch.cat([p[0] for p in parts]),
                               alpha=torch.cat([p[1] for p in parts]))
    return render


def run_variant(name: str, args, dev: torch.device) -> dict:
    """Phase A under one variant: (reprojection, size error) of every live
    sphere after it, the stage losses, the seconds."""
    cfg, true_scene = IR.build(args.width, args.height, args.spheres)
    stages = list(AnnealSchedule(n_stages=args.anneal, tau0=args.tau0,
                                 tau1=args.tau).configs(cfg))
    dtype = torch.float64 if name == "float64" else torch.float32
    scene = _cast(true_scene, dtype).to(dev)
    cam = default_camera()
    cam = Camera(pos=cam.pos.to(dev, dtype), rot=cam.rot.to(dev, dtype))
    kernel = name in ("default", "single", "fused")
    render = IR.render_frame_soft_kernel if kernel else banded_render(args.bands)
    tau, scfg = stages[-1]
    with torch.no_grad():
        fb = render(scene, cam, scfg, tau=tau)
    target, target_a = fb.rgb.detach(), fb.alpha.detach()
    noise = IR.centre_noise(true_scene, args.perturb, args.seed)
    center = torch.from_numpy(true_scene.spheres.center.numpy() + noise).to(dev, dtype)
    center.requires_grad_(True)

    def scene_a():
        return scene.replace(spheres=scene.spheres.replace(center=center)), cam

    def stage_end():
        return {"reproj_px": IR.centre_errors(cfg, true_scene,
                                              center.detach().cpu().numpy())[0].tolist()}

    t0 = time.perf_counter()
    _, log = IR.fit(scene_a, [center], stages, args.steps, args.lr, target, target_a,
                    args.w_sil, False, graph=None if kernel else False, adam=_ADAM[name],
                    render=render, stage_end=stage_end)
    secs = time.perf_counter() - t0
    reproj, size_px = IR.centre_errors(cfg, true_scene,
                                       center.detach().cpu().numpy())
    return {"reproj_px": reproj.tolist(), "size_px": size_px.tolist(),
            "stage_losses": [e["loss"] for e in log],
            "stage_reproj_px": [e["reproj_px"] for e in log], "seconds": secs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rtwc_tpu_torch.utils.fit_precision",
                                description=__doc__.splitlines()[0])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spheres", type=int, default=20)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--tau0", type=float, default=2.0)
    p.add_argument("--perturb", type=float, default=0.5)
    p.add_argument("--variants", type=str, default=",".join(VARIANTS))
    p.add_argument("--bands", type=int, default=8, help="row bands of the torch renderer")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    # the rest of the fit as the entry point runs it by default
    fit_args = IR.build_parser().parse_args([])
    for k in ("tau", "anneal", "lr", "w_sil", "seed"):
        setattr(args, k, getattr(fit_args, k))
    dev = resolve_device(args.device)
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; choose from {VARIANTS}")
    out = {}
    for name in names:
        print(f"variant {name}", flush=True)
        out[name] = run_variant(name, args, dev)
    f32 = [n for n in names if n != "float64"]
    scatter = (np.ptp([out[n]["reproj_px"] for n in f32], axis=0).tolist()
               if len(f32) > 1 else None)
    rec = {"config": {k: getattr(args, k) for k in ("width", "height", "spheres", "steps",
                                                    "tau0", "tau", "anneal", "lr", "w_sil",
                                                    "perturb", "seed", "bands")},
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "torch": torch.__version__, "variants": out, "f32_reproj_scatter_px": scatter}
    for name in names:
        r = np.asarray(out[name]["reproj_px"])
        print(f"{name:8s} worst sphere {int(r.argmax())} at {r.max():.4f} px; every sphere "
              f"{np.round(r, 4).tolist()}; {out[name]['seconds']:.1f} s", file=sys.stderr)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
