"""CLI entry point: `python -m rtwc_tpu_torch`.

Counterpart: rtwc_tpu/engine/run.py:16-110, with the same flags, except:
  --renderer auto|reference|kernel   (auto = kernel)
  --device cuda|cpu                  (default cuda; cuda without a card raises)
"""
from __future__ import annotations

import argparse
import shutil
import sys

from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rtwc_tpu_torch",
                                description="Console ray tracer, PyTorch / CUDA port")
    p.add_argument("--width", type=int, default=0, help="cells; 0 = fit terminal")
    p.add_argument("--height", type=int, default=0, help="cells; 0 = fit terminal")
    p.add_argument("--mode", choices=[m.value for m in RenderMode if m != RenderMode.HEADLESS],
                   default=RenderMode.RGB_PIXEL.value)
    p.add_argument("--fov-divisor", type=float, default=1.5, help="fov = pi/divisor")
    p.add_argument("--far", type=float, default=250.0)
    p.add_argument("--shadows", action="store_true", help="hard shadows")
    p.add_argument("--supersample", type=int, default=1,
                   help="anti-aliasing: N^2 rays per cell, box-filtered")
    p.add_argument("--renderer", choices=["auto", "reference", "kernel"], default="auto",
                   help="forward renderer: auto = kernel (K7; its plain torch version "
                        "on --device cpu), reference = the plain torch renderer")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device; cuda without a card raises")
    p.add_argument("--max-spheres", type=int, default=256)
    p.add_argument("--no-spawn", action="store_true", help="disable the 1 Hz random sphere spawn")
    p.add_argument("--no-fps", action="store_true")
    p.add_argument("--no-mouse", action="store_true",
                   help="disable terminal mouse-look (arrow keys still work)")
    p.add_argument("--frames", type=int, default=0, help="stop after N frames (0 = run until quit)")
    p.add_argument("--scene", type=str, default="", help="load a saved .npz scene")
    p.add_argument("--save-scene", type=str, default="",
                   help="write the final scene + camera pose to this .npz on exit")
    p.add_argument("--n-spheres", type=int, default=0,
                   help="random scene with N spheres instead of the default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-print-fps", type=float, default=0.0)
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler trace of the run to this directory")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    width, height = args.width, args.height
    if width <= 0 or height <= 0:
        size = shutil.get_terminal_size((120, 40))
        width = width or max(16, size.columns - 1)
        height = height or max(8, size.lines - 3)

    rcfg = RenderConfig(
        width=width, height=height, mode=RenderMode(args.mode),
        fov_divisor=args.fov_divisor, far=args.far, shadows=args.shadows,
        supersample=max(1, args.supersample), renderer=args.renderer,
        max_spheres=args.max_spheres,
    )
    ecfg = EngineConfig(spawn=not args.no_spawn, show_fps=not args.no_fps,
                        mouse=not args.no_mouse, seed=args.seed,
                        max_print_fps=args.max_print_fps)

    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.scene import load_scene, random_scene, save_scene
    from rtwc_tpu_torch.utils import profiler_trace

    scene = camera = None
    if args.scene:
        scene, camera = load_scene(args.scene)
    elif args.n_spheres > 0:
        scene = random_scene(args.n_spheres, max_spheres=max(args.max_spheres, args.n_spheres),
                             seed=args.seed)

    engine = Engine(rcfg, ecfg, scene=scene, camera=camera, device=args.device)
    interrupted = False
    try:
        with profiler_trace(args.profile or None):
            engine.run(max_frames=args.frames or None)
    except KeyboardInterrupt:
        interrupted = True
    finally:
        if args.save_scene:
            save_scene(args.save_scene, engine.scene, engine.camera)
    return 130 if interrupted else 0


if __name__ == "__main__":
    sys.exit(main())
