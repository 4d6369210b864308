"""Where the float32 camera-rotation gradient's error comes from, measured on
the port's torch soft renderer (render/softmin.py) at bench.py's
grad_cam_rot_rel config.

    python -m rtwc_tpu_torch.utils.cam_grad_precision [--width 640] [--height 360]

Port of scripts/cam_grad_precision.py. It runs on the CPU (float64 needs
it), renders the 640x360 grad_cam_rot_rel scene (`random_scene(20,
max_spheres=24, max_planes=4, seed=0)`, shadows, tau 0.5, miss penalty
300, mask k 10) with the default camera in float32 and in float64, and
takes d/d rot of JAX's study loss, mean((rgb / 255)^2) + 0.01 mean(depth)
/ far, through the rays the renderer traces. The rows go through in bands
(their gradients add), so the float64 graph stays within a few hundred MB.

Each ray's share of the rotation gradient is c = J^T g: g = dL/d(ray
direction) (the per-ray cotangent, from autograd in the render's precision)
and J = d(direction)/d(rot) (in float64, by forward mode). With g64 the
float64 gradient, g32 the float32 program's own (autograd's float32 sums)
and e32 = the exact (float64) sum of the float32 rays' shares, the float32
error |g32 - g64| splits into
  - per-ray cotangent error |e32 - g64|: the float32 cotangents summed
    exactly still miss float64 by this much;
  - summation error |g32 - e32|: what float32 sums (and the rays' float32
    backward) add on top.
Each is reported relative to the largest component of g64, beside the sums'
condition numbers (sum |c| / |sum c| for pitch and yaw) and the per-ray
error's mean, 99.9th percentile and maximum. One JSON line on stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from rtwc_tpu_torch.camera import Camera, default_camera
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render.softmin import _soft_rays, trace_soft
from rtwc_tpu_torch.scene import random_scene

TAU = 0.5


def _cast(scene, dtype):
    def cast(group):
        return group.replace(**{name: getattr(group, name).to(dtype)
                                for name in group.__dataclass_fields__
                                if getattr(group, name).is_floating_point()})
    return scene.replace(spheres=cast(scene.spheres), planes=cast(scene.planes))


def _ray_dirs(rot: torch.Tensor, config: RenderConfig, rows: slice):
    """The renderer's ray directions (softmin._soft_rays) of image rows
    `rows`, in rot's dtype, differentiable in rot."""
    _, dirs = _soft_rays(Camera(pos=torch.zeros(3, dtype=rot.dtype), rot=rot), config, "cpu")
    return dirs[rows]


def per_ray(config: RenderConfig, dtype: torch.dtype, bands: int):
    """(per-ray cotangents g [H, W, 3] in dtype, the program's rotation
    gradient [3] in dtype): the loss's gradient through the ray directions,
    band by band."""
    scene = _cast(random_scene(20, max_spheres=24, max_planes=4, seed=0), dtype)
    cam = default_camera()
    rot = cam.rot.to(dtype).requires_grad_(True)
    pos = cam.pos.to(dtype)
    H, W = config.height, config.width
    g = torch.empty((H, W, 3), dtype=dtype)
    for rows in np.array_split(np.arange(H), bands):
        sl = slice(int(rows[0]), int(rows[-1]) + 1)
        dirs = _ray_dirs(rot, config, sl)
        dirs.retain_grad()
        rgb, depth, _, _ = trace_soft(scene, pos, dirs, config, tau=TAU)
        loss = (torch.sum((rgb / 255.0) ** 2) / (3.0 * H * W)
                + 0.01 * torch.sum(depth) / (H * W) / config.far)
        loss.backward()
        g[sl] = dirs.grad
    return g.detach(), rot.grad.detach()


def ray_jacobian(config: RenderConfig) -> torch.Tensor:
    """d(direction)/d(rot) of every ray in float64 at the default camera,
    [H, W, 3, 3] (direction component, rot component), by forward mode."""
    rot = default_camera().rot.double()
    cols = []
    for k in range(3):
        tangent = torch.zeros(3, dtype=torch.float64)
        tangent[k] = 1.0
        cols.append(torch.func.jvp(lambda r: _ray_dirs(r, config, slice(None)), (rot,),
                                   (tangent,))[1])
    return torch.stack(cols, dim=-1)


def measure(width: int = 640, height: int = 360, bands: int = 10) -> dict:
    config = RenderConfig(width=width, height=height, max_spheres=24, max_planes=4,
                          soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=True)
    g32, rot32 = per_ray(config, torch.float32, bands)
    g64, rot64 = per_ray(config, torch.float64, bands)
    J = ray_jacobian(config)
    c32 = torch.einsum("hwd,hwdk->hwk", g32.double(), J)
    c64 = torch.einsum("hwd,hwdk->hwk", g64, J)
    e32, e64 = c32.sum((0, 1)), c64.sum((0, 1))
    g64v, g32v = rot64.numpy(), rot32.double().numpy()
    scale = float(np.abs(g64v).max())
    err = (c32 - c64).abs().amax(-1).numpy()
    return {
        "config": {"width": width, "height": height, "spheres": 20, "tau": TAU, "bands": bands,
                   "loss": "mean((rgb/255)^2) + 0.01 mean(depth) / far"},
        "rot_grad_f64": g64v.round(10).tolist(),
        "rot_grad_f32": g32v.round(10).tolist(),
        "rot_grad_exact_sum_of_f32_rays": e32.numpy().round(10).tolist(),
        "rel_err_f32_total": float(np.abs(g32v - g64v).max() / scale),
        "rel_err_per_ray_cotangents": float(np.abs(e32.numpy() - g64v).max() / scale),
        "rel_err_summation": float(np.abs(g32v - e32.numpy()).max() / scale),
        # the float64 rays' shares, summed, against autograd's float64 gradient:
        # the Jacobian's check
        "rel_err_f64_jacobian_check": float(np.abs(e64.numpy() - g64v).max() / scale),
        "sum_condition_numbers": (c64.abs().sum((0, 1))[:2] / e64[:2].abs()).numpy()
                                 .round(1).tolist(),
        "per_ray_err_mean": float(err.mean()),
        "per_ray_err_p999": float(np.percentile(err, 99.9)),
        "per_ray_err_max": float(err.max()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rtwc_tpu_torch.utils.cam_grad_precision",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--bands", type=int, default=10, help="row bands a backward")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    print(json.dumps(measure(args.width, args.height, args.bands)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
