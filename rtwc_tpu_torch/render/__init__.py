from rtwc_tpu_torch.render.reference import (
    Framebuffer,
    blinn_phong,
    downsample_framebuffer,
    intersect_planes,
    intersect_spheres,
    render_frame,
    supersampled_config,
    trace_hard,
)
from rtwc_tpu_torch.render.hard_kernel import render_frame_kernel

__all__ = [
    "Framebuffer",
    "intersect_spheres",
    "intersect_planes",
    "trace_hard",
    "blinn_phong",
    "render_frame",
    "supersampled_config",
    "downsample_framebuffer",
    "render_frame_kernel",
]
