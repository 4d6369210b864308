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
from rtwc_tpu_torch.render.anneal import AnnealSchedule
from rtwc_tpu_torch.render.softmin import render_frame_soft, trace_soft
from rtwc_tpu_torch.render.soft_kernel import render_frame_soft_kernel, render_soft_mse_loss

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
    "AnnealSchedule",
    "trace_soft",
    "render_frame_soft",
    "render_frame_soft_kernel",
    "render_soft_mse_loss",
]
