"""The console frame's heads where K7's planes are: the wrapper of
csrc/cell_heads.cu and its plain version.

Replaces no Pallas kernel: the JAX package's box filter and mode heads
are XLA ops (rtwc_tpu/render/reference.py `downsample_framebuffer`,
rtwc_tpu/heads/modes.py), and the port ran them as torch ops. On the card
the engine's display step (engine/engine.py `_device_step`) goes from
K7's padded planes straight to the cells the encoder takes, in one
launch inside its CUDA graph. The kernel's source note gives its design
and what bounds it (bytes: one read of the planes its mode needs, one
write of the cells).

`cells_from_planes(out, config)` takes K7's [8, Hp, Wp] float32 stack of
the supersampled frame (render/hard_kernel.py `render_planes_packed` at
`supersampled_config(config)`) and returns (kind, color, char) int32 on
its device: kind and char [h, w], color [h, w] (ANSI-256 modes) or
[h, w, 3] (truecolor modes), for config's h x w cells, mode, far and
supersample. For CUDA tensors it launches the kernel (one launch, counted
in `LAUNCHES`) or raises; for CPU tensors it runs `cells_from_planes_plain`,
which is the chain of torch ops the kernel replaces:
`framebuffer_to_cells(downsample_framebuffer(planes_to_framebuffer(...)))`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from rtwc_tpu_torch.config import RenderConfig, RenderMode
from rtwc_tpu_torch.heads.modes import framebuffer_to_cells
from rtwc_tpu_torch.render import _cuda
from rtwc_tpu_torch.render.hard_kernel import N_OUT, planes_to_framebuffer
from rtwc_tpu_torch.render.reference import downsample_framebuffer, supersampled_config

# CUDA launches of the heads kernel in this process.
LAUNCHES = 0

# The kernel's mode numbers (csrc/cell_heads.cu) and its largest ss.
MODES = {RenderMode.BIT_ASCII: 0, RenderMode.BIT_PIXEL: 1, RenderMode.RGB_ASCII: 2,
         RenderMode.RGB_PIXEL: 3, RenderMode.RGB_NORMALS: 4}
TRUECOLOR = (RenderMode.RGB_ASCII, RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS)
MAX_SS = 8


class HeadsParams(ctypes.Structure):
    """Mirror of `struct HeadsParams` in csrc/cell_heads.cu."""

    _fields_ = [
        ("h", ctypes.c_int), ("w", ctypes.c_int), ("ss", ctypes.c_int),
        ("hp", ctypes.c_int), ("wp", ctypes.c_int), ("mode", ctypes.c_int),
        ("device", ctypes.c_int), ("far", ctypes.c_float),
        ("factor1", ctypes.c_float), ("factor3", ctypes.c_float),
        ("min_denom", ctypes.c_float),
    ]


def _fn():
    fn = _cuda.load("cell_heads").rtwc_cell_heads
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(HeadsParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(out: torch.Tensor, config: RenderConfig) -> int:
    """Raise on planes or a config the heads do not take; returns ss."""
    ss = int(config.supersample)
    if config.mode not in MODES:
        raise ValueError(f"mode {config.mode} has no cell head")
    if not 1 <= ss <= MAX_SS:
        raise ValueError(f"supersample must lie in [1, {MAX_SS}], got {ss}")
    if not isinstance(out, torch.Tensor) or out.dtype != torch.float32 or out.dim() != 3:
        raise ValueError(f"planes must be a float32 [{N_OUT}, Hp, Wp] tensor, got "
                         f"{getattr(out, 'dtype', type(out))} {tuple(getattr(out, 'shape', ()))}")
    h, w = config.height * ss, config.width * ss
    if out.shape[0] != N_OUT or out.shape[1] < h or out.shape[2] < w:
        raise ValueError(f"planes must be [{N_OUT}, >= {h}, >= {w}] for {config.height}x"
                         f"{config.width} cells at ss {ss}, got {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("planes must be contiguous")
    return ss


@torch.no_grad()
def cells_from_planes_plain(out: torch.Tensor, config: RenderConfig):
    """The plain version, on the planes' device: the torch ops the kernel
    replaces, in the engine's order."""
    ss = _check(out, config)
    fb = planes_to_framebuffer(out, supersampled_config(config), config.height * ss)
    return framebuffer_to_cells(downsample_framebuffer(fb, ss), config)


def mean_factor(cells: int, ss: int) -> float:
    """torch's CUDA mean scale of a pool of `cells` outputs over ss^2 x as
    many inputs: the outputs over the inputs, divided in float32."""
    return float(np.float32(cells) / np.float32(cells * ss * ss))


@torch.no_grad()
def cells_from_planes(out: torch.Tensor, config: RenderConfig):
    """(kind, color, char) int32 on the planes' device: the kernel on a
    CUDA device, the plain version on the CPU."""
    global LAUNCHES
    ss = _check(out, config)
    dev = out.device
    if dev.type == "cpu":
        return cells_from_planes_plain(out, config)
    if dev.type != "cuda":
        raise ValueError(f"the heads run on cuda (plain version on cpu), not {dev}")
    if ss == 2 and (out.shape[2] % 2 or out.data_ptr() % 8):
        raise ValueError("at ss 2 the kernel's float2 loads need an even Wp and 8-byte aligned "
                         "planes")
    h, w = config.height, config.width
    kind = torch.empty((h, w), dtype=torch.int32, device=dev)
    char = torch.empty((h, w), dtype=torch.int32, device=dev)
    truecolor = config.mode in TRUECOLOR
    color = torch.empty((h, w, 3) if truecolor else (h, w), dtype=torch.int32, device=dev)
    prm = HeadsParams(
        h=h, w=w, ss=ss, hp=out.shape[1], wp=out.shape[2], mode=MODES[config.mode],
        device=dev.index if dev.index is not None else torch.cuda.current_device(),
        far=float(np.float32(config.far)), factor1=mean_factor(h * w, ss),
        factor3=mean_factor(3 * h * w, ss), min_denom=float(np.float32(1.0 / (ss * ss))))
    rc = _fn()(out.data_ptr(), kind.data_ptr(), color.data_ptr(), char.data_ptr(),
               ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rtwc_cell_heads launch failed: cudaError {rc}")
    LAUNCHES += 1
    return kind, color, char
