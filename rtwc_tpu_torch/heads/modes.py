"""Rendering-mode heads: framebuffer -> per-cell (kind, colour, char).

Counterpart: rtwc_tpu/heads/modes.py:24-87 (the RayTracing::RayTrace
switch, RayTracing.cu:797-867). Runs on the framebuffer's device, so only
the compact int32 cell arrays travel to the host:

  kind  [H, W] int32: 0 = background escape, 1 = foreground escape
  color [H, W] int32 (256-colour index) or [H, W, 3] int32 (truecolour)
  char  [H, W] int32 ASCII code of the glyph
"""
from __future__ import annotations

import functools

import torch

from rtwc_tpu_torch.config import RenderConfig, RenderMode
from rtwc_tpu_torch.heads.ansi256 import ansi256_from_rgb
from rtwc_tpu_torch.heads.ascii import ASCII_RAMP, ascii_indices
from rtwc_tpu_torch.render.reference import Framebuffer

_SPACE = 32


@functools.lru_cache(maxsize=None)
def _ascii_codes(device: torch.device) -> torch.Tensor:
    return torch.tensor([ord(c) for c in ASCII_RAMP], dtype=torch.int32, device=device)


def _ascii_chars(fb: Framebuffer, far: float) -> torch.Tensor:
    idx = ascii_indices(fb.shading, fb.depth, far)
    return _ascii_codes(fb.depth.device)[idx.long()]


def _trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """(uint8_t) cast of pre-clamped floats: clamp, then truncate to int32."""
    return torch.clamp(x, 0.0, 255.0).to(torch.int32)


def framebuffer_to_cells(fb: Framebuffer, config: RenderConfig):
    """Dispatch on config.mode. Returns (kind, color, char) int32 tensors."""
    mode = config.mode
    hit = fb.hit
    visible = fb.coverage > 0.0
    H, W = fb.depth.shape
    dev = fb.depth.device

    def full(v):
        return torch.full((H, W), v, dtype=torch.int32, device=dev)

    if mode in (RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL):
        idx = ansi256_from_rgb(_trunc_u8(fb.rgb))
        color = torch.where(visible, idx, 16)
        if mode == RenderMode.BIT_ASCII:
            kind = hit.to(torch.int32)
            char = torch.where(hit, _ascii_chars(fb, config.far), _SPACE)
        else:
            kind = full(0)
            char = full(_SPACE)
        return kind, color.to(torch.int32), char.to(torch.int32)

    if mode == RenderMode.RGB_ASCII:
        color = torch.where(visible[..., None], _trunc_u8(fb.rgb), 0)
        kind = hit.to(torch.int32)
        char = torch.where(hit, _ascii_chars(fb, config.far), _SPACE)
        return kind, color, char.to(torch.int32)

    if mode == RenderMode.RGB_PIXEL:
        color = torch.where(visible[..., None], _trunc_u8(fb.rgb), 0)
        return full(0), color, full(_SPACE)

    if mode == RenderMode.RGB_NORMALS:
        # normal * 255 clamped to [0, 255] (the reference wraps negatives).
        color = torch.where(visible[..., None], _trunc_u8(fb.normal * 255.0), 0)
        return full(0), color, full(_SPACE)

    raise ValueError(f"mode {mode} has no cell head (HEADLESS uses the raw framebuffer)")
