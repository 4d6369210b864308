"""Cells of the console modes from a framebuffer, and the ANSI-256 quantiser.

kind [H, W] (0 background escape, 1 foreground), colour [H, W] (256-colour
index) or [H, W, 3] (truecolour), char [H, W] (ASCII code), all int32, as
upstream's RayTracing.cu switch and ANSIRGB.h define them.
"""
from __future__ import annotations

import numpy as np
import torch

ASCII_RAMP = " .`^\",:;Il!i><~+_-?*][}{1)(|/tfjrxnuvczmwXYUJCLqpdbkhao#%ZO8B$0QM&W@"
SPACE = 32
_SYSTEM16 = [0x000000, 0xCD0000, 0x00CD00, 0xCDCD00, 0x0000EE, 0xCD00CD, 0x00CDCD, 0xE5E5E5,
             0x7F7F7F, 0xFF0000, 0x00FF00, 0xFFFF00, 0x5C5CFF, 0xFF00FF, 0x00FFFF, 0xFFFFFF]
_LEVELS = np.array([0, 95, 135, 175, 215, 255], np.int64)
_TR = np.array([38, 115, 155, 196, 235], np.int64)
_TG = np.array([36, 116, 154, 195, 235], np.int64)
_TB = np.array([35, 115, 155, 195, 235], np.int64)


def palette() -> np.ndarray:
    pal = np.zeros((256, 3), np.int64)
    for i, c in enumerate(_SYSTEM16):
        pal[i] = [(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF]
    idx = 16
    for r in _LEVELS:
        for g in _LEVELS:
            for b in _LEVELS:
                pal[idx] = [r, g, b]
                idx += 1
    for i in range(24):
        pal[232 + i] = [i * 10 + 8] * 3
    return pal


def grey_lut() -> np.ndarray:
    """Nearest of the cube diagonal and the grey ramp; midpoint ties go to
    the lower level up to 118 and to the higher one above."""
    cand_idx = np.array([16 + 43 * i for i in range(6)] + [232 + i for i in range(24)])
    cand_lvl = np.array(list(_LEVELS) + [8 + 10 * i for i in range(24)])
    order = np.argsort(cand_lvl, kind="stable")
    cand_idx, cand_lvl = cand_idx[order], cand_lvl[order]
    lut = np.zeros(256, np.int64)
    for v in range(256):
        d = np.abs(v - cand_lvl)
        minima = np.flatnonzero(d == d.min())
        lut[v] = cand_idx[minima[0] if v <= 118 else minima[-1]]
    return lut


def _dist(x, y):
    r = x[..., 0] + y[..., 0]
    d = x - y
    return ((1024 + r) * d[..., 0] * d[..., 0] + 2048 * d[..., 1] * d[..., 1]
            + (1534 - r) * d[..., 2] * d[..., 2])


def ansi256(rgb: torch.Tensor) -> torch.Tensor:
    """int rgb [..., 3] in 0..255 -> xterm index [...] (ANSIRGB.h:114-189)."""
    dev = rgb.device
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)  # noqa: E731
    pal, lut, lv = t(palette()), t(grey_lut()), t(_LEVELS)
    rgb = rgb.to(torch.int64)
    lum = (3567664 * rgb[..., 0] + 11998547 * rgb[..., 1] + 1211005 * rgb[..., 2]
           + (1 << 23)) >> 24
    grey_index = lut[lum]
    grey_dist = _dist(rgb, pal[grey_index])
    ir = (rgb[..., 0, None] >= t(_TR)).sum(-1)
    ig = (rgb[..., 1, None] >= t(_TG)).sum(-1)
    ib = (rgb[..., 2, None] >= t(_TB)).sum(-1)
    cube = torch.stack([lv[ir], lv[ig], lv[ib]], -1)
    best = torch.where(_dist(rgb, cube) < grey_dist, 16 + 36 * ir + 6 * ig + ib, grey_index)
    is_grey = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])
    return torch.where(is_grey, lut[rgb[..., 0]], best).to(torch.int32)


def _u8(x):
    return torch.clamp(x, 0.0, 255.0).to(torch.int32)


def _chars(fb, far):
    idx = torch.clamp(torch.ceil(fb["shading"] * (len(ASCII_RAMP) - 1)).to(torch.int32), 1,
                      len(ASCII_RAMP) - 1)
    idx = torch.where(fb["depth"] > far, 0, idx)
    codes = torch.tensor([ord(c) for c in ASCII_RAMP], dtype=torch.int32, device=idx.device)
    return codes[idx.long()]


def cells(fb: dict, mode: str, far: float):
    """(kind, colour, char) int32 of a downsampled framebuffer in `mode`."""
    hit, visible = fb["hit"], fb["coverage"] > 0.0
    H, W = fb["depth"].shape
    full = lambda v: torch.full((H, W), v, dtype=torch.int32, device=hit.device)  # noqa: E731
    if mode in ("bit_ascii", "bit_pixel"):
        color = torch.where(visible, ansi256(_u8(fb["rgb"])), 16).to(torch.int32)
        if mode == "bit_ascii":
            return hit.to(torch.int32), color, torch.where(hit, _chars(fb, far), SPACE).int()
        return full(0), color, full(SPACE)
    if mode == "rgb_ascii":
        color = torch.where(visible[..., None], _u8(fb["rgb"]), 0)
        return hit.to(torch.int32), color, torch.where(hit, _chars(fb, far), SPACE).int()
    if mode == "rgb_pixel":
        return full(0), torch.where(visible[..., None], _u8(fb["rgb"]), 0), full(SPACE)
    if mode == "rgb_normals":
        return full(0), torch.where(visible[..., None], _u8(fb["normal"] * 255.0), 0), full(SPACE)
    raise ValueError(f"no head for mode {mode!r}")
