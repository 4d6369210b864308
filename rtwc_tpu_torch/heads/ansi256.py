"""ANSI-256 (xterm) colour quantizer in torch.

Counterpart: rtwc_tpu/heads/ansi256.py:20-150 (ANSIRGB.h:114-189). The
palette and grey-LUT builders are NumPy and copied as they are, so both
packages derive the same tables. The luminance sum peaks near 4.28e9,
past int32, so it is computed in int64 here (uint32 in JAX).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_SYSTEM16 = [
    0x000000, 0xCD0000, 0x00CD00, 0xCDCD00, 0x0000EE, 0xCD00CD, 0x00CDCD, 0xE5E5E5,
    0x7F7F7F, 0xFF0000, 0x00FF00, 0xFFFF00, 0x5C5CFF, 0xFF00FF, 0x00FFFF, 0xFFFFFF,
]
_CUBE_LEVELS = np.array([0, 95, 135, 175, 215, 255], np.int64)


def _build_palette() -> np.ndarray:
    """256 x 3 uint8 palette: 16 system colours, 6x6x6 cube, 24 greys."""
    pal = np.zeros((256, 3), np.uint8)
    for i, c in enumerate(_SYSTEM16):
        pal[i] = [(c >> 16) & 0xFF, (c >> 8) & 0xFF, c & 0xFF]
    idx = 16
    for r in _CUBE_LEVELS:
        for g in _CUBE_LEVELS:
            for b in _CUBE_LEVELS:
                pal[idx] = [r, g, b]
                idx += 1
    for i in range(24):
        v = i * 10 + 8
        pal[232 + i] = [v, v, v]
    return pal


ANSI_PALETTE = _build_palette()  # np.uint8 [256, 3]


def _build_grey_lut() -> np.ndarray:
    """ansi256_from_grey LUT (ANSIRGB.h:143-176): nearest of the cube
    diagonal and the grey ramp; midpoint ties go to the lower level up to
    v = 118 and to the higher level above."""
    cand_idx = np.array([16 + 43 * i for i in range(6)] + [232 + i for i in range(24)])
    cand_lvl = np.array(list(_CUBE_LEVELS) + [8 + 10 * i for i in range(24)])
    order = np.argsort(cand_lvl, kind="stable")
    cand_idx, cand_lvl = cand_idx[order], cand_lvl[order]
    lut = np.zeros(256, np.uint8)
    for v in range(256):
        d = np.abs(v - cand_lvl)
        minima = np.flatnonzero(d == d.min())
        best = minima[0] if v <= 118 else minima[-1]
        lut[v] = cand_idx[best]
    return lut


GREY_LUT = _build_grey_lut()

_THRESH_R = np.array([38, 115, 155, 196, 235], np.int64)
_THRESH_G = np.array([36, 116, 154, 195, 235], np.int64)
_THRESH_B = np.array([35, 115, 155, 195, 235], np.int64)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """Palette, grey LUT, cube levels and thresholds as int64 tensors on
    `device`, uploaded once per device."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    return (t(ANSI_PALETTE), t(GREY_LUT), t(_CUBE_LEVELS),
            t(_THRESH_R), t(_THRESH_G), t(_THRESH_B))


def _distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Red-mean weighted squared distance (ANSIRGB.h:118-124)."""
    r_sum = x[..., 0] + y[..., 0]
    d = x - y
    return ((1024 + r_sum) * d[..., 0] * d[..., 0] + 2048 * d[..., 1] * d[..., 1]
            + (1534 - r_sum) * d[..., 2] * d[..., 2])


def _luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Integer luminance (ANSIRGB.h:126-133), fixed point rounded >> 24."""
    v = 3567664 * rgb[..., 0] + 11998547 * rgb[..., 1] + 1211005 * rgb[..., 2]
    return (v + (1 << 23)) >> 24


def ansi256_from_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """rgb [..., 3], integer 0..255 or float (truncated toward zero like
    the reference's uint8_t casts). Returns int32 [...] xterm indices."""
    if rgb.is_floating_point():
        rgb = rgb.to(torch.int32)
    rgb = rgb.to(torch.int64)
    pal, grey_lut, levels, tr, tg, tb = _tables(rgb.device)

    grey_exact = grey_lut[rgb[..., 0]]
    is_grey = (rgb[..., 0] == rgb[..., 1]) & (rgb[..., 1] == rgb[..., 2])
    grey_index = grey_lut[_luminance(rgb)]
    grey_dist = _distance(rgb, pal[grey_index])

    ir = (rgb[..., 0, None] >= tr).sum(-1)
    ig = (rgb[..., 1, None] >= tg).sum(-1)
    ib = (rgb[..., 2, None] >= tb).sum(-1)
    cube_index = 16 + 36 * ir + 6 * ig + ib
    cube_rgb = torch.stack([levels[ir], levels[ig], levels[ib]], dim=-1)
    cube_dist = _distance(rgb, cube_rgb)

    best = torch.where(cube_dist < grey_dist, cube_index, grey_index)
    return torch.where(is_grey, grey_exact, best).to(torch.int32)


def rgb_from_ansi256(index: torch.Tensor) -> torch.Tensor:
    """Palette lookup (ANSIRGB.h:114-116). Returns int32 [..., 3]."""
    return _tables(index.device)[0][index.long()].to(torch.int32)


def quantize_rgb_ste(rgb: torch.Tensor) -> torch.Tensor:
    """Straight-through quantization head (ansi256.py:144-150): forward is
    the palette colour of the chosen ANSI index, backward the identity."""
    q = rgb_from_ansi256(ansi256_from_rgb(rgb)).to(rgb.dtype)
    return rgb + (q - rgb).detach()
