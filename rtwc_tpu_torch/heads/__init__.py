from rtwc_tpu_torch.heads.ascii import ASCII_RAMP, NUM_ASCII, ascii_indices
from rtwc_tpu_torch.heads.ansi256 import (
    ANSI_PALETTE,
    GREY_LUT,
    ansi256_from_rgb,
    quantize_rgb_ste,
    rgb_from_ansi256,
)
from rtwc_tpu_torch.heads.encode import encode_frame, encode_frame_numpy
from rtwc_tpu_torch.heads.modes import framebuffer_to_cells

__all__ = [
    "ascii_indices",
    "ASCII_RAMP",
    "NUM_ASCII",
    "ansi256_from_rgb",
    "rgb_from_ansi256",
    "quantize_rgb_ste",
    "ANSI_PALETTE",
    "GREY_LUT",
    "framebuffer_to_cells",
    "encode_frame",
    "encode_frame_numpy",
]
