"""ASCII luminance ramp head.

Counterpart: rtwc_tpu/heads/ascii.py:13-33 (GetASCIICharacter,
RayTracing.cu:26-39, and the 68-character ramp of RayTracing.h:97-115).
"""
from __future__ import annotations

import torch

ASCII_RAMP = (
    " .`^\",:;Il!i><~+_-?*]["
    "}{1)(|/tfjrxnuvczmwXYUJCLqpdbkhao#%ZO8B$0QM&W@"
)
NUM_ASCII = len(ASCII_RAMP)
if NUM_ASCII != 68:
    raise ImportError("ASCII ramp must hold 68 characters")
ASCII_BYTES = bytes(ASCII_RAMP, "ascii")


def ascii_indices(shading: torch.Tensor, depth: torch.Tensor, far: float) -> torch.Tensor:
    """index = clamp(ceil(s * 67), 1, 67), 0 for misses (depth > far)."""
    idx = torch.ceil(shading * (NUM_ASCII - 1)).to(torch.int32)
    idx = torch.clamp(idx, 1, NUM_ASCII - 1)
    return torch.where(depth > far, 0, idx)
