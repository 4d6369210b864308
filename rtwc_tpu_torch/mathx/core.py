"""Core math helpers and the tensor-dataclass utility.

Counterpart: rtwc_tpu/mathx/core.py:13-46. `tensor_dataclass` takes the
place of `pytree_dataclass`: a frozen dataclass whose fields are tensors
(or nested tensor dataclasses), with `replace` and `to(device)`.
"""
from __future__ import annotations

import dataclasses
from typing import TypeVar

import torch

_T = TypeVar("_T")


def dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Vector dot product along a dimension (MyMath.cu:4-14 Dot)."""
    return torch.sum(a * b, dim=dim)


def normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unchecked normalize, mirroring Normalize_GPU (MyMath.h:139-157): no
    zero-length guard. Use safe_normalize where zero vectors can occur."""
    return v * torch.rsqrt(torch.sum(v * v, dim=dim, keepdim=True))


def safe_normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-20) -> torch.Tensor:
    """Zero-safe normalize, mirroring the CPU Normalize (MyMath.h:117-135)."""
    sq = torch.sum(v * v, dim=dim, keepdim=True)
    return v * torch.rsqrt(torch.clamp(sq, min=eps))


def tensor_dataclass(cls: type[_T]) -> type[_T]:
    """Make `cls` a frozen dataclass of tensors with `replace(**fields)` and
    `to(device)` (which recurses into nested tensor dataclasses)."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def _to(self, device):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to(device)
        return dataclasses.replace(self, **out)

    cls.replace = _replace
    cls.to = _to
    return cls
