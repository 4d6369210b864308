"""Render / engine configuration: a re-export of rtwc_tpu/config.py.

`rtwc_tpu.config` is pure dataclasses and imports nothing of JAX
(rtwc_tpu/__init__.py:10 imports only it), so both packages share one
definition of every render constant. The port reads `renderer` as
"auto" | "reference" | "kernel" ("auto" means "kernel").

Counterpart: rtwc_tpu/config.py:1-142.
"""
from rtwc_tpu.config import (  # noqa: F401  (re-export)
    DEFAULT_ENGINE_CONFIG,
    DEFAULT_RENDER_CONFIG,
    EngineConfig,
    RenderConfig,
    RenderMode,
)

__all__ = [
    "RenderConfig",
    "EngineConfig",
    "RenderMode",
    "DEFAULT_RENDER_CONFIG",
    "DEFAULT_ENGINE_CONFIG",
]
