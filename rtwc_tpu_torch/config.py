"""Render / engine configuration of the port.

Counterpart: rtwc_tpu/config.py:17-142. The port keeps its own copy of the
three classes and the two defaults, with the same field names, order and
defaults, so that it imports nothing of the JAX package;
tests/test_torch_hygiene.py holds the two to each other. A change to a
field or a default goes to both copies.

Every reference-parity constant of the renderer, the engine and the
presenter is a field on one frozen dataclass, overridable from the CLI.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class RenderMode(enum.Enum):
    """Rendering modes, parity with the reference's F1-F5 modes.

    Reference: RenderingMode enum (RayTracingManager.h:21) and the five
    __global__ kernel variants in RayTracing.cu:170-795. The reference's
    empty SDL stub (RayTracing.cu:754-795) maps to HEADLESS: the raw RGB
    framebuffer with no terminal encoding (used by tests and benchmarks).
    """

    BIT_ASCII = "bit_ascii"      # F1: ANSI-256 foreground + ASCII luminance ramp
    BIT_PIXEL = "bit_pixel"      # F2: ANSI-256 background blocks
    RGB_ASCII = "rgb_ascii"      # F3: 24-bit truecolor foreground + ASCII ramp
    RGB_PIXEL = "rgb_pixel"      # F4: 24-bit truecolor background blocks
    RGB_NORMALS = "rgb_normals"  # F5: normals debug view (truecolor background)
    HEADLESS = "headless"        # raw framebuffer, no ANSI encode (SDL-stub analogue)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time constants. Defaults mirror the reference."""

    # Console resolution in cells (Engine3D.cpp:16 uses 400x150 "low res";
    # 1920x500 is the documented "high res"; hard limits 1000x500 at
    # PrintMachine.h:3-4 do not apply here - any terminal size works).
    width: int = 400
    height: int = 150

    mode: RenderMode = RenderMode.RGB_PIXEL

    # Camera intrinsics: fov = pi / fov_divisor (Camera3D.h:80, Camera3D.cpp:10).
    fov_divisor: float = 1.5
    near: float = 0.1           # Camera3D.h:74
    far: float = 250.0          # Camera3D.h:75
    # Console cells are ~2x taller than wide; the reference folds this into
    # aspect = width / (aspect_coeff * width * height) (Camera3D.cpp:17).
    aspect_coeff: float = 0.01

    # Movement / input (Camera3D.cpp:144, :168).
    move_speed: float = 10.0
    mouse_sensitivity: float = 0.002

    # Light: hardcoded point light in the reference (RayTracing.cu:146-148).
    light_pos: Tuple[float, float, float] = (1.0, 50.0, 0.0)
    light_diffuse_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    light_specular_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    light_diffuse_power: float = 2000.0
    light_specular_power: float = 3000.0
    specular_hardness: float = 32.0      # RayTracing.cu:69
    ambient: float = 0.2                 # RayTracing.cu:77
    object_specular_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # RayTracing.cu:145

    # New capability (BASELINE north star): hard shadows via shadow rays.
    # The reference has no shadow term; off by default for parity.
    shadows: bool = False

    # Forward renderer for the display path: "auto" | "reference" | "kernel".
    # "auto" means "kernel" (the CUDA kernel on a card, its plain torch
    # version on the CPU); "reference" forces the plain reference renderer.
    renderer: str = "auto"

    # New capability: supersampled anti-aliasing. The display path renders
    # at (supersample*W, supersample*H) with an identical frustum and
    # box-filters down to the cell grid; 1 = reference parity (one ray per
    # cell, RayTracingManager.cu:120-125).
    supersample: int = 1

    # Static capacity for the padded struct-of-arrays scene. The reference
    # uses 5 MB device pools per type (Scene3D.h:6-7); here dynamic growth
    # becomes pad-to-capacity + active mask (static table shapes).
    max_spheres: int = 256
    max_planes: int = 16

    # Differentiability: temperature of the soft-min hit blend. 0.0 = hard
    # closest-hit (exact reference semantics, non-differentiable at edges).
    soft_tau: float = 0.0
    # Sharpness of the smooth hinge turning violated hit-conditions into
    # depth penalties (substituting for the hard branch tests of
    # Sphere.cu:42-60 / Plane.cu:47-68), and the penalty magnitude in depth
    # units (objects failing a condition are pushed ~miss_penalty past
    # their depth, i.e. far behind the background plane).
    soft_mask_k: float = 50.0
    soft_miss_penalty: float = 2500.0
    # Sharpness of the smooth occlusion step in the differentiable shadow
    # term (soft path only): each hard shadow-ray condition becomes a
    # sigmoid(k * condition); as k -> inf the soft visibility converges to
    # the hard any-occluder test (render/reference.py _shadow_visibility).
    soft_shadow_k: float = 50.0

    # Scene animation bounds (Sphere.cu:15-23: bob y within [-10, 10]).
    bob_min_y: float = -10.0
    bob_max_y: float = 10.0

    @property
    def fov(self) -> float:
        import math

        return math.pi / self.fov_divisor

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frame-loop / presenter settings (Engine3D.cpp, PrintMachine.cpp)."""

    # Spawn a random sphere once per second (Engine3D.cpp:60-69).
    spawn_interval_s: float = 1.0
    spawn: bool = True
    # FPS telemetry update cadence (Engine3D.cpp:60, PrintMachine.cpp:266-272).
    fps_update_interval_s: float = 1.0
    show_fps: bool = True
    # Print-thread max rate; the reference prints as fast as fwrite allows.
    max_print_fps: float = 0.0  # 0 = uncapped
    # Terminal mouse-look (xterm SGR any-motion tracking), the parity for
    # the reference's GetCursorPos camera rotation (Engine3D.cpp:200-239).
    mouse: bool = True
    # When the sphere pool fills, double its capacity (the reference grows
    # its device pointer array the same way, capped at 100 MB,
    # Scene3D.cpp:107-129).
    auto_grow: bool = True
    max_grow_spheres: int = 4096
    seed: int = 0


DEFAULT_RENDER_CONFIG = RenderConfig()
DEFAULT_ENGINE_CONFIG = EngineConfig()
