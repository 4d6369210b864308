"""Engine: the interactive frame loop on one torch device.

Counterpart: rtwc_tpu/engine/engine.py:41-189 (Engine3D.cpp:30-79). Per
frame it polls input, moves the camera on the host, runs `_render_step`
(physics + render + AA downsample + mode head) on the device, and hands
the previous frame's encoded bytes to the presenter; once per second it
publishes FPS and spawns a random sphere.

Keeping frame k+1 in flight while frame k is encoded: JAX gets this from
async dispatch. Here each frame's cells are copied into pinned host
buffers with `copy_(non_blocking=True)` and a CUDA event is recorded after
the copies; `_publish` waits on that frame's event only, so frame k+1's
kernels, queued before frame k is encoded, keep the card busy meanwhile.
The scene stays on the device between frames; the camera pose stays on
the host and reaches the device once per frame as the packed [1, 16]
vector.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from rtwc_tpu_torch.camera import Camera, add_rot, default_camera, move
from rtwc_tpu_torch.config import EngineConfig, RenderConfig
from rtwc_tpu_torch.heads import encode_frame, framebuffer_to_cells
from rtwc_tpu_torch.io import ConsolePresenter, InputHandler
from rtwc_tpu_torch.render.hard_kernel import render_frame_kernel
from rtwc_tpu_torch.render.reference import (
    downsample_framebuffer,
    render_frame,
    supersampled_config,
)
from rtwc_tpu_torch.scene import Scene, default_scene, grow_scene, spawn_random_sphere, update_scene
from rtwc_tpu_torch.utils import Telemetry, Timer

log = logging.getLogger("rtwc_tpu_torch")

RENDERERS = ("auto", "reference", "kernel")


def resolve_device(device: torch.device | str) -> torch.device:
    """The torch device to run on. A CUDA device without a usable card
    raises: the port never falls back to the CPU on its own. On CUDA, TF32
    is switched off for matmuls and cuDNN (the display path has neither,
    but the setting is stated where the card path starts)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda was asked for, but torch finds no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def _pick_renderer(config: RenderConfig):
    """Display-path renderer: "auto" and "kernel" run K7
    (render/hard_kernel.py; the plain version on CPU tensors),
    "reference" the plain torch reference renderer."""
    if config.renderer in ("auto", "kernel"):
        return render_frame_kernel
    if config.renderer == "reference":
        return render_frame
    raise ValueError(f"renderer must be one of {RENDERERS}, got {config.renderer!r}")


@torch.no_grad()
def _render_step(scene: Scene, camera: Camera, dt: float, config: RenderConfig):
    """One device step: physics + render (+ AA downsample) + mode head.
    Returns (scene, (kind, color, char)) with the cells on the scene's device."""
    scene = update_scene(scene, dt, config.bob_min_y, config.bob_max_y)
    fb = _pick_renderer(config)(scene, camera, supersampled_config(config))
    fb = downsample_framebuffer(fb, config.supersample)
    return scene, framebuffer_to_cells(fb, config)


def _start_download(cells):
    """Start the D2H copy of a frame's cells. Returns (host tensors, event);
    the event is None when the cells already live on the host."""
    if cells[0].device.type == "cpu":
        return cells, None
    host = tuple(torch.empty(c.shape, dtype=c.dtype, pin_memory=True).copy_(c, non_blocking=True)
                 for c in cells)
    event = torch.cuda.Event()
    event.record()
    return host, event


class Engine:
    def __init__(self, render_config: RenderConfig | None = None,
                 engine_config: EngineConfig | None = None, scene: Scene | None = None,
                 camera: Camera | None = None, presenter=None, input_handler=None,
                 interactive: bool = True, device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.rcfg = render_config or RenderConfig()
        _pick_renderer(self.rcfg)
        self.ecfg = engine_config or EngineConfig()
        self.scene = (scene.to(self.device) if scene is not None
                      else default_scene(self.rcfg, seed=self.ecfg.seed, device=self.device))
        self.camera = camera.to("cpu") if camera is not None else default_camera()
        self.presenter = presenter or ConsolePresenter(
            self.rcfg.width, self.rcfg.height, show_fps=self.ecfg.show_fps,
            max_print_fps=self.ecfg.max_print_fps, title="rtwc-tpu-torch")
        self.input = input_handler if input_handler is not None else (
            InputHandler(mouse=self.ecfg.mouse) if interactive else None)
        self.timer = Timer()
        self.telemetry = Telemetry(
            rays_per_frame=self.rcfg.width * self.rcfg.height * self.rcfg.supersample ** 2,
            update_interval_s=self.ecfg.fps_update_interval_s)
        self._rng = np.random.default_rng(self.ecfg.seed)
        self._should_quit = False
        self._pending = None  # (host cells, event) of the in-flight frame

    # -- lifecycle (Engine3D::Start / CleanUp) --------------------------------

    def start(self) -> None:
        self.presenter.start()
        if self.input is not None:
            self.input.start()
        self.timer.update()

    def cleanup(self) -> None:
        if self.input is not None:
            self.input.cleanup()
        self.presenter.cleanup()

    # -- per frame (Engine3D::Run) --------------------------------------------

    def run_frame(self) -> bool:
        """One iteration of the main loop; False when the loop should exit."""
        if not self.presenter.check_if_running() or self._should_quit:
            return False
        self.timer.update()
        dt = self.timer.delta_time

        if self.input is not None:
            state = self.input.poll()
            if state.quit:
                self._should_quit = True
            if state.mode is not None and state.mode != self.rcfg.mode:
                self.rcfg = self.rcfg.replace(mode=state.mode)
            dp, dy = state.rot_delta
            if dp or dy:
                self.camera = add_rot(self.camera, dp, dy, 0.0, self.rcfg.mouse_sensitivity)
            self.camera = move(self.camera, state.keys, dt, self.rcfg.move_speed)

        # Queue this frame's device work and its download, then encode and
        # publish the previous frame while the device runs.
        self.scene, cells = _render_step(self.scene, self.camera, float(np.float32(dt)),
                                         self.rcfg)
        prev, self._pending = self._pending, _start_download(cells)
        if prev is not None:
            self._publish(prev)

        if self.telemetry.tick():
            if self.ecfg.spawn:
                self._spawn()
            self.presenter.update_rendering_fps(self.telemetry.fps)
        return True

    def _spawn(self) -> None:
        """1 Hz random sphere; when the pool is full its capacity doubles
        first, up to ecfg.max_grow_spheres (engine.py:151-165)."""
        cap = self.scene.spheres.capacity
        if self.scene.n_spheres >= cap:
            if not self.ecfg.auto_grow or cap >= self.ecfg.max_grow_spheres:
                return
            self.scene = grow_scene(self.scene,
                                    max_spheres=min(cap * 2, self.ecfg.max_grow_spheres))
            log.info("scene grown to %d sphere slots", self.scene.spheres.capacity)
        self.scene = spawn_random_sphere(self.scene, self._rng)

    def _publish(self, frame) -> None:
        host, event = frame
        if event is not None:
            event.synchronize()
        kind, color, char = (c.numpy() for c in host)
        self.presenter.set_data_in_back_buffer(encode_frame(kind, color, char))

    def flush(self) -> None:
        """Drain the in-flight frame (shutdown and tests)."""
        if self._pending is not None:
            self._publish(self._pending)
            self._pending = None

    def run(self, max_frames: int | None = None) -> None:
        """The main loop (Entrypoint.cpp:4-13)."""
        self.start()
        try:
            n = 0
            while self.run_frame():
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
            self.flush()
        finally:
            self.cleanup()
