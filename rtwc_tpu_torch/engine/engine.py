"""Engine: the interactive frame loop on one torch device.

Counterpart: rtwc_tpu/engine/engine.py:41-189 (Engine3D.cpp:30-79). Per
frame it polls input, moves the camera on the host, runs `_render_step`
(physics + render + AA downsample + mode head) on the device, and hands
the previous frame's encoded bytes to the presenter; once per second it
publishes FPS and spawns a random sphere.

Where a frame's cells lie on a CUDA device, the frame ends in the encode
of its ANSI stream on the card (heads/device_encode.py): a copy kernel,
which reads the stream's length on the card, writes its bytes and the
length into the next of two pinned host buffers, and a CUDA event is
recorded after it. Cells on the host (a CPU device) are encoded by the
host encoder, `encode_frame` (the native C++ loop), after the frame.
Keeping frame k+1 in flight while frame k is published: JAX gets this
from async dispatch; here `_publish` waits on frame k's event only, so
frame k+1's kernels, queued before, keep the card busy meanwhile. The
scene stays on the device between frames; the camera pose stays on the
host and reaches the device once per frame as the packed [1, 16] vector.

JAX runs the frame's physics, pack, lists, K7, downsample and cells as one
jitted, donated step (rtwc_tpu/engine/engine.py:54-62). On a CUDA device
the kernel renderer's step goes from K7's planes to the cells in one
kernel (heads/device_heads.py: the box filter and the mode's head); on
the CPU it keeps `downsample_framebuffer` and `framebuffer_to_cells`.
The kernel renderer's step (`_device_step`, the encode included) is
captured once as a CUDA graph over static scene buffers and replayed
every frame (`DisplayGraph`): the camera vector and dt are copied into
device buffers before each replay, a spawn writes into the static buffers
in place, and a capacity doubling or a mode change re-captures.
`Engine(graph=False)` queues the same launches eagerly; the two give the
same cells and bytes bit for bit.

Under a torch profiler a frame is the span `frame`, with `frame.input`,
`frame.enqueue` (the step and the download's start), `frame.wait` (the
event), `encode` (on the card path the length's read and the bytes'
copy; for host cells the host encoder), `frame.present` and, once a
second, `frame.spawn` inside it (utils/telemetry.py); each publish and
each scene read of a spawn adds one to the counter `host_reads`, each
published frame that the card encoded one to `encode.device`, and each
published frame whose cells the heads kernel made one to `heads.device`.
"""
from __future__ import annotations

import functools
import logging
from typing import NamedTuple

import numpy as np
import torch

from rtwc_tpu_torch.camera import Camera, add_rot, default_camera, move
from rtwc_tpu_torch.config import EngineConfig, RenderConfig
from rtwc_tpu_torch.heads import encode_frame, framebuffer_to_cells
from rtwc_tpu_torch.heads.device_encode import copy_to_host, encode_cells
from rtwc_tpu_torch.heads.device_heads import cells_from_planes
from rtwc_tpu_torch.io import ConsolePresenter, InputHandler
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render.hard_kernel import (
    render_frame_kernel,
    render_frame_packed,
    render_planes_packed,
)
from rtwc_tpu_torch.render.step_graph import CapturedCall, StaticScene, use_graph
from rtwc_tpu_torch.render.reference import (
    downsample_framebuffer,
    render_frame,
    supersampled_config,
)
from rtwc_tpu_torch.scene import Scene, default_scene, grow_scene, spawn_random_sphere, update_scene
from rtwc_tpu_torch.utils import Telemetry, Timer
from rtwc_tpu_torch.utils.telemetry import count, span

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


class Frame(NamedTuple):
    """A frame on its device: the cells (kind, color, char) and, where they
    lie on a CUDA device, their ANSI stream encoded there, (bytes [bound]
    uint8, length [1] int64); None for cells on the host. heads_device:
    the heads kernel made the cells."""

    cells: tuple
    stream: tuple | None
    heads_device: bool = False


def _card_stream(cells):
    """The cells' stream encoded on the card where they lie on a CUDA
    device; None for host cells, which the host encodes after the frame."""
    return encode_cells(*cells) if cells[0].device.type == "cuda" else None


@torch.no_grad()
def _render_step(scene: Scene, camera: Camera, dt: float, config: RenderConfig):
    """One device step: physics + render (+ AA downsample) + mode head.
    Returns (scene, (kind, color, char)) with the cells on the scene's device."""
    scene = update_scene(scene, dt, config.bob_min_y, config.bob_max_y)
    fb = _pick_renderer(config)(scene, camera, supersampled_config(config))
    fb = downsample_framebuffer(fb, config.supersample)
    return scene, framebuffer_to_cells(fb, config)


@torch.no_grad()
def _device_step(scene: Scene, cam: torch.Tensor, dt: torch.Tensor, config: RenderConfig):
    """_render_step on the kernel renderer from device values alone, ending
    in the encode on a CUDA device: the packed camera cam [1, 16] and the
    time step dt [1] f32 on the scene's device. Returns (scene, Frame).
    Nothing reads the host, so it can be captured as a CUDA graph. On a
    CUDA device the heads kernel turns K7's planes into the cells; on the
    CPU the downsample and the mode's head run as torch ops."""
    scene = update_scene(scene, dt, config.bob_min_y, config.bob_max_y)
    if scene.device.type == "cuda":
        planes = render_planes_packed(scene, cam, supersampled_config(config))
        cells = cells_from_planes(planes, config)
        return scene, Frame(cells, _card_stream(cells), heads_device=True)
    fb = render_frame_packed(scene, cam, supersampled_config(config))
    fb = downsample_framebuffer(fb, config.supersample)
    cells = framebuffer_to_cells(fb, config)
    return scene, Frame(cells, _card_stream(cells))


class DisplayGraph:
    """`_device_step` as one CUDA graph (a CapturedCall) over static
    buffers: the scene's tensors and the packed camera (a StaticScene; the
    graph writes the physics tick back into the scene's) and dt; its
    outputs are the cells and the encoded stream and its length, sized for
    the mode. The first frame of a config is an eager step on a side stream
    (it fills the heads' cached tables), then the step is captured; every
    later frame of that config replays it, and a scene that replaces the
    buffers makes the next frame capture again. `replay_launches` holds the
    kernel launches a replay makes, counted at capture; `captures` counts
    the captures."""

    def __init__(self, scene: Scene):
        self.inputs = StaticScene(scene.device, scene)
        self.dt = torch.zeros(1, dtype=torch.float32, device=scene.device)
        self.call = CapturedCall(None, scene.device, graph=True)

    @property
    def captures(self) -> int:
        return self.call.captures

    @property
    def replay_launches(self) -> dict | None:
        return self.call.replay_launches

    def load_scene(self, scene: Scene) -> None:
        """Make `scene` the step's scene: copied into the static buffers in
        place when its shapes match them, else it replaces them and the next
        frame re-captures."""
        if self.inputs.load(scene):
            self.call.reset()

    def _step(self, config: RenderConfig) -> Frame:
        scene, frame = _device_step(self.inputs.scene, self.inputs.cam, self.dt, config)
        self.inputs.write(scene)
        return frame

    @torch.no_grad()
    def frame(self, cam_host: torch.Tensor, dt: float, config: RenderConfig) -> Frame:
        """One frame: cam_host [1, 16] (the packed camera on the host) and dt
        into the device buffers, then the step. Returns the Frame, buffers
        the next frame overwrites."""
        self.inputs.upload_camera(cam_host)
        self.dt.fill_(dt)
        if self.call.replays(config):
            return self.call.replay()
        step = functools.partial(self._step, config)
        return self.call.capture(config, step, step)


class Download(NamedTuple):
    """A frame on its way to the host: its host cells (cells on the host),
    or its stream's pinned host copy (bytes, length); the event after the
    copies (None for host cells); the Frame's heads_device."""

    cells: tuple | None
    stream: tuple | None
    event: object
    heads_device: bool = False


class _PinnedPair:
    """Two pinned host buffers for the stream and its length, used in turn:
    one for the frame in flight, one for the frame being published. A
    buffer grows (it is made anew) when a stream's bound outgrows it."""

    def __init__(self):
        self._bufs = [None, None]
        self._turn = 0

    def next(self, nbytes: int) -> tuple:
        self._turn ^= 1
        buf = self._bufs[self._turn]
        if buf is None or buf[0].numel() < nbytes:
            buf = self._bufs[self._turn] = (
                torch.empty(nbytes, dtype=torch.uint8, pin_memory=True),
                torch.empty(1, dtype=torch.int64, pin_memory=True))
        return buf


class Engine:
    """graph: None replays the kernel renderer's frame as a CUDA graph on a
    CUDA device (DisplayGraph) and runs it eagerly elsewhere; False keeps
    every frame eager; True needs a CUDA device and the kernel renderer."""

    def __init__(self, render_config: RenderConfig | None = None,
                 engine_config: EngineConfig | None = None, scene: Scene | None = None,
                 camera: Camera | None = None, presenter=None, input_handler=None,
                 interactive: bool = True, device: torch.device | str = "cuda",
                 graph: bool | None = None):
        self.device = resolve_device(device)
        self.rcfg = render_config or RenderConfig()
        _pick_renderer(self.rcfg)
        graph = use_graph(graph, self.rcfg.renderer in ("auto", "kernel")
                          and self.device.type == "cuda", "a CUDA device and the kernel renderer")
        self.ecfg = engine_config or EngineConfig()
        self.display = None
        self.scene = (scene.to(self.device) if scene is not None
                      else default_scene(self.rcfg, seed=self.ecfg.seed, device=self.device))
        self.camera = camera.to("cpu") if camera is not None else default_camera()
        self.presenter = presenter or ConsolePresenter(
            self.rcfg.width, self.rcfg.height, show_fps=self.ecfg.show_fps,
            max_print_fps=self.ecfg.max_print_fps, title="rtwc-tpu-torch")
        self.input = input_handler if input_handler is not None else (
            InputHandler(mouse=self.ecfg.mouse) if interactive else None)
        self.timer = Timer()
        self.telemetry = Telemetry(update_interval_s=self.ecfg.fps_update_interval_s)
        self._rng = np.random.default_rng(self.ecfg.seed)
        self._should_quit = False
        self._pending = None  # the in-flight frame's Download
        self._pinned = _PinnedPair()
        if graph:
            self.display = DisplayGraph(self._scene)

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
        with span("frame"):
            if not self.presenter.check_if_running() or self._should_quit:
                return False
            self.timer.update()
            dt = self.timer.delta_time

            if self.input is not None:
                with span("frame.input"):
                    self._apply_input(dt)

            # Queue this frame's device work and its download, then encode and
            # publish the previous frame while the device runs.
            with span("frame.enqueue"):
                pending = self._start_download(self.device_frame(dt))
            prev, self._pending = self._pending, pending
            if prev is not None:
                self._publish(prev)

            if self.telemetry.tick():
                if self.ecfg.spawn:
                    self._spawn()
                self.presenter.update_rendering_fps(self.telemetry.fps)
            return True

    def _apply_input(self, dt: float) -> None:
        """Poll the input handler; apply quit, a mode switch and the camera's
        rotation and movement."""
        state = self.input.poll()
        if state.quit:
            self._should_quit = True
        if state.mode is not None and state.mode != self.rcfg.mode:
            self.rcfg = self.rcfg.replace(mode=state.mode)
        dp, dy = state.rot_delta
        if dp or dy:
            self.camera = add_rot(self.camera, dp, dy, 0.0, self.rcfg.mouse_sensitivity)
        self.camera = move(self.camera, state.keys, dt, self.rcfg.move_speed)

    def device_frame(self, dt: float) -> Frame:
        """Queue one frame's device step at time step dt; returns its Frame
        on the device (on the graph path, buffers the next frame overwrites)."""
        dt = float(np.float32(dt))
        if self.display is not None:
            return self.display.frame(P.pack_camera(self.camera), dt, self.rcfg)
        if self.rcfg.renderer == "reference":
            self.scene, cells = _render_step(self.scene, self.camera, dt, self.rcfg)
            return Frame(cells, _card_stream(cells))
        cam = P.pack_camera(self.camera, self.device)
        dt_t = torch.full((1,), dt, dtype=torch.float32, device=self.device)
        self.scene, frame = _device_step(self.scene, cam, dt_t, self.rcfg)
        return frame

    @property
    def scene(self) -> Scene:
        """The engine's scene; on the display graph, its static buffers."""
        return self._scene if self.display is None else self.display.inputs.scene

    @scene.setter
    def scene(self, scene: Scene) -> None:
        if self.display is None:
            self._scene = scene
        else:
            self.display.load_scene(scene)

    def _spawn(self) -> None:
        """1 Hz random sphere; when the pool is full its capacity doubles
        first, up to ecfg.max_grow_spheres (engine.py:151-165)."""
        with span("frame.spawn"):
            cap = self.scene.spheres.capacity
            if self.scene.n_spheres >= cap:
                if not self.ecfg.auto_grow or cap >= self.ecfg.max_grow_spheres:
                    return
                self.scene = grow_scene(self.scene,
                                        max_spheres=min(cap * 2, self.ecfg.max_grow_spheres))
                log.info("scene grown to %d sphere slots", self.scene.spheres.capacity)
            self.scene = spawn_random_sphere(self.scene, self._rng)

    def _start_download(self, frame: Frame) -> Download:
        """Start a frame's copy to the host: its stream's bytes and length
        into the next pinned pair (heads/device_encode.py `copy_to_host`:
        the copy reads the length on the card), then an event; host cells
        need no copy."""
        if frame.stream is None:
            return Download(frame.cells, None, None, frame.heads_device)
        host = self._pinned.next(frame.stream[0].numel())
        copy_to_host(frame.stream, *host)
        event = torch.cuda.Event()
        event.record()
        return Download(None, host, event, frame.heads_device)

    def _frame_bytes(self, down: Download) -> bytes:
        """A downloaded frame's bytes: the stream's first `length` bytes, or
        the host cells through the host encoder."""
        if down.heads_device:
            count("heads.device")
        if down.stream is None:
            return encode_frame(*(c.numpy() for c in down.cells))
        count("encode.device")
        with span("encode"):
            host_buf, host_n = down.stream
            return host_buf.numpy()[:int(host_n.numpy()[0])].tobytes()

    def _publish(self, down: Download) -> None:
        """Wait for a frame's download (one host read), take its bytes and
        hand them to the presenter."""
        with span("frame.wait"):
            if down.event is not None:
                down.event.synchronize()
        count("host_reads")
        data = self._frame_bytes(down)
        with span("frame.present"):
            self.presenter.set_data_in_back_buffer(data)

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
