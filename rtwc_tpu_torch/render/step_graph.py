"""One optimiser step replayed as a CUDA graph: the port's counterpart of
`jax.jit` over the JAX package's train step (`_soft_mse_pallas_jit`,
rtwc_tpu/render/pallas_soft.py:2700-2711) and of the bench's K steps in
one dispatch (bench.py:80-127, `lax.scan`).

A step is pack, the list kernel and the entry tables, the soft kernels
(K3 / K6, or K1 + K2 / K4 + K5 with the torch loss), the reduction and
the optimiser's update. Nothing in it reads a value back to the host (the
entry counts stay on the device, render/list_kernel.py), so it can be
captured once and replayed: one graph launch a step in place of some
hundred launches from Python.

`CapturedStep(loss_fn, opt)` runs `loss_fn()`, the backward and
`opt.step()`. loss_fn must build the loss from tensors that stay put
between calls: the optimiser's parameters (updated in place) and the
caller's buffers (a target), which the caller updates in place between
calls. On a CUDA device the first call of a key is an eager step on a side
stream (it makes the optimiser's state and every cached table) and then
captures the step; later calls with that key replay the graph. The key is
the caller's `key` (a config, a loss weight, the shape of a buffer)
together with the shape, dtype and storage of every parameter, so a new
config or parameter re-captures, as `jit` retraces.

Where the optimiser was built with capturable=True (bench.py's
`torch.optim.Adam(capturable=True, fused=True)`), its update is part of
the graph. Otherwise the graph ends with the backward, which writes the
parameters' .grad in place, and `opt.step()` runs eagerly after each
replay: torch's default Adam reads its step count and learning rate on the
host (no device sync) and rounds as an eager fit does, so the fits of
examples/ end where their eager loops end, bit for bit.

`graph=False` keeps every step eager: the same launches, queued from
Python, so the two are `torch.equal` step for step. A capture that fails
raises; nothing falls back to eager on its own.

`CapturedCall(fn, device)` is the capture and replay itself, for any
function of static buffers that returns tensors, and the one holder of a
graph's state; `CapturedStep` is an optimiser's step on it, and the
display frame (engine/engine.py `DisplayGraph`), the sharded train step's
phases and the sharded frame (dist/mesh.py) hold one each. `use_graph` is
the rule of every `graph=` option. `StaticScene` holds a replayed frame's
scene and packed camera in static buffers (the display frame's and the
sharded frame's).

The launch counters of the kernel modules count at capture only: a replay
launches what `replay_launches` records and counts nothing. They are
sources of `utils/telemetry.counters()` (as `launches.<kernel>`), beside
`graph.captures`, which every capture adds to. Under a torch profiler a
replay is the span `step.replay`, an eager `opt.step()` after it
`step.opt`, and a warm step with its capture `graph.capture`; no span
opens inside a capture.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Hashable

import torch

from rtwc_tpu_torch.heads import device_encode as DE
from rtwc_tpu_torch.heads import device_heads as DH
from rtwc_tpu_torch.render import hard_kernel as HK
from rtwc_tpu_torch.render import list_kernel as LK
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render import soft_core as SC
from rtwc_tpu_torch.scene import Scene
from rtwc_tpu_torch.utils.telemetry import add_source, count, span


def launch_counts() -> dict:
    """Every kernel launch counter of the port, by kernel name."""
    return {**SC.LAUNCHES, "hard_render": HK.LAUNCHES, **LK.LAUNCHES, **DE.LAUNCHES,
            "cell_heads": DH.LAUNCHES}


add_source(lambda: {f"launches.{k}": v for k, v in launch_counts().items()})


def reset_launch_counts() -> None:
    for key in SC.LAUNCHES:
        SC.LAUNCHES[key] = 0
    for key in LK.LAUNCHES:
        LK.LAUNCHES[key] = 0
    HK.LAUNCHES = 0
    DH.LAUNCHES = 0
    for key in DE.LAUNCHES:
        DE.LAUNCHES[key] = 0


def launch_delta(before: dict) -> dict:
    """The launches counted since `before` (a launch_counts() snapshot),
    the kernels launched at least once."""
    return {k: v - before.get(k, 0) for k, v in launch_counts().items() if v != before.get(k, 0)}


def warm_and_capture(warm: Callable[[], object], capture: Callable[[], object],
                     device: torch.device) -> tuple:
    """warm() eagerly on a side stream (it makes every cached table and
    lazily built state, away from the capture), then capture() as a CUDA
    graph. Returns (warm's result, the graph, capture's result, the kernel
    launches counted during the capture: what a replay launches).

    Python's cyclic garbage collector is off during the capture: a step
    or frame that is no longer referenced sits in a reference cycle with
    its graph, and a collection during the capture would destroy that
    graph there, which invalidates the capture (torch.cuda.graph no longer
    collects before it begins)."""
    with span("graph.capture"):
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = warm()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                static = capture()
        finally:
            if collecting:
                gc.enable()
        count("graph.captures")
        return out, graph, static, launch_delta(before)


def card_adam(params) -> dict:
    """torch.optim.Adam's options for a step captured whole on the
    parameters' device: on a CUDA device capturable and fused (one kernel a
    step for every parameter, reading the step count from device memory);
    elsewhere torch's default. Its roundings differ from the default's, and
    the fits of examples/ follow the rounding (PERF.md), so they keep
    the default and step it after each replay."""
    return {"capturable": True, "fused": True} if params[0].is_cuda else {}


def use_graph(graph: bool | None, possible: bool, needs: str) -> bool:
    """The rule of every `graph=` option: None replays a CUDA graph where
    one is `possible` (a CUDA device, and whatever else the caller's path
    needs) and runs eagerly elsewhere; False keeps every call eager, the
    same launches queued from Python; True asks for the graph and raises
    where it is not possible (`needs` says what a graph needs there)."""
    if graph and not possible:
        raise ValueError(f"a CUDA graph needs {needs}")
    return possible if graph is None else bool(graph)


class CapturedCall:
    """fn() as one CUDA graph: fn reads and writes only tensors that stay put
    between calls (static buffers the caller updates in place), and returns
    tensors. On a CUDA device the first call of a key runs fn eagerly on a
    side stream (it makes every cached table and lazily built state) and
    then captures it; later calls with that key replay the graph and return
    the captured outputs, which the next replay overwrites. The key holds
    what a replay needs unchanged (the shapes and storage of the buffers fn
    reads): a new key captures again, and so does a call after `reset()`
    (an owner whose buffers were replaced).

    graph: the `use_graph` rule on `device`. This is the one holder of a
    graph's state: the graph, its key, its captured outputs, `captures` and
    `replay_launches` (the kernel launches a replay makes, counted at
    capture). An owner that needs to tell a replay from a capture, or warms
    with another function than the one it captures, calls `replays`,
    `replay` and `capture` itself and passes fn=None (CapturedStep, a
    subclass, and engine.DisplayGraph)."""

    def __init__(self, fn: Callable[[], object] | None, device: torch.device | str, *,
                 graph: bool | None = None):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = use_graph(graph, self.device.type == "cuda", "a CUDA device")
        self.replay_launches: dict | None = None
        self.captures = 0
        self.reset()

    def reset(self) -> None:
        """Drop the graph: the next call captures again."""
        self._graph: torch.cuda.CUDAGraph | None = None
        self._key: Hashable = None
        self._out = None

    def replays(self, key: Hashable) -> bool:
        """Whether a call with `key` replays the graph (else it captures)."""
        return self._graph is not None and key == self._key

    def replay(self):
        """Replay the graph; returns its captured outputs."""
        self._graph.replay()
        return self._out

    def capture(self, key: Hashable, warm: Callable[[], object],
                fn: Callable[[], object]):
        """warm() eagerly, then fn() captured under `key`; returns warm's
        result."""
        self.reset()
        self._key = key
        out, self._graph, self._out, self.replay_launches = warm_and_capture(
            warm, fn, self.device)
        self.captures += 1
        return out

    def __call__(self, key: Hashable = None):
        if not self.graph:
            return self.fn()
        if self.replays(key):
            return self.replay()
        return self.capture(key, self.fn, self.fn)


class CapturedStep(CapturedCall):
    """An optimiser step (loss_fn, backward, opt.step) as one CUDA graph,
    a CapturedCall on the parameters' device.

    graph: the `use_graph` rule. Calling it takes one step and returns its
    loss (detached; on the graph path a buffer the next replay overwrites).
    `in_graph` says whether opt.step() is captured (a capturable
    optimiser) or runs after each replay."""

    def __init__(self, loss_fn: Callable[[], torch.Tensor], opt: torch.optim.Optimizer, *,
                 graph: bool | None = None):
        self.params = [p for group in opt.param_groups for p in group["params"]]
        if not self.params:
            raise ValueError("the optimiser holds no parameters")
        super().__init__(None, self.params[0].device, graph=graph)
        self.in_graph = all(group.get("capturable", False) for group in opt.param_groups)
        self.loss_fn, self.opt = loss_fn, opt

    def _eager(self) -> torch.Tensor:
        loss = self.loss_fn()
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def capture_key(self, key: Hashable = None) -> tuple:
        """The caller's key with each parameter's shape, dtype and storage:
        a replay needs all of them unchanged."""
        return key, tuple((p.shape, p.dtype, p.data_ptr()) for p in self.params)

    def __call__(self, key: Hashable = None) -> torch.Tensor:
        if not self.graph:
            return self._eager()
        key = self.capture_key(key)
        if not self.replays(key):
            return self.capture(key, self._eager, self._captured)
        with span("step.replay"):
            loss = self.replay()
        if not self.in_graph:
            with span("step.opt"):
                self.opt.step()
        return loss

    def _captured(self) -> torch.Tensor:
        # .grad set to None first: the capture's backward allocates each
        # .grad in the graph's pool, and a replay writes them there
        self.opt.zero_grad(set_to_none=True)
        static = self.loss_fn()
        static.backward()
        if self.in_graph:
            self.opt.step()
        return static.detach()


def scene_leaves(scene: Scene) -> list:
    """The scene's tensors, spheres' then planes', in field order."""
    return [getattr(group, f.name) for group in (scene.spheres, scene.planes)
            for f in dataclasses.fields(group)]


def same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether b is a itself or a view of a's whole storage (a step's
    returned leaves, passed back in)."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype
                      and a.device == b.device)


def _own(scene: Scene, device: torch.device) -> Scene:
    """A copy of scene on device in tensors of its own."""
    def node(group):
        return group.replace(**{f.name: getattr(group, f.name).detach().to(device, copy=True)
                                for f in dataclasses.fields(group)})
    return Scene(spheres=node(scene.spheres), planes=node(scene.planes))


class StaticScene:
    """A replayed frame's inputs in static buffers on `device`: the scene's
    leaves and the packed camera [1, 16]. own: a scene that replaces the
    buffers is copied into tensors of the holder's own (the caller keeps
    the original); else the holder takes the scene itself."""

    def __init__(self, device: torch.device | str, scene: Scene | None = None, *,
                 own: bool = False):
        self.scene = scene
        self.own = own
        self.cam = torch.zeros((1, P.CAM_LEN), dtype=torch.float32, device=device)

    def write(self, scene: Scene) -> None:
        """scene's leaves copied into the buffers in place (a leaf that is
        already its buffer is not copied)."""
        for a, b in zip(scene_leaves(self.scene), scene_leaves(scene)):
            if not same_tensor(a, b):
                a.copy_(b)

    def load(self, scene: Scene) -> bool:
        """Make `scene` the frame's scene: written into the buffers in place
        when its leaves' shapes and dtypes match theirs, else it replaces
        them. Returns True where it replaced them: a graph over the old
        buffers must be captured again."""
        if self.scene is not None and all(
                a.shape == b.shape and a.dtype == b.dtype
                for a, b in zip(scene_leaves(self.scene), scene_leaves(scene))):
            self.write(scene)
            return False
        self.scene = _own(scene, self.cam.device) if self.own else scene
        return True

    def upload_camera(self, cam: torch.Tensor) -> None:
        """The packed camera cam [1, 16] into its device buffer: from the
        host, one non_blocking copy from pinned memory."""
        if self.cam.is_cuda and cam.device.type == "cpu":
            cam = cam.pin_memory()
        self.cam.copy_(cam, non_blocking=True)
