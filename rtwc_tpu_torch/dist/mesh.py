"""Row-band sharding of the renderer over torch.distributed.

Counterpart: rtwc_tpu/dist/mesh.py. The image rows are the scaling axis:
a 1-D mesh of `size` bands, each band a run of height / size consecutive
rows rendered against the replicated scene (a few hundred objects of
32 B), its first row written into cam[0, C_ROW0]. The train step's band
loss is a mean over the band's rows, and one all-reduce a step averages
the bands' gradients and losses (mesh.py:234-239): every leaf's gradient
and the loss go into one contiguous buffer, one `all_reduce(SUM)`, a
division by the band count (gloo has no `ReduceOp.AVG`), and the buffer
is cut back into leaves. Every process then takes the same optimiser
step on the same numbers, so the replicas stay bit-equal.

`Mesh` is a small record of the band count and the process group, not a
`torch.distributed.device_mesh.DeviceMesh`: `init_device_mesh` wants one
device a rank and an initialised group, while several ranks may share one
card through gloo (NCCL takes one card a rank), and the tests and the CPU
run several bands in one process. A process renders its size / world_size
consecutive bands in turn, so one process alone holds the whole mesh, as
JAX's virtual CPU devices do.

Where the collective runs (`_collective_in_graph`): NCCL on a CUDA device
queues its all-reduce and all-gather on the stream, so the train step and
the frame are each one CUDA graph with the collective inside, as JAX's
`pmean` and gather sit inside `jit(shard_map)`. gloo's collectives go
through the host and cannot be captured: a gloo step replays a graph up to
the flat buffer, runs the all-reduce, then replays a graph of the update,
and a gloo frame gathers after its graph.

Backends (JAX's names): "pallas" runs the hand-written CUDA kernels that
replace the Pallas ones (K7 for the display, K1-K6 and the reduction for
the train step; on CPU tensors their plain versions), "jnp" the plain
torch renderers (render/reference.py, render/softmin.py). "auto" picks
"pallas" on a CUDA scene and "jnp" elsewhere.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from rtwc_tpu_torch.camera import Camera, camera_rays, projection_elements
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render.hard_kernel import hard_band_packed, planes_to_framebuffer
from rtwc_tpu_torch.render.reference import Framebuffer, shade, trace_hard
from rtwc_tpu_torch.render.soft_core import SO_B, SO_R, _packed
from rtwc_tpu_torch.render.soft_kernel import soft_band_mse_loss, soft_band_packed
from rtwc_tpu_torch.render.softmin import trace_soft
from rtwc_tpu_torch.render.step_graph import (CapturedCall, StaticScene, card_adam, same_tensor,
                                              use_graph)
from rtwc_tpu_torch.scene import Planes, Scene, Spheres, update_scene
from rtwc_tpu_torch.utils.telemetry import count, span

TILE_AXIS = "tiles"
# Per-sub-band cap on the plain soft renderer's [rows, W, n_obj, 3] shading
# intermediates inside the sharded train step (see make_sharded_train_step).
_JNP_CHUNK_BYTES = 128 * 2**20
_FB_FIELDS = [f.name for f in dataclasses.fields(Framebuffer)]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of `size` row bands over the processes of `group` (None:
    this process alone). Process r renders bands [r k, (r + 1) k), k =
    size / world size."""

    size: int
    axis_name: str = TILE_AXIS
    group: dist.ProcessGroup | None = None

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    def bands(self) -> range:
        """The bands this process renders, in order."""
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_devices: int | None = None, axis_name: str = TILE_AXIS) -> Mesh:
    """1-D mesh of `n_devices` row bands (default: one a process) over
    torch.distributed's default group when it is initialised, else over
    this process alone."""
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = 1 if group is None else dist.get_world_size(group)
    n = world if n_devices is None else int(n_devices)
    if n < 1 or n % world:
        raise ValueError(f"a mesh of {n} bands over {world} processes: the band count must "
                         f"be a positive multiple of the process count")
    return Mesh(n, axis_name, group)


def _check_divisible(height: int, n: int) -> int:
    if height % n:
        raise ValueError(
            f"height {height} must divide by mesh size {n} for tile sharding "
            f"(pad the image or change the mesh)"
        )
    return height // n


def _collective_in_graph(group: dist.ProcessGroup | None, device: torch.device) -> bool:
    """Whether `group`'s collective goes inside the CUDA graph of a step or
    frame on `device`: NCCL's on a CUDA device, which queues device work on
    the stream. gloo's goes through the host and cannot be captured."""
    return (group is not None and device.type == "cuda"
            and dist.get_backend(group) == "nccl")


def _backend(backend: str, device: torch.device) -> str:
    if backend == "auto":
        return "pallas" if device.type == "cuda" else "jnp"
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown sharded-render backend {backend!r}")
    return backend


def _k7_bands(scene: Scene, cam: torch.Tensor, config: RenderConfig, bands: range,
              rows: int) -> Framebuffer:
    """Bands of `rows` rows on the kernel path, stitched: the scene packed
    once, the list kernel and K7 (hard_band_packed) a band; cam is the
    packed camera [1, 16] on the scene's device."""
    sph, pl, counts = P.pack_scene(scene)
    out = torch.cat([hard_band_packed(sph, pl, counts, cam, b * rows, config=config,
                                      band_h=rows)[:, :rows, :config.width]
                     for b in bands], 1)
    return planes_to_framebuffer(out, config, out.shape[1])


def _render_bands(scene: Scene, camera: Camera, config: RenderConfig, mesh: Mesh,
                  rows: int, backend: str) -> Framebuffer:
    """This process's bands in turn, stitched: "pallas" is _k7_bands,
    "jnp" the plain reference renderer a band."""
    if backend == "pallas":
        return _k7_bands(scene, P.pack_camera(camera, scene.device), config, mesh.bands(),
                         rows)
    e1, e2 = projection_elements(config)
    parts = []
    for b in mesh.bands():
        origin, dirs = camera_rays(camera, config.width, config.height, e1, e2,
                                   row_start=b * rows, n_rows=rows, device=scene.device)
        t, normal, color, shading = trace_hard(scene, origin, dirs)
        rgb = shade(scene, origin, dirs, t, normal, color, config)
        hit = t <= config.far
        parts.append(Framebuffer(rgb=rgb, normal=normal, depth=t, shading=shading, hit=hit,
                                 coverage=hit.float(), alpha=hit.float()))
    return Framebuffer(**{f: torch.cat([getattr(b, f) for b in parts], 0) for f in _FB_FIELDS})


class _FrameGraph:
    """render_frame_sharded's "pallas" frame as one CUDA graph over static
    buffers: the scene's leaves and the packed camera [1, 16] (a
    StaticScene of its own copies). Each call
    copies the caller's scene and camera into them (a spawn's new capacity
    replaces them, and the next call captures again), then replays
    _k7_bands and, where `group`'s all-gather can be captured
    (`gathers`), the gather of every process's rows: the stacked rows, the
    gathered frame and the fields cut from it are then buffers of the
    graph. Made and cached per (config, band count, this process's bands,
    group), as JAX caches its jitted shard_map per (config, mesh,
    backend)."""

    def __init__(self, config: RenderConfig, size: int, bands: range, device: torch.device,
                 group: dist.ProcessGroup | None = None, graph: bool = True):
        self.config, self.bands = config, bands
        self.rows = _check_divisible(config.height, size)
        self.group = group
        self.gathers = _collective_in_graph(group, torch.device(device))
        self.inputs = StaticScene(device, own=True)
        self.call = CapturedCall(self._frame, device, graph=graph)

    def _frame(self) -> Framebuffer:
        fb = _k7_bands(self.inputs.scene, self.inputs.cam, self.config, self.bands, self.rows)
        return _gather_rows(fb, self.group) if self.gathers else fb

    @torch.no_grad()
    def __call__(self, scene: Scene, camera: Camera) -> Framebuffer:
        if self.inputs.load(scene):
            self.call.reset()
        self.inputs.upload_camera(P.pack_camera(camera))
        return self.call()


@functools.lru_cache(maxsize=32)
def _frame_graph(config: RenderConfig, size: int, bands: range, device: torch.device,
                 group: dist.ProcessGroup | None = None) -> _FrameGraph:
    return _FrameGraph(config, size, bands, device, group)


def _gather_rows(fb: Framebuffer, group: dist.ProcessGroup) -> Framebuffer:
    """Every process's rows, in band order, on every process: one
    all-gather of the fields stacked as float32 planes [C, rows, W], so
    that each field is copied plane by plane (stacked with the channels
    last, the copy runs element by element). Under gloo, whose all_gather
    takes CPU tensors only, through the host; otherwise into one tensor on
    the device, with nothing read back, so a CUDA graph can hold it."""
    parts = [getattr(fb, f) for f in _FB_FIELDS]
    local = torch.cat([p.float()[None] if p.dim() == 2 else p.float().permute(2, 0, 1)
                       for p in parts], 0)
    n, (c_all, rows, width) = dist.get_world_size(group), local.shape
    if dist.get_backend(group) == "gloo":
        chunks = [torch.empty_like(local, device="cpu") for _ in range(n)]
        dist.all_gather(chunks, local.cpu(), group=group)
        full = torch.cat(chunks, 1).to(parts[0].device)
    else:
        full = local.new_empty((n * c_all, rows, width))
        dist.all_gather_into_tensor(full, local, group=group)
        full = full.view(n, c_all, rows, width).transpose(0, 1).reshape(c_all, n * rows, width)
    out, c = {}, 0
    for name, p in zip(_FB_FIELDS, parts):
        w = 1 if p.dim() == 2 else p.shape[2]
        out[name] = (full[c] if p.dim() == 2 else full[c:c + w].permute(1, 2, 0)).to(p.dtype)
        c += w
    return Framebuffer(**out)


def render_frame_sharded(scene: Scene, camera: Camera, config: RenderConfig, mesh: Mesh,
                         backend: str = "auto", graph: bool | None = None) -> Framebuffer:
    """Tile-sharded forward render: each band of image rows is rendered
    against the replicated scene, this process's bands in turn, and with
    several processes every process receives the whole frame. backend:
    "pallas" packs the scene and camera once and runs the list kernel and
    K7 (hard_band_packed) a band, "jnp" the plain reference renderer,
    "auto" picks by the scene's device. Pixels equal the single render's
    (K7's bit for bit on the card).

    graph: None replays the "pallas" frame on a CUDA device as one CUDA
    graph, cached per config, mesh and group and captured again when the
    scene's capacity changes (JAX's jit(shard_map), cached per config, mesh
    and backend); its framebuffer is the graph's output, which the next
    frame of that config and mesh overwrites. False keeps the frame eager;
    the two are torch.equal. The "jnp" backend and CPU scenes run eagerly.
    With several processes the all-gather is part of the graph under NCCL
    (one dispatch a frame) and runs eagerly after the replay under gloo.
    Every process runs one all-gather a frame, at a capture (its eager
    warm-up) as at a replay, so processes whose graphs were captured at
    different frames still pair their gathers."""
    rows = _check_divisible(config.height, mesh.size)
    backend = _backend(backend, scene.device)
    if use_graph(graph, backend == "pallas" and scene.device.type == "cuda",
                 "the pallas backend and a CUDA scene"):
        fg = _frame_graph(config, mesh.size, mesh.bands(), scene.device, mesh.group)
        fb = fg(scene, camera)
        if fg.gathers:
            return fb
    else:
        fb = _render_bands(scene, camera, config, mesh, rows, backend)
    return fb if mesh.group is None else _gather_rows(fb, mesh.group)


def _leaves(params) -> dict:
    """{"spheres.center": tensor, ..., "camera.rot": tensor} of (scene, camera)."""
    scene, camera = params
    out = {}
    for prefix, node in (("spheres", scene.spheres), ("planes", scene.planes),
                         ("camera", camera)):
        for f in dataclasses.fields(node):
            out[f"{prefix}.{f.name}"] = getattr(node, f.name)
    return out


def _params(leaves: dict):
    """The inverse of _leaves."""
    def node(cls, prefix):
        return cls(**{f.name: leaves[f"{prefix}.{f.name}"] for f in dataclasses.fields(cls)})

    return (Scene(spheres=node(Spheres, "spheres"), planes=node(Planes, "planes")),
            node(Camera, "camera"))


@dataclasses.dataclass(eq=False)
class TrainState:
    """step.init's state: the static buffers a step reads and writes.

    leaves: the trained tensors (named as _leaves names them) on the
    scene's device; optimizer: the optimiser over them; flat: one buffer of
    every leaf's gradient, then the loss (each leaf's .grad is a view of
    it); dt: the physics tick, one f32 on the device; opt_in_graph: the
    optimiser is capturable and steps inside the update (else eagerly after
    it); target: the static target, made at the first step and made again
    when its shape changes; target_src: the caller's tensor last copied
    into it and that tensor's version counter (unchanged: nothing to copy).
    phases: the step's CapturedCalls (one without a process group or with
    NCCL on a CUDA device, the all-reduce inside; with gloo, the bands
    before the all-reduce and the update after it)."""

    leaves: dict
    optimizer: torch.optim.Optimizer
    flat: torch.Tensor
    dt: torch.Tensor
    opt_in_graph: bool = False
    target: torch.Tensor | None = None
    target_src: tuple | None = None
    phases: tuple = ()

    @property
    def replay_launches(self) -> dict | None:
        """The kernel launches of one replayed step, counted at capture
        (None before the first capture, or on the eager path)."""
        counts = [p.replay_launches for p in self.phases]
        if any(c is None for c in counts):
            return None
        out: dict = {}
        for c in counts:
            for k, v in c.items():
                out[k] = out.get(k, 0) + v
        return out


def _adam(leaves: dict) -> torch.optim.Optimizer:
    params = list(leaves.values())
    return torch.optim.Adam(params, lr=1e-2, **card_adam(params))


def make_sharded_train_step(
    config: RenderConfig,
    mesh: Mesh,
    tau: float,
    optimizer: Callable[[dict], torch.optim.Optimizer] | None = None,
    loss_scale: float = 1.0 / 255.0,
    backend: str = "jnp",
    animate: bool = False,
    graph: bool | None = None,
) -> Callable:
    """The multi-band inverse-rendering train step (BASELINE configs 4-5).

    Each band: the soft render of its rows, the MSE against its rows of the
    target, gradients to the replicated scene and camera; then one
    all-reduce averages the gradients and the loss over the bands, and the
    optimiser steps. Returns step(params, opt_state, target, dt=0.0) ->
    (params, opt_state, loss) with params = (scene, camera), target [H, W,
    3], and step.init(params) -> opt_state.

    step.init makes the leaves once, on the scene's device, with the flat
    gradient buffer and the optimiser. A step copies the caller's params,
    target and dt into its static buffers only where they are not already
    those buffers (a target tensor already copied and not written since is
    not copied again). The returned params are a (scene, camera) of aliases of
    the leaves, valid until the next step (pass them back in: nothing is
    copied then); the loss is a tensor of its own.

    graph: None runs the step as CUDA graphs on a CUDA device and eagerly
    elsewhere; True needs a CUDA device; False keeps every step eager, the
    same launches queued from Python and torch.equal to the graph. Without
    a process group the whole step is one graph: the bands, the backward,
    the flat buffer, the division by the band count and, for a capturable
    optimiser, its update. With an NCCL group on a CUDA device it is one
    graph too, the all-reduce between the flat buffer and the division
    (JAX's pmean inside the jitted step). With a gloo group, whose
    all-reduce goes through the host, it is a graph of the bands, the
    backward and the flat buffer, then the all-reduce eagerly, then a graph
    of the division and the update. The layouts give the same bits. Every
    process runs one all-reduce a step, at a capture (its eager warm-up) as
    at a replay, so processes whose graphs were captured at different steps
    still pair their all-reduces. A capture that fails raises; nothing
    falls back to the eager collective. An optimiser that is not capturable
    steps eagerly after the replay. Every step runs without a host sync
    under set_sync_debug_mode("error") when the caller's params are the
    step's own leaves (or on the device) and dt is a float or a device
    tensor.

    Telemetry (utils/telemetry.py): under a torch profiler a step is the
    span `dist.step` on the host, and gloo's eager all-reduce inside it
    `dist.allreduce`; with a process group every step counts
    `dist.allreduces` (one) and `dist.allreduce_bytes` (the flat buffer's
    bytes), from the buffer's size on the host.

    optimizer: a function of the named leaf tensors ({"spheres.center": t,
    ...}) to a torch.optim.Optimizer over the leaves it trains (default:
    Adam at lr 1e-2 over every leaf, as optax.adam(1e-2); on a CUDA device
    capturable and fused, step_graph.card_adam). backend "pallas" runs
    soft_band_mse_loss (K3, or K6 with shadows) at the standard loss_scale
    1/255 and soft_band_packed (K1 / K2 or K4 / K5) and the MSE in torch
    otherwise; "jnp" the plain soft renderer (render/softmin.py) in
    sub-bands under torch.utils.checkpoint. animate=True ticks the sphere
    physics (update_scene) by `dt` inside the step, differentiably. JAX's
    `interpret` has no counterpart: CPU tensors run the kernels' plain
    versions."""
    rows = _check_divisible(config.height, mesh.size)
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown train-step backend {backend!r}")
    make_opt = _adam if optimizer is None else optimizer
    e1, e2 = projection_elements(config)
    n_obj = config.max_spheres + config.max_planes
    sub = max(1, min(rows, _JNP_CHUNK_BYTES // max(1, config.width * n_obj * 3 * 4)))
    while rows % sub:
        sub -= 1

    def band_loss(scene, camera, target_band, row0):
        if backend == "pallas":
            sph, pl, cam = _packed(scene, camera)
            if loss_scale == 1.0 / 255.0:
                return soft_band_mse_loss(sph, pl, cam, row0, target_band, config=config,
                                          tau=tau, band_h=rows)
            out = soft_band_packed(sph, pl, cam, row0, config=config, tau=tau, band_h=rows)
            rgb = out[SO_R:SO_B + 1].permute(1, 2, 0)
        else:
            # Sub-bands bound the [r, W, n_obj, 3] shading intermediates
            # (4K with 200 spheres would otherwise take hundreds of GB), and
            # the checkpoint keeps only each sub-band's inputs for backward.
            def sub_band(r0):
                origin, dirs = camera_rays(camera, config.width, config.height, e1, e2,
                                           row_start=r0, n_rows=sub, device=scene.device)
                return trace_soft(scene, origin, dirs, config, tau=tau)[0]

            if sub == rows:
                rgb = sub_band(row0)
            else:
                rgb = torch.cat([torch.utils.checkpoint.checkpoint(sub_band, r0,
                                                                   use_reentrant=False)
                                 for r0 in range(row0, row0 + rows, sub)], 0)
        err = (rgb - target_band) * loss_scale
        return torch.mean(err * err)

    def _all_reduce(flat):
        """The bands' sum over the processes (SUM, then update()'s division
        by the band count: gloo has no ReduceOp.AVG, and every layout sums
        alike)."""
        if mesh.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)

    def init(params) -> TrainState:
        device = params[0].device
        leaves = {k: v.detach().to(device, copy=True).requires_grad_(True)
                  for k, v in _leaves(params).items()}
        flat = torch.zeros(sum(v.numel() for v in leaves.values()) + 1, dtype=torch.float32,
                           device=device)
        off = 0
        for v in leaves.values():
            v.grad = flat[off:off + v.numel()].view(v.shape)
            off += v.numel()
        opt = make_opt(leaves)
        st = TrainState(leaves, opt, flat, torch.zeros(1, dtype=torch.float32, device=device),
                        all(group.get("capturable", False) for group in opt.param_groups))

        def bands():
            """Loss and gradients of this process's bands into flat."""
            scene, camera = _params(st.leaves)
            if animate:
                scene = update_scene(scene, st.dt, config.bob_min_y, config.bob_max_y)
            loss = sum(band_loss(scene, camera, st.target[b * rows:(b + 1) * rows], b * rows)
                       for b in mesh.bands())
            grads = torch.autograd.grad(loss, list(st.leaves.values()), allow_unused=True)
            for v, g in zip(st.leaves.values(), grads):
                if g is None:
                    v.grad.zero_()
                else:
                    v.grad.copy_(g)
            st.flat[-1:].copy_(loss.detach().reshape(1))

        def update():
            """The band mean, then the optimiser when it is capturable."""
            st.flat.div_(mesh.size)
            if st.opt_in_graph:
                st.optimizer.step()

        def whole():
            bands()
            _all_reduce(st.flat)
            update()

        split = mesh.group is not None and not _collective_in_graph(mesh.group, device)
        phases = (bands, update) if split else (whole,)
        st.phases = tuple(CapturedCall(fn, device, graph=graph) for fn in phases)
        return st

    def step(params, opt_state: TrainState, target, dt=0.0):
        with span("dist.step"):
            return _step(params, opt_state, target, dt)

    def _step(params, st: TrainState, target, dt):
        with torch.no_grad():
            for k, v in _leaves(params).items():
                if not same_tensor(st.leaves[k], v):
                    st.leaves[k].copy_(v)
            if st.target is None or st.target.shape != target.shape:
                st.target = torch.empty(target.shape, dtype=torch.float32,
                                        device=st.flat.device)
                st.target_src = None
            src = st.target_src
            if not (same_tensor(st.target, target)
                    or (src and src[0] is target and src[1] == target._version)):
                st.target.copy_(target)
                st.target_src = (target, target._version)
            if animate:
                if isinstance(dt, torch.Tensor):
                    st.dt.copy_(dt.reshape(1))
                else:
                    st.dt.fill_(float(np.float32(dt)))
        key = (st.target.shape, st.target.data_ptr())
        if mesh.group is not None:
            count("dist.allreduces")
            count("dist.allreduce_bytes", st.flat.numel() * st.flat.element_size())
        st.phases[0](key)
        if len(st.phases) == 2:
            with span("dist.allreduce"):
                _all_reduce(st.flat)
            st.phases[1](key)
        if not st.opt_in_graph:
            st.optimizer.step()
        new = _params({k: v.detach() for k, v in st.leaves.items()})
        return new, st, st.flat[-1].clone()

    step.init = init
    return step
