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
device a rank and an initialised group, while the one-card machine this
port is measured on runs several ranks on one card through gloo (NCCL
refuses two ranks on one device), and the tests and the CPU run several
bands in one process. A process renders its size / world_size
consecutive bands in turn, so one process alone holds the whole mesh, as
JAX's virtual CPU devices do.

Backends (JAX's names): "pallas" runs the hand-written CUDA kernels that
replace the Pallas ones (K7 for the display, K1-K6 and the reduction for
the train step; on CPU tensors their plain versions), "jnp" the plain
torch renderers (render/reference.py, render/softmin.py). "auto" picks
"pallas" on a CUDA scene and "jnp" elsewhere.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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
from rtwc_tpu_torch.scene import Planes, Scene, Spheres, update_scene

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


def _backend(backend: str, device: torch.device) -> str:
    if backend == "auto":
        return "pallas" if device.type == "cuda" else "jnp"
    if backend not in ("jnp", "pallas"):
        raise ValueError(f"unknown sharded-render backend {backend!r}")
    return backend


def _render_band(scene: Scene, camera: Camera, config: RenderConfig, row0: int, rows: int,
                 backend: str) -> Framebuffer:
    if backend == "pallas":
        sph, pl, counts = P.pack_scene(scene)
        cam = P.pack_camera(camera, scene.device)
        out = hard_band_packed(sph, pl, counts, cam, row0, config=config, band_h=rows)
        return planes_to_framebuffer(out, config, rows)
    e1, e2 = projection_elements(config)
    origin, dirs = camera_rays(camera, config.width, config.height, e1, e2, row_start=row0,
                               n_rows=rows, device=scene.device)
    t, normal, color, shading = trace_hard(scene, origin, dirs)
    rgb = shade(scene, origin, dirs, t, normal, color, config)
    hit = t <= config.far
    return Framebuffer(rgb=rgb, normal=normal, depth=t, shading=shading, hit=hit,
                       coverage=hit.float(), alpha=hit.float())


def _gather_rows(fb: Framebuffer, mesh: Mesh) -> Framebuffer:
    """Every process's rows, in band order, on every process: one
    all_gather of the fields stacked as float32 channels (through the host
    under gloo, whose all_gather takes CPU tensors only)."""
    parts = [getattr(fb, f) for f in _FB_FIELDS]
    widths = [1 if p.dim() == 2 else p.shape[2] for p in parts]
    local = torch.cat([p.float().reshape(p.shape[0], p.shape[1], -1) for p in parts], 2)
    if dist.get_backend(mesh.group) == "gloo":
        local = local.cpu()
    chunks = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(chunks, local.contiguous(), group=mesh.group)
    full = torch.cat(chunks, 0).to(parts[0].device)
    out, c = {}, 0
    for name, p, w in zip(_FB_FIELDS, parts, widths):
        v = full[..., c:c + w]
        out[name] = (v[..., 0] if p.dim() == 2 else v).to(p.dtype)
        c += w
    return Framebuffer(**out)


def render_frame_sharded(scene: Scene, camera: Camera, config: RenderConfig, mesh: Mesh,
                         backend: str = "auto") -> Framebuffer:
    """Tile-sharded forward render: each band of image rows is rendered
    against the replicated scene, this process's bands in turn, and with
    several processes every process receives the whole frame. backend:
    "pallas" runs K7 (hard_band_packed) a band, "jnp" the plain reference
    renderer, "auto" picks by the scene's device. Pixels equal the
    single render's (K7's bit for bit on the card)."""
    rows = _check_divisible(config.height, mesh.size)
    backend = _backend(backend, scene.device)
    bands = [_render_band(scene, camera, config, b * rows, rows, backend) for b in mesh.bands()]
    fb = Framebuffer(**{f: torch.cat([getattr(b, f) for b in bands], 0) for f in _FB_FIELDS})
    return fb if mesh.group is None else _gather_rows(fb, mesh)


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


@dataclasses.dataclass
class TrainState:
    """step.init's optimiser state: the optimiser and the leaf tensors it
    updates (named as _leaves names them)."""

    leaves: dict
    optimizer: torch.optim.Optimizer


def _adam(leaves: dict) -> torch.optim.Optimizer:
    return torch.optim.Adam(list(leaves.values()), lr=1e-2)


def make_sharded_train_step(
    config: RenderConfig,
    mesh: Mesh,
    tau: float,
    optimizer: Callable[[dict], torch.optim.Optimizer] | None = None,
    loss_scale: float = 1.0 / 255.0,
    backend: str = "jnp",
    animate: bool = False,
) -> Callable:
    """The multi-band inverse-rendering train step (BASELINE configs 4-5).

    Each band: the soft render of its rows, the MSE against its rows of the
    target, gradients to the replicated scene and camera; then one
    all-reduce averages the gradients and the loss over the bands, and the
    optimiser steps. Returns step(params, opt_state, target, dt=0.0) ->
    (params, opt_state, loss) with params = (scene, camera), target [H, W,
    3], and step.init(params) -> opt_state. The returned params are new
    tensors; the optimiser keeps its own leaves.

    optimizer: a function of the named leaf tensors ({"spheres.center": t,
    ...}) to a torch.optim.Optimizer over the leaves it trains (default:
    Adam at lr 1e-2 over every leaf, as optax.adam(1e-2)). backend "pallas"
    runs soft_band_mse_loss (K3, or K6 with shadows) at the standard
    loss_scale 1/255 and soft_band_packed (K1 / K2 or K4 / K5) and the MSE
    in torch otherwise; "jnp" the plain soft renderer (render/softmin.py)
    in sub-bands under torch.utils.checkpoint. animate=True ticks the sphere
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

    def init(params) -> TrainState:
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in _leaves(params).items()}
        return TrainState(leaves, make_opt(leaves))

    def step(params, opt_state: TrainState, target, dt=0.0):
        leaves = opt_state.leaves
        with torch.no_grad():
            for k, v in _leaves(params).items():
                if v is not leaves[k]:
                    leaves[k].copy_(v)
        scene, camera = _params(leaves)
        if animate:
            scene = update_scene(scene, dt, config.bob_min_y, config.bob_max_y)
        loss = sum(band_loss(scene, camera, target[b * rows:(b + 1) * rows], b * rows)
                   for b in mesh.bands())
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
        # one buffer on the loss's device (the camera's leaves live on the host)
        flat = torch.cat([(torch.zeros_like(leaves[k]) if g is None else g).reshape(-1)
                          .to(loss.device) for k, g in zip(names, grads)]
                         + [loss.detach().reshape(1)])
        if mesh.group is not None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat = flat / mesh.size
        off = 0
        for k in names:
            n = leaves[k].numel()
            leaves[k].grad = flat[off:off + n].reshape(leaves[k].shape).to(leaves[k].device)
            off += n
        opt_state.optimizer.step()
        new = _params({k: v.detach().clone() for k, v in leaves.items()})
        return new, opt_state, flat[-1]

    step.init = init
    return step
