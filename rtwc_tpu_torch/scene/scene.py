"""Scene as a struct-of-arrays of tensors, padded to a capacity.

Counterpart: rtwc_tpu/scene/scene.py:27-289. Same fields, same padding
values, same host-side construction: the builders work in NumPy with an
explicit `np.random.Generator` exactly as the JAX package does
(scene.py:111-147, :236-269), so one seed gives one scene in both packages.
Tensors stay where they are: `add_sphere` on a device scene pulls the
leaves to the host, writes the slot and pushes them back to the same
device (the engine does so at most once a second, on spawn).

`update_scene` is the per-frame physics tick and runs on the scene's
device. `scene_from_numpy` is the bridge from the JAX package's Scene,
and `scene_grads_to_numpy` brings gradients back in its layout.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.mathx import tensor_dataclass
from rtwc_tpu_torch.utils.telemetry import count

_SPHERE_FIELDS = ("center", "radius", "color", "speed", "mover", "active")
_PLANE_FIELDS = ("center", "normal", "color", "width", "height", "active")


@tensor_dataclass
class Spheres:
    """Padded sphere pool (Sphere.h:6-24 fields); colour 0..255 float."""

    center: torch.Tensor  # [N, 3] f32
    radius: torch.Tensor  # [N]    f32
    color: torch.Tensor   # [N, 3] f32, 0..255
    speed: torch.Tensor   # [N]    f32
    mover: torch.Tensor   # [N]    f32 (+1 / -1)
    active: torch.Tensor  # [N]    f32 (1.0 live, 0.0 dead)

    @property
    def capacity(self) -> int:
        return self.center.shape[0]


@tensor_dataclass
class Planes:
    """Padded finite axis-aligned rectangle pool (Plane.h:6-37)."""

    center: torch.Tensor  # [M, 3]
    normal: torch.Tensor  # [M, 3] (unit)
    color: torch.Tensor   # [M, 3] 0..255
    width: torch.Tensor   # [M]
    height: torch.Tensor  # [M]
    active: torch.Tensor  # [M]


@tensor_dataclass
class Scene:
    spheres: Spheres
    planes: Planes

    @property
    def n_spheres(self) -> int:
        """Live sphere count (reads the device: one host read)."""
        count("host_reads")
        return int(self.spheres.active.sum().item())

    @property
    def n_planes(self) -> int:
        count("host_reads")
        return int(self.planes.active.sum().item())

    @property
    def device(self) -> torch.device:
        return self.spheres.center.device


def _t(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device or "cpu")


def _host(x: torch.Tensor) -> np.ndarray:
    """x as a float32 NumPy copy (reads the device: one host read)."""
    count("host_reads")
    return np.array(x.detach().cpu().numpy(), np.float32)


def empty_scene(max_spheres: int = 256, max_planes: int = 16,
                device: torch.device | str | None = None) -> Scene:
    """All-inactive padded scene of static capacity (scene.py:80-108)."""
    f = np.float32
    return Scene(
        spheres=Spheres(
            center=_t(np.zeros((max_spheres, 3), f), device),
            radius=_t(np.ones((max_spheres,), f), device),
            color=_t(np.zeros((max_spheres, 3), f), device),
            speed=_t(np.ones((max_spheres,), f), device),
            mover=_t(-np.ones((max_spheres,), f), device),
            active=_t(np.zeros((max_spheres,), f), device),
        ),
        planes=Planes(
            center=_t(np.zeros((max_planes, 3), f), device),
            normal=_t(np.tile(np.array([[0.0, 1.0, 0.0]], f), (max_planes, 1)), device),
            color=_t(np.zeros((max_planes, 3), f), device),
            width=_t(np.ones((max_planes,), f), device),
            height=_t(np.ones((max_planes,), f), device),
            active=_t(np.zeros((max_planes,), f), device),
        ),
    )


def add_sphere(scene: Scene, radius: float, center, color,
               speed: float | None = None,
               rng: np.random.Generator | None = None) -> Scene:
    """Append into the first free slot on the host (scene.py:111-147);
    refuses silently when the pool is full. Speed in [1.0, 4.0) from rng."""
    sp = scene.spheres
    slot = scene.n_spheres
    if slot >= sp.capacity:
        return scene
    if speed is None:
        rng = rng or np.random.default_rng()
        speed = float(rng.integers(100, 400)) / 100.0
    device = sp.center.device

    def upd(arr, value):
        out = _host(arr)
        out[slot] = value
        return _t(out, device)

    sp = sp.replace(
        center=upd(sp.center, np.asarray(center, np.float32)),
        radius=upd(sp.radius, float(radius)),
        color=upd(sp.color, np.asarray(color, np.float32)),
        speed=upd(sp.speed, float(speed)),
        mover=upd(sp.mover, -1.0),
        active=upd(sp.active, 1.0),
    )
    return scene.replace(spheres=sp)


def add_plane(scene: Scene, center, normal, color, width: float, height: float) -> Scene:
    """Append a finite plane (scene.py:150-173); normal normalised in f64."""
    pl = scene.planes
    slot = scene.n_planes
    if slot >= pl.active.shape[0]:
        return scene
    n = np.asarray(normal, np.float64)
    n = (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)
    device = pl.center.device

    def upd(arr, value):
        out = _host(arr)
        out[slot] = value
        return _t(out, device)

    pl = pl.replace(
        center=upd(pl.center, np.asarray(center, np.float32)),
        normal=upd(pl.normal, n),
        color=upd(pl.color, np.asarray(color, np.float32)),
        width=upd(pl.width, float(width)),
        height=upd(pl.height, float(height)),
        active=upd(pl.active, 1.0),
    )
    return scene.replace(planes=pl)


def default_scene(config: RenderConfig | None = None, seed: int = 0,
                  device: torch.device | str | None = None) -> Scene:
    """The reference's seed scene: 5 spheres + 1 ground plane
    (scene.py:176-188). Built on the host, then moved once to `device`."""
    config = config or RenderConfig()
    rng = np.random.default_rng(seed)
    s = empty_scene(config.max_spheres, config.max_planes)
    s = add_sphere(s, 7.0, (0.0, 10.0, 20.0), (255.0, 1.0, 1.0), rng=rng)
    s = add_sphere(s, 6.0, (5.0, 10.0, 20.0), (1.0, 255.0, 1.0), rng=rng)
    s = add_sphere(s, 10.0, (10.0, 10.0, 40.0), (1.0, 1.0, 255.0), rng=rng)
    s = add_sphere(s, 3.0, (5.0, 10.0, 20.0), (225.0, 210.0, 20.0), rng=rng)
    s = add_sphere(s, 4.0, (-5.0, 10.0, 40.0), (225.0, 10.0, 220.0), rng=rng)
    s = add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 10.0, 20.0)
    return s.to(device or "cpu")


def grow_scene(scene: Scene, max_spheres: int | None = None,
               max_planes: int | None = None) -> Scene:
    """Pad the scene to a larger capacity with inactive slots
    (scene.py:191-233); shrinking raises. Stays on the scene's device."""
    sp, pl = scene.spheres, scene.planes
    ns = sp.capacity if max_spheres is None else max_spheres
    npl = pl.active.shape[0] if max_planes is None else max_planes
    if ns < sp.capacity or npl < pl.active.shape[0]:
        raise ValueError(
            f"grow_scene cannot shrink: have {sp.capacity}x{pl.active.shape[0]}, "
            f"asked {ns}x{npl}")

    def pad(arr, n, fill=0.0):
        extra = n - arr.shape[0]
        if extra == 0:
            return arr
        pad_rows = torch.full((extra,) + tuple(arr.shape[1:]), fill,
                              dtype=torch.float32, device=arr.device)
        return torch.cat([arr, pad_rows], dim=0)

    new_sp = Spheres(
        center=pad(sp.center, ns), radius=pad(sp.radius, ns, 1.0),
        color=pad(sp.color, ns), speed=pad(sp.speed, ns, 1.0),
        mover=pad(sp.mover, ns, -1.0), active=pad(sp.active, ns),
    )
    normal = pl.normal
    extra = npl - normal.shape[0]
    if extra:
        up = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float32, device=normal.device)
        normal = torch.cat([normal, up.expand(extra, 3)], dim=0)
    new_pl = Planes(
        center=pad(pl.center, npl), normal=normal, color=pad(pl.color, npl),
        width=pad(pl.width, npl, 1.0), height=pad(pl.height, npl, 1.0),
        active=pad(pl.active, npl),
    )
    return Scene(spheres=new_sp, planes=new_pl)


def spawn_random_sphere(scene: Scene, rng: np.random.Generator) -> Scene:
    """The 1 Hz test spawn (scene.py:236-245): radius rand()%10, position
    components rand()%100-50, colour components rand()%255."""
    return add_sphere(
        scene,
        radius=float(rng.integers(0, 10)),
        center=rng.integers(-50, 50, size=3).astype(np.float32),
        color=rng.integers(0, 255, size=3).astype(np.float32),
        rng=rng,
    )


def random_scene(n_spheres: int, n_planes: int = 1, max_spheres: int | None = None,
                 max_planes: int | None = None, seed: int = 0, spread: float = 40.0,
                 device: torch.device | str | None = None) -> Scene:
    """Benchmark scene generator (scene.py:248-269), same draws per seed."""
    rng = np.random.default_rng(seed)
    s = empty_scene(max_spheres or max(n_spheres, 32), max_planes or max(n_planes, 4))
    for _ in range(n_spheres):
        s = add_sphere(
            s,
            radius=float(rng.uniform(1.0, 6.0)),
            center=np.array([rng.uniform(-spread, spread), rng.uniform(-5, 25),
                             rng.uniform(10, 10 + 2 * spread)]),
            color=rng.uniform(1, 255, size=3),
            rng=rng,
        )
    for _ in range(n_planes):
        s = add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0),
                      2 * spread, 2 * spread)
    return s.to(device or "cpu")


def update_scene(scene: Scene, dt: float | torch.Tensor, bob_min_y: float = -10.0,
                 bob_max_y: float = 10.0) -> Scene:
    """Physics tick over all spheres on their device (scene.py:272-289):
    y += speed * mover * dt; leaving [bob_min_y, bob_max_y] clamps y and
    flips the direction. Inactive slots keep their state bit for bit.
    `dt` is an f32 tensor of one element on the scene's device (the display
    step replayed as a CUDA graph reads it there), or a float rounded to f32
    first; either way the JAX engine's np.float32 time step."""
    if isinstance(dt, torch.Tensor):
        if dt.dtype != torch.float32 or dt.numel() != 1:
            raise ValueError(f"dt must be one f32 value, got {dt.dtype} {tuple(dt.shape)}")
    else:
        dt = float(np.float32(dt))
    sp = scene.spheres
    y = sp.center[:, 1] + sp.speed * sp.mover * dt
    out = (y < bob_min_y) | (y > bob_max_y)
    y = torch.clamp(y, bob_min_y, bob_max_y)
    mover = torch.where(out, -sp.mover, sp.mover)
    live = sp.active > 0.5
    center = sp.center.clone()
    center[:, 1] = torch.where(live, y, sp.center[:, 1])
    mover = torch.where(live, mover, sp.mover)
    return scene.replace(spheres=sp.replace(center=center, mover=mover))


def scene_from_numpy(tree, device: torch.device | str | None = None,
                     requires_grad=()) -> Scene:
    """Build the port's Scene from a JAX-package Scene (or any object with
    `spheres` / `planes` attributes whose leaves convert with np.asarray)
    under the same field names. `requires_grad` names the leaves that become
    autograd leaves, as "spheres.center", "planes.normal", ...; "all" marks
    every leaf."""
    want = set(requires_grad)

    def grab(node, group, cls, fields):
        out = {}
        for f in fields:
            t = torch.from_numpy(np.array(np.asarray(getattr(node, f)), np.float32))
            t = t.to(device or "cpu")
            if "all" in want or f"{group}.{f}" in want:
                t.requires_grad_(True)
            out[f] = t
        return cls(**out)

    return Scene(spheres=grab(tree.spheres, "spheres", Spheres, _SPHERE_FIELDS),
                 planes=grab(tree.planes, "planes", Planes, _PLANE_FIELDS))


def scene_grads_to_numpy(scene: Scene) -> SimpleNamespace:
    """The inverse direction for gradients: each leaf's `.grad` as an f32
    NumPy array under the JAX Scene's field names and shapes (zeros where a
    leaf has no gradient), so tests compare gradient trees leaf by leaf."""
    def grads(node, fields):
        return SimpleNamespace(**{
            f: (np.zeros(tuple(getattr(node, f).shape), np.float32) if getattr(node, f).grad is None
                else _host(getattr(node, f).grad)) for f in fields})

    return SimpleNamespace(spheres=grads(scene.spheres, _SPHERE_FIELDS),
                           planes=grads(scene.planes, _PLANE_FIELDS))
