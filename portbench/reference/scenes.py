"""Scenes as NumPy arrays, drawn from a seed.

The same draws, in the same order, as the port's scene builders (and the
JAX package's): `add_sphere` draws a speed from rng.integers(100, 400) /
100, `random_scene` draws radius, centre and colour per sphere. A scene is
a dict of two dicts of float32 arrays, "spheres" (center, radius, color,
speed, mover, active) and "planes" (center, normal, color, width, height,
active), padded to a capacity with the port's padding values.
"""
from __future__ import annotations

import numpy as np

SPHERE_FIELDS = ("center", "radius", "color", "speed", "mover", "active")
PLANE_FIELDS = ("center", "normal", "color", "width", "height", "active")


def empty(max_spheres: int, max_planes: int) -> dict:
    f = np.float32
    return {
        "spheres": {"center": np.zeros((max_spheres, 3), f), "radius": np.ones(max_spheres, f),
                    "color": np.zeros((max_spheres, 3), f), "speed": np.ones(max_spheres, f),
                    "mover": -np.ones(max_spheres, f), "active": np.zeros(max_spheres, f)},
        "planes": {"center": np.zeros((max_planes, 3), f),
                   "normal": np.tile(np.array([[0.0, 1.0, 0.0]], f), (max_planes, 1)),
                   "color": np.zeros((max_planes, 3), f), "width": np.ones(max_planes, f),
                   "height": np.ones(max_planes, f), "active": np.zeros(max_planes, f)},
    }


def copy(scene: dict) -> dict:
    return {g: {k: v.copy() for k, v in scene[g].items()} for g in scene}


def n_live(group: dict) -> int:
    return int((group["active"] > 0.5).sum())


def add_sphere(scene: dict, radius: float, center, color, rng: np.random.Generator,
               speed: float | None = None) -> dict:
    """Into the first free slot; a full pool refuses silently."""
    sp = scene["spheres"]
    slot = n_live(sp)
    if slot >= sp["active"].shape[0]:
        return scene
    if speed is None:
        speed = float(rng.integers(100, 400)) / 100.0
    sp["center"][slot] = np.asarray(center, np.float32)
    sp["radius"][slot] = float(radius)
    sp["color"][slot] = np.asarray(color, np.float32)
    sp["speed"][slot] = float(speed)
    sp["mover"][slot] = -1.0
    sp["active"][slot] = 1.0
    return scene


def add_plane(scene: dict, center, normal, color, width: float, height: float) -> dict:
    pl = scene["planes"]
    slot = n_live(pl)
    if slot >= pl["active"].shape[0]:
        return scene
    n = np.asarray(normal, np.float64)
    n = (n / max(np.linalg.norm(n), 1e-20)).astype(np.float32)
    pl["center"][slot] = np.asarray(center, np.float32)
    pl["normal"][slot] = n
    pl["color"][slot] = np.asarray(color, np.float32)
    pl["width"][slot] = float(width)
    pl["height"][slot] = float(height)
    pl["active"][slot] = 1.0
    return scene


def default_scene(max_spheres: int, max_planes: int, seed: int) -> dict:
    """Upstream's seed scene: 5 spheres and a ground plane."""
    rng = np.random.default_rng(seed)
    s = empty(max_spheres, max_planes)
    add_sphere(s, 7.0, (0.0, 10.0, 20.0), (255.0, 1.0, 1.0), rng)
    add_sphere(s, 6.0, (5.0, 10.0, 20.0), (1.0, 255.0, 1.0), rng)
    add_sphere(s, 10.0, (10.0, 10.0, 40.0), (1.0, 1.0, 255.0), rng)
    add_sphere(s, 3.0, (5.0, 10.0, 20.0), (225.0, 210.0, 20.0), rng)
    add_sphere(s, 4.0, (-5.0, 10.0, 40.0), (225.0, 10.0, 220.0), rng)
    add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 10.0, 20.0)
    return s


def random_scene(n_spheres: int, n_planes: int, max_spheres: int, max_planes: int, seed: int,
                 spread: float = 40.0) -> dict:
    """The bench's scene generator: n_spheres random spheres, n_planes ground planes."""
    rng = np.random.default_rng(seed)
    s = empty(max_spheres, max_planes)
    for _ in range(n_spheres):
        add_sphere(s, radius=float(rng.uniform(1.0, 6.0)),
                   center=np.array([rng.uniform(-spread, spread), rng.uniform(-5, 25),
                                    rng.uniform(10, 10 + 2 * spread)]),
                   color=rng.uniform(1, 255, size=3), rng=rng)
    for _ in range(n_planes):
        add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0),
                  2 * spread, 2 * spread)
    return s


def spawn_random_sphere(scene: dict, rng: np.random.Generator) -> dict:
    """The engine's 1 Hz spawn: radius rand()%10, centre rand()%100-50,
    colour rand()%255, then add_sphere's speed draw."""
    return add_sphere(scene, radius=float(rng.integers(0, 10)),
                      center=rng.integers(-50, 50, size=3).astype(np.float32),
                      color=rng.integers(0, 255, size=3).astype(np.float32), rng=rng)


def perturb_centres(scene: dict, sigma: float, rng: np.random.Generator) -> dict:
    """Live sphere centres plus N(0, sigma) per coordinate."""
    sp = scene["spheres"]
    noise = rng.normal(0.0, sigma, size=sp["center"].shape).astype(np.float32)
    noise[sp["active"] <= 0.5] = 0.0
    sp["center"] = sp["center"] + noise
    return scene


def update_scene(scene: dict, dt: np.float32, bob_min_y: float, bob_max_y: float) -> dict:
    """The physics tick in float32 NumPy: y += speed * mover * dt; leaving
    [bob_min_y, bob_max_y] clamps y and flips the direction; dead slots
    keep their state."""
    sp = scene["spheres"]
    f = np.float32
    y = sp["center"][:, 1] + sp["speed"] * sp["mover"] * f(dt)
    out = (y < f(bob_min_y)) | (y > f(bob_max_y))
    y = np.clip(y, f(bob_min_y), f(bob_max_y)).astype(f)
    live = sp["active"] > 0.5
    sp["center"][:, 1] = np.where(live, y, sp["center"][:, 1])
    sp["mover"] = np.where(live & out, -sp["mover"], sp["mover"]).astype(f)
    return scene
