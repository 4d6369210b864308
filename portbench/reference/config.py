"""The render constants of a configuration, read from its JSON file."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Render:
    width: int
    height: int
    mode: str
    fov_divisor: float
    near: float
    far: float
    aspect_coeff: float
    move_speed: float
    mouse_sensitivity: float
    light_pos: tuple
    light_diffuse_color: tuple
    light_specular_color: tuple
    light_diffuse_power: float
    light_specular_power: float
    specular_hardness: float
    ambient: float
    object_specular_color: tuple
    shadows: bool
    supersample: int
    max_spheres: int
    max_planes: int
    soft_mask_k: float
    soft_miss_penalty: float
    soft_shadow_k: float
    bob_min_y: float
    bob_max_y: float

    @classmethod
    def from_dict(cls, d: dict) -> "Render":
        names = {f.name for f in dataclasses.fields(cls)}
        missing = names - set(d)
        if missing:
            raise ValueError(f"the configuration lacks {sorted(missing)}")
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()
                      if k in names})

    def replace(self, **kw) -> "Render":
        return dataclasses.replace(self, **kw)
