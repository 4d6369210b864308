"""Pieces the drivers share: the port's config from a configuration file,
scenes from the harness's arrays, the comparison of norms by leaf."""
from __future__ import annotations

import statistics

import numpy as np
import torch

from portbench.reference.config import Render


def render_dict(config: dict, traffic: dict) -> dict:
    return {**config["render"], **traffic.get("render", {})}


def ref_config(config: dict, traffic: dict) -> Render:
    return Render.from_dict(render_dict(config, traffic))


def port_config(config: dict, traffic: dict):
    """rtwc_tpu_torch's RenderConfig with the configuration's constants."""
    import dataclasses

    from rtwc_tpu_torch.config import RenderConfig, RenderMode

    d = render_dict(config, traffic)
    names = {f.name for f in dataclasses.fields(RenderConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items() if k in names}
    kw["mode"] = RenderMode(kw["mode"])
    return RenderConfig(**kw)


def port_scene(scene: dict, device, requires_grad: bool = False):
    """The port's Scene holding copies of the harness's arrays."""
    from rtwc_tpu_torch.scene import Planes, Scene, Spheres

    def t(a):
        x = torch.from_numpy(np.array(a, np.float32)).to(device)
        return x.requires_grad_(True) if requires_grad else x

    return Scene(spheres=Spheres(**{k: t(v) for k, v in scene["spheres"].items()}),
                 planes=Planes(**{k: t(v) for k, v in scene["planes"].items()}))


def leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Each kept leaf's |norm(prog) - norm(ref)| over max(norm(ref), the
    median leaf's norm)."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    med = statistics.median(norms.values()) if norms else 0.0
    return [abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
            / max(norms[k], med, 1e-30) for k in keep]


def norm_gaps(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's gap (leaf_gaps)."""
    return max(leaf_gaps(prog, ref, keep), default=0.0)


def median_gap(prog: dict, ref: dict, keep) -> float:
    """The median leaf's gap (leaf_gaps)."""
    gaps = leaf_gaps(prog, ref, keep)
    return statistics.median(gaps) if gaps else 0.0


def kept_leaves(grads: dict) -> list:
    """Leaves whose reference gradient reaches a thousandth of the median
    leaf's (by norm): the others move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
    live = [v for v in norms.values() if v > 0]
    med = statistics.median(live) if live else 0.0
    return [k for k, v in norms.items() if v >= 1e-3 * med and v > 0]
