"""The animated fit: the physics tick inside the loss, differentiably.

`tick` is scenes.update_scene's bobbing written in torch, so that autograd
carries the loss's gradient through it: y = centre_y + speed * mover * dt,
clamped to [bob_min_y, bob_max_y] (no gradient through a clamped y), the
direction flipped where y left the range, dead slots untouched. The
rendered scene is the ticked one, so the centres, speeds and directions
all get a gradient from the y that they make.

`loss_and_grads` is the whole frame's mean(((rgb - target) / 255)^2) at
the ticked scene, with the gradients of every trained leaf through the
tick: soft.loss_and_grads renders the ticked leaves (its banded renderer,
by import) and the tick's own backward carries their gradients to the
leaves. A mean of equal row bands' means is the whole frame's mean, so it
is also the sharded step's loss.

`band_gates` is soft.needed_gates on one row band's own tile grid: the
tiles start at the band's first row and no pixel past its last row counts.
"""
from __future__ import annotations

import torch

from portbench.reference import soft
from portbench.reference.camera import rays


def tick(lv: dict, dt, bob_min_y: float, bob_max_y: float) -> dict:
    """lv with spheres.center and spheres.mover ticked by dt, differentiable
    in the leaves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c, speed, mover, active = (lv[f"spheres.{f}"] for f in ("center", "speed", "mover", "active"))
    dt = torch.as_tensor(dt, dtype=c.dtype, device=c.device)
    y = c[:, 1] + speed * mover * dt
    out = (y < bob_min_y) | (y > bob_max_y)
    y = torch.clamp(y, bob_min_y, bob_max_y)
    live = active > 0.5
    center = torch.stack([c[:, 0], torch.where(live, y, c[:, 1]), c[:, 2]], 1)
    flipped = torch.where(out, -mover, mover)
    return {**lv, "spheres.center": center,
            "spheres.mover": torch.where(live, flipped, mover)}


def render(lv: dict, cfg, tau: float, shadows: bool, dt):
    """(rgb, alpha) of the ticked scene, without autograd."""
    with torch.no_grad():
        return soft.render(tick(lv, dt, cfg.bob_min_y, cfg.bob_max_y), cfg, tau, shadows)


def loss_and_grads(lv: dict, trained, cfg, tau: float, shadows: bool, target, dt):
    """(loss, {name: gradient or None}) of the frame's MSE at the ticked
    scene, every gradient taken through the tick."""
    ticked = tick(lv, dt, cfg.bob_min_y, cfg.bob_max_y)
    moved = [k for k in ("spheres.center", "spheres.mover") if ticked[k].requires_grad]
    cut = {**lv, **{k: ticked[k].detach().requires_grad_(True) for k in moved}}
    inner = sorted(set(trained) | set(moved))
    loss, g = soft.loss_and_grads(cut, inner, cfg, tau, shadows, target)
    sources = [lv[k] for k in trained if lv[k].requires_grad]
    outs = [(ticked[k], g[k]) for k in moved if g[k] is not None]
    through = torch.autograd.grad([o for o, _ in outs], sources, [gk for _, gk in outs],
                                  allow_unused=True) if outs else [None] * len(sources)
    via = dict(zip([k for k in trained if lv[k].requires_grad], through))
    grads = {}
    for k in trained:
        direct = g.get(k) if k not in moved else None
        parts = [x for x in (direct, via.get(k)) if x is not None]
        grads[k] = sum(parts[1:], parts[0]) if parts else None
    return loss, grads


def band_gates(lv: dict, cfg, tau: float, lists, row0: int, rows: int, tile: int = 16):
    """soft.needed_gates for the band of `rows` image rows from `row0`, on
    the band's own tile grid; lists are the band's sphere lists."""
    sp, pl = soft._objects(lv)
    ns, npl = sp.center.shape[0], pl.center.shape[0]
    Ti, Tj = (rows + tile - 1) // tile, (cfg.width + tile - 1) // tile
    need = torch.zeros((Ti, Tj, ns + npl), dtype=torch.bool, device=sp.center.device)
    k, mp, far = cfg.soft_mask_k, cfg.soft_miss_penalty, cfg.far
    with torch.no_grad():
        for ti in range(Ti):
            n = min(tile, rows - ti * tile)
            o, d = rays(lv["camera.pos"], lv["camera.rot"], cfg, row0 + ti * tile, n,
                        dtype=lv["camera.rot"].dtype)
            logits = -torch.cat([soft._sphere_terms(o, d, sp, k, mp, far)[0],
                                 soft._plane_terms(o, d, pl, k, mp, far)[0]], -1) / tau
            top = torch.maximum(logits.amax(-1), logits.new_tensor(-far / tau))
            near = torch.nn.functional.pad((logits - top[..., None]) > -16.0,
                                           (0, 0, 0, Tj * tile - cfg.width))
            need[ti] = near.reshape(n, Tj, tile, -1).any(dim=2).any(dim=0)
    need = need.reshape(Ti * Tj, -1)
    listed = torch.zeros((Ti * Tj, ns), dtype=torch.bool, device=need.device)
    slots = torch.arange(ns, device=need.device)[None, :] < lists[:, 0, 0].long()[:, None]
    listed.scatter_(1, lists[:, 0, 1:].long(), slots)
    gates = torch.zeros((Ti * Tj, 2, ns + npl), dtype=torch.int32, device=need.device)
    gates[:, 0, :ns] = (need[:, :ns] & listed).int()
    gates[:, 0, ns:] = (need[:, ns:] & (pl.active > 0.5)[None, :]).int()
    return gates
