"""Dense scene / camera packing for the kernel.

Counterpart: rtwc_tpu/render/pack.py:20-83, same layouts: spheres
[8, NS] f32, planes [12, NP] f32, counts [2] i32, camera [1, 16] f32, with
the same row / slot constants. Live objects are compacted to the front by
a *stable* sort: the kernel's primary loop reads sphere indices from the
broad-phase lists, while its shadow loop runs k = 0..counts[0]-1 straight
over the table, and both are right only because the live spheres fill the
first counts[0] columns in creation order (the closest-hit tie order).
"""
from __future__ import annotations

import torch

from rtwc_tpu_torch.camera import Camera, basis

SPH_ROWS = 8
S_CX, S_CY, S_CZ, S_R, S_COLR, S_COLG, S_COLB, S_ACTIVE = range(8)
PL_ROWS = 12
P_CX, P_CY, P_CZ, P_NX, P_NY, P_NZ, P_HW, P_HH, P_COLR, P_COLG, P_COLB, P_ACTIVE = range(12)
CAM_LEN = 16
(C_POSX, C_POSY, C_POSZ,
 C_RX, C_RY, C_RZ,
 C_UX, C_UY, C_UZ,
 C_FX, C_FY, C_FZ) = range(12)
# Spare camera slots (rtwc_tpu/render/pallas_soft.py:76): live counts as f32
# on the soft paths, and the band's first image row.
C_NSPH, C_NPL, C_ROW0 = 12, 13, 14


def _compact(active: torch.Tensor) -> torch.Tensor:
    """Permutation putting active slots before inactive ones, stable."""
    key = torch.where(active > 0.5, 0, 1)
    return torch.argsort(key, stable=True)


def pack_scene(scene):
    """Scene -> (sph [8, NS] f32, pl [12, NP] f32, counts [2] i32) on the
    scene's device. Each table is its rows in slot order, then one gather of
    the compacting permutation's columns (one indexed add backward): a step
    pays every launch here on the card."""
    sp = scene.spheres
    sph = torch.cat([sp.center.T, sp.radius[None], sp.color.T, sp.active[None]])
    sph = sph[:, _compact(sp.active)]
    pln = scene.planes
    pl = torch.cat([pln.center.T, pln.normal.T, (pln.width * 0.5)[None],
                    (pln.height * 0.5)[None], pln.color.T, pln.active[None]])
    pl = pl[:, _compact(pln.active)]
    counts = torch.stack([
        (sp.active > 0.5).sum().to(torch.int32),
        (pln.active > 0.5).sum().to(torch.int32),
    ])
    return sph.float().contiguous(), pl.float().contiguous(), counts


def pack_camera(camera: Camera, device: torch.device | str | None = None) -> torch.Tensor:
    """Camera -> [1, 16] f32: position + basis (right, up, forward) + 4
    spare zeros. Built where the camera lives (the host) and then moved to
    `device` in one asynchronous copy (the host never waits for the card)."""
    pos = camera.pos.to(torch.float32)
    right, up, forward = basis(camera.rot.to(torch.float32))
    vec = torch.cat([pos, right, up, forward, torch.zeros(4, dtype=torch.float32,
                                                          device=pos.device)])
    return vec[None, :].to(device if device is not None else pos.device, non_blocking=True)


def with_counts(cam: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """cam [1, 16] with the live counts written as f32 into cam[0, C_NSPH]
    and cam[0, C_NPL] (pallas_soft.py:2702-2705). Built out of place with
    torch.cat, so autograd still reaches the position and basis slots; the
    count slots take no gradient."""
    c = counts.reshape(-1).to(device=cam.device, dtype=cam.dtype)
    return torch.cat([cam[:, :C_NSPH], c[None, :2], cam[:, C_NPL + 1:]], dim=1)
