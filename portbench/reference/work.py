"""The least time a kernel's work can take on the card: its bytes over the
memory rate or its float32 operations over the float32 rate, whichever is
longer, with the work counted from the cell's inputs.

OPS counts float32 operations per pixel (one per add, multiply,
compare-select, exp, log1p, sqrt, rsqrt or divide; the smaller count where
a branch could go either way), as read from the port's kernels when this
table was frozen; `soft_work`, `list_bytes` and `partial_bytes` count a
soft launch's work from its tile lists and gate tables. The harness feeds
them the lists of its own broad phase (reference/broad.py) and, as gates,
the objects that the reference's softmin weights need at some pixel of a
tile; shadow occluders, which it does not list, count nothing. So the
count is a lower bound on what the port's kernels do, and a share of the
bound cannot pass 100 % by a fault of the count.
"""
from __future__ import annotations

import torch

# One H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bytes/s, float32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
OPS = dict(raygen=20, lb_sphere=40, lb_plane=43, geo_sphere=40, geo_plane=47, shade=78,
           acc7=31, acc10=40, final=20, light_ray=20, pre_a=23, pre_b=12, pre_plane=35,
           trans=23, corr=62, blend=18, cot=28, vjp_sphere=345, vjp_plane=360,
           sh_vjp_sphere=260, sh_vjp_plane=300, block_sum=5, tf_slot=40, loss=12,
           hard_sphere=32, hard_plane=25, hard_shade=70, hard_shadow=30)
PX = 16 * 16        # pixels a tile
NTF_BWD, NTF_MSE = 12, 13   # two-float partial slots a tile: camera, camera + loss


def bound_ms(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def list_bytes(npl: int, *lists, gate_rows: bool = True) -> int:
    """Each list row's n and its n entries; with gate_rows one int a listed
    sphere and one a plane in the gate row the list fills."""
    total = 0
    for lst in lists:
        n = int(lst[:, 0, 0].long().sum())
        total += 4 * (n + lst.shape[0]) + (4 * (n + lst.shape[0] * npl) if gate_rows else 0)
    return total


def partial_bytes(gates, ns: int, npl: int, ntf: int, shadowed: bool = False) -> int:
    """The partial rows a soft backward writes: 8 floats a gated sphere,
    4 a gated shadow occluder, 12 a plane gated in either sweep, ntf
    two-float slots a tile."""
    g0 = gates[:, 0].long()
    rows = 8 * int(g0[:, :ns].sum()) + 2 * ntf * gates.shape[0]
    planes = g0[:, ns:ns + npl]
    if shadowed:
        rows += 4 * int(gates[:, 1, :ns].long().sum())
        planes = planes | gates[:, 1, ns:ns + npl].long()
    return 4 * (rows + 12 * int(planes.sum()))


def soft_work(lists, gates, npl: int, px: int, shl=None, counts=None, nc: int = 8) -> dict:
    """Float32 operations of a soft launch, summed over pixels: "fwd",
    "bwd" and, with the shadow lists and the forward's (count, applied)
    a tile, "sh_fwd" and "sh_bwd"."""
    ns = lists.shape[2] - 1
    L = lists[:, 0, 0].double()
    gs = gates[:, 0, :ns].sum(1).double()
    gp = gates[:, 0, ns:].sum(1).double()
    o = OPS
    fwd = (o["raygen"] + L * o["lb_sphere"] + npl * o["lb_plane"]
           + gs * (o["geo_sphere"] + o["shade"] + o["acc7"])
           + gp * (o["geo_plane"] + o["shade"] + o["acc7"]) + o["final"])
    bwd = (o["raygen"] + 2 * o["final"] + 12 * o["tf_slot"]
           + gs * (o["lb_sphere"] + o["geo_sphere"] + o["shade"] + o["cot"] + o["vjp_sphere"]
                   + 7 * o["block_sum"])
           + gp * (o["lb_plane"] + o["geo_plane"] + o["shade"] + o["cot"] + o["vjp_plane"]
                   + 11 * o["block_sum"]))
    work = {"fwd": float(fwd.sum()) * px, "bwd": float(bwd.sum()) * px}
    if shl is not None:
        sgs = gates[:, 1, :ns].sum(1).double()
        sgp = gates[:, 1, ns:].sum(1).double()
        count, applied = counts[:, 0].double(), counts[:, 1].double()
        blend = torch.where(count <= nc, count * o["corr"], fwd)
        sh_fwd = (fwd + (gs + gp) * (o["acc10"] - o["acc7"]) + o["light_ray"]
                  + shl[:, 0, 0].double() * o["pre_a"] + sgs * o["pre_b"] + npl * o["pre_plane"]
                  + applied * o["trans"] + blend + o["blend"])
        sh_bwd = (bwd + o["light_ray"] + sgs * (o["sh_vjp_sphere"] + 4 * o["block_sum"])
                  + sgp * (o["sh_vjp_plane"] + 8 * o["block_sum"]))
        work.update(sh_fwd=float(sh_fwd.sum()) * px, sh_bwd=float(sh_bwd.sum()) * px)
    return work


def hard_work(tables_bytes: int, out_bytes: int, lists, npl: int, n_shadowed: int,
              px: int = PX):
    """(bytes, operations) of one hard render launch: the tables, the list
    rows, the 8 output planes; per pixel the ray, its tile's list, the live
    planes and the shading, and one occluder test for each hit pixel whose
    colour the shadow changes."""
    per_tile = (OPS["raygen"] + lists[:, 0, 0].double() * OPS["hard_sphere"]
                + npl * OPS["hard_plane"] + OPS["hard_shade"])
    ops = px * float(per_tile.sum()) + float(n_shadowed) * OPS["hard_shadow"]
    return tables_bytes + out_bytes + list_bytes(0, lists, gate_rows=False), ops


def k6_work(tables_bytes: int, tiles: int, target_bytes: int, lists, gates, shl, counts,
            ns: int, npl: int, nc: int = 8):
    """(bytes, operations) of the shadowed fused MSE step: the tables, two
    entry offsets a tile, the target, the list rows and the partial rows;
    the shadowed forward, backward and the loss at every pixel."""
    w = soft_work(lists, gates, npl, PX, shl, counts, nc)
    nb = (tables_bytes + 2 * 4 * tiles + target_bytes
          + list_bytes(npl, lists, shl, gate_rows=False)
          + partial_bytes(gates, ns, npl, NTF_MSE, True))
    return nb, w["sh_fwd"] + w["sh_bwd"] + PX * OPS["loss"] * lists.shape[0]


def k2_work(tables_bytes: int, tiles: int, plane_px: int, lists, gates, ns: int, npl: int):
    """(bytes, operations) of the unshadowed backward: the tables, an entry
    offset a tile, the 9 saved planes and 8 cotangent planes it reads, the
    list and gate rows and the partial rows; the backward at every pixel."""
    w = soft_work(lists, gates, npl, PX)
    nb = (tables_bytes + 4 * tiles + 4 * 17 * plane_px + list_bytes(npl, lists)
          + partial_bytes(gates, ns, npl, NTF_BWD))
    return nb, w["bwd"]
