"""The frozen work counts against chip_smoke.py's on the same inputs and
tiles, the frozen broad phase against the port's, and the gates the
harness counts against the gates the port's plain kernels take."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from portbench.reference import broad, scenes, soft
from portbench.reference import camera as rcam
from portbench.reference import work as W
from portbench.reference.config import Render


def _setup(shadows: bool, width=64, height=40, n=10, seed=3, pitch=30.0):
    from rtwc_tpu_torch.camera import Camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.render import pack as P
    from portbench.drivers.common import port_scene

    port_cfg = RenderConfig(width=width, height=height, shadows=shadows, max_spheres=12,
                            max_planes=2, soft_miss_penalty=300.0, soft_mask_k=10.0)
    d = {f: getattr(port_cfg, f) for f in port_cfg.__dataclass_fields__}
    d["mode"] = port_cfg.mode.value
    cfg = Render.from_dict(d)
    s = scenes.random_scene(n, 1, 12, 2, seed, spread=15.0)
    pos, rot = rcam.default_pose()
    rot = rcam.add_rot(rot, pitch, 20.0, 0.002)
    scene = port_scene(s, "cpu")
    cam = Camera(pos=torch.from_numpy(pos), rot=torch.from_numpy(rot))
    sph, pl, counts = P.pack_scene(scene)
    camv = P.with_counts(P.pack_camera(cam), counts)
    return port_cfg, cfg, s, pos, rot, sph, pl, counts, camv


def _cols(rot):
    r, u, f = rcam.basis(torch.from_numpy(rot))
    return tuple(torch.stack([r[i], u[i], f[i]]) for i in range(3))


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("pitch", [0.0, 60.0])
def test_frozen_broad_phase_equals_the_port(hard, pitch):
    from rtwc_tpu_torch.render import broad_phase as BP

    port_cfg, cfg, s, pos, rot, sph, pl, counts, camv = _setup(False, pitch=pitch)
    tau = 0.0 if hard else 0.5
    theirs, _ = BP.sphere_tile_lists(sph, camv, port_cfg, tau, 16, 16,
                                     BP.tile_grid(cfg.height, cfg.width, 16, 16), hard=hard)
    sp = {k: torch.from_numpy(s["spheres"][k]) for k in ("center", "radius", "active")}
    e1, e2 = rcam.projection_elements(cfg)
    mine = broad.sphere_lists(sp["center"], sp["radius"], sp["active"], torch.from_numpy(pos),
                              _cols(rot), cfg, e1, e2, tau=tau, hard=hard)
    n = theirs[:, 0, 0]
    assert torch.equal(mine[:, 0, 0], n)
    for t in range(n.shape[0]):
        assert torch.equal(mine[t, 0, 1:1 + n[t]], theirs[t, 0, 1:1 + n[t]])


def test_soft_work_equals_chip_smoke():
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.render.soft_core import SoftSpec

    port_cfg, cfg, s, pos, rot, sph, pl, counts, camv = _setup(True)
    spec = SoftSpec(port_cfg, 0.5)
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    _, gates, cnt = SH.soft_sh_stats_plain(sph, pl, camv, lists, shl, spec=spec)
    npl = int(counts[1])
    assert W.soft_work(lists, gates, npl, W.PX, shl, cnt, SH.NC) == chip_smoke._soft_work(
        lists, gates, npl, W.PX, shl, cnt, SH.NC)
    _, g0 = SK.soft_fwd_plain(sph, pl, camv, lists, spec=spec)
    assert W.soft_work(lists, g0, npl, W.PX) == chip_smoke._soft_work(lists, g0, npl, W.PX)
    for shadowed, ntf in ((True, 13), (False, 12)):
        assert W.partial_bytes(gates, sph.shape[1], npl, ntf, shadowed) == \
            chip_smoke._partial_bytes(gates, sph.shape[1], npl, ntf, shadowed)
    assert W.list_bytes(npl, lists, shl, gate_rows=False) == chip_smoke._list_bytes(
        npl, lists, shl, gate_rows=False)
    ms, by = W.bound_ms(1e6, 1e9)
    assert (ms, by) == chip_smoke._bound(1e6, 1e9)


@pytest.mark.parametrize("shadows", [False, True])
def test_hard_work_equals_chip_smoke(shadows):
    from rtwc_tpu_torch.render import hard_kernel as HK

    port_cfg, cfg, s, pos, rot, sph, pl, counts, camv = _setup(shadows)
    lists = HK.tile_lists(sph, camv, port_cfg, 16, 16)
    args = (sph, pl, counts.reshape(1, 2), camv, lists)
    theirs = chip_smoke._hard_work(HK, args, port_cfg)
    out = HK.hard_render_plain(*args, config=port_cfg, bh=16, bw=16)
    lit = HK.hard_render_plain(*args, config=port_cfg.replace(shadows=False), bh=16, bw=16)
    n_sh = int(((out[:3] != lit[:3]).any(0) & (out[3] < HK.MISS_DISTANCE)).sum()) if shadows else 0
    tables = W.nbytes(sph, pl, counts.reshape(1, 2), camv)
    mine = W.hard_work(tables, W.nbytes(out), lists, int(counts[1]), n_sh)
    assert mine == theirs


@pytest.mark.parametrize("shadows", [False, True])
def test_counted_gates_are_a_subset_of_the_kernels(shadows):
    """The gates the harness counts (objects the reference's weights need)
    are a subset of those the port's plain kernel takes: the count is a
    lower bound on its work."""
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.render.soft_core import SoftSpec

    port_cfg, cfg, s, pos, rot, sph, pl, counts, camv = _setup(shadows)
    spec = SoftSpec(port_cfg, 0.5)
    if shadows:
        lists, shl = SH.build_lists(sph, pl, camv, spec, True)
        _, gates, _ = SH.soft_sh_stats_plain(sph, pl, camv, lists, shl, spec=spec)
    else:
        lists = SK.build_lists(sph, camv, spec, True)
        _, gates = SK.soft_fwd_plain(sph, pl, camv, lists, spec=spec)
    lv = soft.leaves(s, pos, rot, "cpu", torch.float32, ())
    mine = soft.needed_gates(lv, cfg, 0.5, lists)
    ns = sph.shape[1]
    # the port packs live objects first; the harness's scene keeps them there too
    assert np.all(mine[:, 0].numpy() <= gates[:, 0].numpy())
    assert int(mine[:, 0, :ns].sum()) > 0
    assert int(mine[:, 1].sum()) == 0


def test_k6_and_k2_work_equal_chip_smoke():
    """The frozen K6 and K2 totals against chip_smoke.py's kernels-line
    formulas, on the port's plain lists, gates, entry tables and planes."""
    from rtwc_tpu_torch.render import list_kernel as LK
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.render.soft_core import SoftSpec

    cs = chip_smoke
    port_cfg, cfg, s, pos, rot, sph, pl, counts, camv = _setup(True)
    spec = SoftSpec(port_cfg, 0.5)
    ns, npl, px = sph.shape[1], int(counts[1]), W.PX
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    _, gates, cnt = SH.soft_sh_stats_plain(sph, pl, camv, lists, shl, spec=spec)
    ent = LK.entry_tables_plain(lists, shl)
    Hp, Wp = spec.extent
    tgt = torch.zeros((3, Hp, Wp), dtype=torch.float32)
    w = cs._soft_work(lists, gates, npl, px, shl, cnt, SH.NC)
    theirs = (cs._nbytes(sph, pl, camv, ent.offsets, ent.sh_offsets, tgt)
              + cs._list_bytes(npl, lists, shl, gate_rows=False)
              + cs._partial_bytes(gates, ns, npl, 13, True),
              w["sh_fwd"] + w["sh_bwd"] + px * W.OPS["loss"] * lists.shape[0])
    T = lists.shape[0]
    assert ent.offsets.numel() == ent.sh_offsets.numel() == T
    mine = W.k6_work(W.nbytes(sph, pl, camv), T, W.nbytes(tgt), lists, gates, shl, cnt, ns, npl,
                     SH.NC)
    assert mine == theirs

    port_cfg, cfg, s, pos, rot, sph, pl, counts, camv = _setup(False)
    spec = SoftSpec(port_cfg, 0.5)
    lists = SK.build_lists(sph, camv, spec, True)
    out, gates = SK.soft_fwd_plain(sph, pl, camv, lists, spec=spec)
    ent = LK.entry_tables_plain(lists)
    g = torch.zeros((8,) + out.shape[1:], dtype=torch.float32)
    w = cs._soft_work(lists, gates, npl, px)
    theirs = (cs._nbytes(sph, pl, camv, ent.offsets, out[:7], out[8:10], g)
              + cs._list_bytes(npl, lists) + cs._partial_bytes(gates, ns, npl, 12), w["bwd"])
    mine = W.k2_work(W.nbytes(sph, pl, camv), lists.shape[0], out[0].numel(), lists, gates, ns,
                     npl)
    assert mine == theirs


def test_a_split_kernel_reads_the_same_share():
    """A layer's kernel split into two launches a step, or renamed into
    two kernels the metric's patterns both take, reads the same share as
    one launch of the summed time: the share divides the frozen work a
    step by the summed device time a step."""
    from portbench.readers import roofline

    ms = 1_000_000
    one = [("void soft_sh_mse_kernel<2>(P)", "kernel", (10 * i) * ms, 4 * ms) for i in range(3)]
    two = [e for i in range(3) for e in (
        ("void soft_sh_mse_kernel<2>(P)", "kernel", (10 * i) * ms, 1 * ms),
        ("void soft_sh_mse_bwd_kernel(P)", "kernel", (10 * i + 2) * ms, 3 * ms))]
    ctx = {"units": 3, "work": {"k6": (3.35e12 * 1e-3, 0.0)}}     # 1 ms of bytes a step
    params = {"include": ["soft_sh_mse*"], "work": "k6"}
    shares = [roofline.read({"device": d, "spans": [("window", 0, 40 * ms)]}, ctx, params)
              for d in (one, two)]
    assert shares[0] == pytest.approx(25.0) and shares[1] == pytest.approx(shares[0])
