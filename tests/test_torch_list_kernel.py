"""The single-dispatch step on the CPU: the list kernel's wrappers and entry
tables (rtwc_tpu_torch/render/list_kernel.py), the capacity-sized
reduction, CapturedStep's eager form and the engine's device step.

The list kernel itself (csrc/broad_phase.cu) runs only on a card, where
`chip_smoke.py` phase 8 holds it `torch.equal` to broad_phase.py; here its
wrappers run the plain version, which tests/test_torch_pack_broadphase.py
and tests/test_torch_shadow_broadphase.py hold to the JAX package. What is
checked here: the mask-free entry tables equal the masked compaction they
replace on its first E slots with -1 after them, also on edge cases of the
scan (one tile, every row empty, every row full, a tile count that is not
a multiple of the kernel's block); the partial tables the entry tables
zero below the counts, and the reduction's indifference to anything
(NaN included) past the counts; the reduction over capacity-sized tables
with device counts is torch.equal to the reduction over the compact
tables; chip_smoke.py's grazing scenes hold the near-ties they are built
for, and there the plain lists differ from JAX's only at near-ties; the
constants and structs of the CUDA source mirror the wrappers and
broad_phase.py; the kernel's f32 constants are broad_phase.py's;
CapturedStep's eager form equals the loops it replaced in bench.py and
inverse_render.fit, and its capture key holds every parameter; the
engine's device step equals `_render_step`."""
import dataclasses
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtwc_tpu.config import RenderConfig as JaxConfig
from rtwc_tpu.render.pallas_soft import _build_tile_lists
from rtwc_tpu_torch import bench
from rtwc_tpu_torch.camera import Camera, default_camera
from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
from rtwc_tpu_torch.engine import Engine
from rtwc_tpu_torch.engine.engine import _render_step
from rtwc_tpu_torch.io import FramebufferSink
from rtwc_tpu_torch.render import broad_phase as BP
from rtwc_tpu_torch.render import list_kernel as LK
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render import shadow_kernel as SH
from rtwc_tpu_torch.render import soft_core as SC
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.render.step_graph import CapturedStep
from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene, random_scene

torch.set_num_threads(2)

SOFT = dict(soft_miss_penalty=300.0, soft_mask_k=10.0)
POSED = Camera(pos=torch.tensor([3.0, 2.0, -5.0]), rot=torch.tensor([0.25, 2.8, 0.0]))
SRC = os.path.join(os.path.dirname(LK.__file__), "..", "csrc", "broad_phase.cu")


def _slab_crowd():
    """chip_smoke.py's 40-sphere crowd: tiles list more spheres than SLAB."""
    rng = np.random.default_rng(3)
    s = empty_scene(48, 2)
    for _ in range(40):
        s = add_sphere(s, float(rng.uniform(2.0, 4.0)),
                       (float(rng.uniform(-3, 3)), float(rng.uniform(-1.5, 1.5)),
                        float(rng.uniform(20, 27))),
                       tuple(float(c) for c in rng.uniform(30, 220, 3)), speed=1.0)
    return add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)


CASES = {
    "random 12, 96x48": (lambda: random_scene(12, max_spheres=16, max_planes=4, seed=2),
                         default_camera, RenderConfig(width=96, height=48, max_spheres=16,
                                                      shadows=True, **SOFT)),
    "posed camera": (lambda: random_scene(12, max_spheres=16, max_planes=4, seed=2),
                     lambda: POSED, RenderConfig(width=96, height=48, max_spheres=16,
                                                 shadows=True, **SOFT)),
    "slab crowd": (_slab_crowd, default_camera,
                   RenderConfig(width=96, height=32, max_spheres=48, max_planes=2, shadows=True,
                                **SOFT)),
    "empty": (lambda: empty_scene(8, 2), default_camera,
              RenderConfig(width=64, height=32, max_spheres=8, shadows=True, **SOFT)),
}


def _masked_entries(lists):
    """The compaction the entry tables replace: a boolean mask of the listed
    slots (one host sync a list on the card)."""
    cnt = lists[:, 0, 0]
    offsets = (torch.cumsum(cnt, 0) - cnt).to(torch.int32)
    slot = torch.arange(lists.shape[2] - 1)[None, :] < cnt[:, None]
    return offsets, lists[:, 0, 1:][slot].to(torch.int32)


def _packed_lists(case, disable=False):
    scene_fn, cam_fn, cfg = CASES[case]
    spec = SK.SoftSpec(cfg, 0.5)
    sph, pl, cam = SK._packed(scene_fn(), cam_fn())
    lists, shl = SH.build_lists(sph, pl, cam, spec, not disable)
    return spec, sph, pl, cam, lists, shl


@pytest.mark.parametrize("disable", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_entry_tables_equal_the_masked_compaction(case, disable):
    _, sph, _, _, lists, shl = _packed_lists(case, disable)
    ent = LK.entry_tables(lists, shl)
    cap = lists.shape[0] * sph.shape[1]
    for got_off, got_idx, total, lst in ((ent.offsets, ent.pidx, ent.counts[0], lists),
                                         (ent.sh_offsets, ent.pshidx, ent.counts[1], shl)):
        off, idx = _masked_entries(lst)
        n = idx.shape[0]
        assert got_idx.shape == (cap,) and got_idx.dtype == torch.int32
        assert int(total) == n
        assert torch.equal(got_off, off) and torch.equal(got_idx[:n], idx)
        assert (got_idx[n:] == -1).all()
    view_only = LK.entry_tables(lists)
    assert view_only.sh_offsets is None and view_only.pshidx is None
    assert torch.equal(view_only.pidx, ent.pidx) and int(view_only.counts[1]) == 0


def _synthetic_lists(T, ns, fill, seed):
    """[T, 1, NS+1] i32 rows: a count, then a permutation of the spheres
    (the listed prefix first). fill: "empty", "full" or "random" counts."""
    rng = np.random.default_rng(seed)
    counts = {"empty": np.zeros(T, int), "full": np.full(T, ns),
              "random": rng.integers(0, ns + 1, T)}[fill]
    rows = np.stack([np.concatenate([[c], rng.permutation(ns)]) for c in counts])
    return torch.from_numpy(rows.astype(np.int32))[:, None, :]


EDGE = {  # (T, NS, fill): LK.ENTRY_THREADS tiles a block of the kernel's scan
    "one tile": (1, 5, "random"),
    "every row empty": (300, 6, "empty"),
    "every row full": (300, 6, "full"),
    "tiles not a multiple of the block": (LK.ENTRY_THREADS + 44, 7, "random"),
    "three blocks and a tile": (2 * LK.ENTRY_THREADS + 1, 3, "random"),
}


@pytest.mark.parametrize("shadow", [False, True])
@pytest.mark.parametrize("edge", list(EDGE))
def test_entry_tables_plain_on_the_scans_edges(edge, shadow):
    """The entry tables' plain form (what the kernel is held to on the card)
    against the masked compaction, and the partial tables zeroed below the
    counts and untouched past them, on the scan's edge cases."""
    T, ns, fill = EDGE[edge]
    lists = _synthetic_lists(T, ns, fill, 1)
    shl = _synthetic_lists(T, ns, "random" if fill == "random" else fill, 2) if shadow else None
    pvals, psh = (None if t is None else t.fill_(float("nan"))
                  for t in LK.partial_tables(lists, shl))
    ent = LK.entry_tables_plain(lists, shl, pvals, psh)
    for got_off, got_idx, total, lst, rows in ((ent.offsets, ent.pidx, ent.counts[0], lists, pvals),
                                               (ent.sh_offsets, ent.pshidx, ent.counts[1], shl,
                                                psh)):
        if lst is None:
            assert got_off is None and got_idx is None and int(total) == 0 and rows is None
            continue
        off, idx = _masked_entries(lst)
        n = idx.shape[0]
        assert int(total) == n == int(lst[:, 0, 0].sum())
        assert torch.equal(got_off, off) and torch.equal(got_idx[:n], idx)
        assert (got_idx[n:] == -1).all() and got_idx.shape == (T * ns,)
        assert (rows[:n] == 0).all() and rows[n:].isnan().all()
    assert torch.equal(LK.entry_tables(lists, shl).counts, ent.counts)  # the CPU wrapper


@pytest.mark.parametrize("case", ["slab crowd", "random 12, 96x48"])
def test_partial_tables_zeroed_below_the_counts(case):
    """The wrappers' contract: partial_tables makes the [T NS, 8] / [T NS, 4]
    tables (zeros on the CPU), entry_tables zeroes their rows below the
    counts and leaves the rest, the gradient wrappers take them (on the CPU
    they run their plain versions, equal with and without), and misshapen
    tables are refused."""
    spec, sph, pl, cam, lists, shl = _packed_lists(case)
    pvals, psh = LK.partial_tables(lists, shl)
    assert pvals.shape == (SK.capacity(lists), 8) and psh.shape == (SK.capacity(shl), 4)
    assert (pvals == 0).all() and (psh == 0).all()
    assert LK.partial_tables(lists)[1] is None
    pvals.fill_(float("nan"))
    psh.fill_(float("nan"))
    ent = LK.entry_tables(lists, shl, pvals, psh)
    n, nsh = (int(x) for x in ent.counts)
    assert (pvals[:n] == 0).all() and pvals[n:].isnan().all()
    assert (psh[:nsh] == 0).all() and psh[nsh:].isnan().all()
    tgt = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (3,) + spec.extent)
                           .astype(np.float32))
    args = (sph, pl, cam, lists, shl, ent.offsets, ent.sh_offsets, tgt)
    with_tables = SH.soft_sh_mse(*args, spec=spec, pvals=pvals, psh=psh)
    assert all(torch.equal(a, b) for a, b in zip(with_tables, SH.soft_sh_mse(*args, spec=spec)))
    with pytest.raises(ValueError):
        LK.entry_tables(lists, shl, pvals[:-1], psh)
    with pytest.raises(ValueError):
        LK.entry_tables(lists, None, pvals, psh)
    with pytest.raises(ValueError):
        LK.entry_tables(lists, shl, pvals.double(), psh)
    with pytest.raises(ValueError):
        SC.partial_rows(lists, 8, pvals[:, :4], "pvals", pvals.device)
    assert SC.partial_rows(lists, 8, pvals, "pvals", pvals.device) is pvals


@pytest.mark.parametrize("case", ["slab crowd", "random 12, 96x48"])
def test_reduction_ignores_nan_past_the_counts(case):
    """NaN in every partial row past the counts, and any index in the entry
    tables past them (the card leaves both as they were): the reduction is
    torch.equal to its result on the clean tables."""
    spec, sph, pl, cam, lists, shl = _packed_lists(case)
    ent = LK.entry_tables(lists, shl)
    n, nsh = (int(x) for x in ent.counts)
    tgt = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (3,) + spec.extent)
                           .astype(np.float32))
    pvals, psh, ppl, ptf = SH.soft_sh_mse(sph, pl, cam, lists, shl, ent.offsets, ent.sh_offsets,
                                          tgt, spec=spec)
    ns = sph.shape[1]
    want = SK.soft_grad_reduce(pvals, ent.pidx, ppl, ptf, ns, psh=psh, pshidx=ent.pshidx,
                               counts=ent.counts)
    rng = np.random.default_rng(3)
    dirty = []
    for rows, idx, k in ((pvals, ent.pidx, n), (psh, ent.pshidx, nsh)):
        rows, idx = rows.clone(), idx.clone()
        rows[k:] = float("nan")
        idx[k:] = torch.from_numpy(rng.integers(-5, ns + 5, idx.shape[0] - k).astype(np.int32))
        dirty += [rows, idx]
    got = SK.soft_grad_reduce(dirty[0], dirty[1], ppl, ptf, ns, psh=dirty[2], pshidx=dirty[3],
                              counts=ent.counts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def grazing():
    import chip_smoke as CS

    return CS, CS._grazing_scenes()


# near-ties each grazing case holds at least (chip_smoke._graze_ties, 4 float32
# steps): view / shadow pairs, dn_u corners, covered (tile, plane) pairs
GRAZE_TIES = {"grazing view cones (soft)": {"view": 30},
              "grazing view cones (hard)": {"view": 30},
              "grazing occluder balls": {"shadow": 16},
              "grazing planes (cover_lim, dn_u at +-1e-3)": {"dn_u": 3, "covered": 3}}


def _members(table, ns):
    m = torch.zeros((table.shape[0], ns + 1), dtype=torch.bool)
    slot = torch.arange(table.shape[2] - 1)[None, :] < table[:, 0, :1]
    m.scatter_(1, torch.where(slot, table[:, 0, 1:].long(), ns), slot)
    return m[:, :ns]


@pytest.mark.parametrize("label", list(GRAZE_TIES))
def test_grazing_scenes_hold_near_ties(grazing, label):
    """chip_smoke.py phase 8's grazing cases put decisions within a few
    float32 steps of their thresholds: at least GRAZE_TIES near-ties each,
    counted with the plain version. At zero pitch the plain lists differ
    from JAX's only at those near-ties (where the two float32 evaluations
    round apart): elsewhere the view lists are equal and the shadow lists a
    superset, as tests/test_torch_shadow_broadphase.py requires."""
    CS, scenes = grazing
    scene, cam, cfg, tau, hard = scenes[label]
    ties = CS._graze_ties(scene, cam, cfg, tau, hard)
    assert all(ties[k] >= v for k, v in GRAZE_TIES[label].items()), ties
    if hard:
        return
    sph, pl, camv = SK._packed(scene, cam)
    ns = sph.shape[1]
    grid = BP.tile_grid(cfg.height, cfg.width, 16, 16)
    jcfg = JaxConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jax_lists = [torch.from_numpy(np.array(t)) for t in _build_tile_lists(
        *(jnp.asarray(t.numpy()) for t in (sph, pl, camv)), jcfg, tau, 16, 16, grid, True)]
    near = []
    for step in (-4, 4):
        s = sph.clone()
        s[3] = torch.from_numpy((s[3].numpy().view(np.int32) + step).view(np.float32).copy())
        near.append([_members(t, ns) for t in BP.build_tile_lists(s, pl, camv, cfg, tau, 16, 16,
                                                                   grid, True)])
    ours = [_members(t, ns) for t in BP.build_tile_lists(sph, pl, camv, cfg, tau, 16, 16, grid,
                                                         True)]
    theirs = [_members(t, ns) for t in jax_lists]
    tie = [a != b for a, b in zip(*near)]
    assert not ((ours[0] != theirs[0]) & ~tie[0]).any()
    assert not (theirs[1] & ~ours[1] & ~tie[1]).any()


@pytest.mark.parametrize("case", ["slab crowd", "random 12, 96x48"])
def test_capacity_reduction_equals_the_compact_one(case):
    """The plain K5 / K6 partials (now sized T NS) through the plain reduction
    with the device counts, against the same partials cut to the real
    entries through the reduction as it was (every entry real): bit-equal.
    'random 12, 96x48' is the headline's shape (a random scene, a floor,
    shadows, tau 0.5) at a small size."""
    spec, sph, pl, cam, lists, shl = _packed_lists(case)
    ent = LK.entry_tables(lists, shl)
    n, nsh = (int(x) for x in ent.counts)
    out, gates = SH.soft_sh_fwd(sph, pl, cam, lists, shl, spec=spec)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(out.shape)).astype(np.float32))
    tgt = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (3,) + spec.extent)
                           .astype(np.float32))
    ns = sph.shape[1]
    for parts in (SH.soft_sh_bwd(sph, pl, cam, lists, shl, ent.offsets, ent.sh_offsets, gates,
                                 out, g, spec=spec),
                  SH.soft_sh_mse(sph, pl, cam, lists, shl, ent.offsets, ent.sh_offsets, tgt,
                                 spec=spec)):
        pvals, psh, ppl, ptf = parts
        assert pvals.shape[0] == SK.capacity(lists) and psh.shape[0] == SK.capacity(shl)
        new = SK.soft_grad_reduce(pvals, ent.pidx, ppl, ptf, ns, psh=psh, pshidx=ent.pshidx,
                                  counts=ent.counts)
        old = SK.soft_grad_reduce_plain(pvals[:n], ent.pidx[:n], ppl, ptf, ns, psh[:nsh],
                                        ent.pshidx[:nsh])
        assert all(torch.equal(a, b) for a, b in zip(new, old))


def test_reduction_reads_only_the_counted_entries():
    """Entries past the counts hold anything: the sums ignore them."""
    rng = np.random.default_rng(4)
    ns, T, cap, n = 6, 30, 500, 321
    pvals = torch.from_numpy(rng.normal(size=(cap, 8)).astype(np.float32))
    pidx = torch.from_numpy(rng.integers(0, ns, cap).astype(np.int32))
    ppl = torch.from_numpy(rng.normal(size=(T, 2, 12)).astype(np.float32))
    ptf = torch.zeros((T, SK.NTF, 2))
    counts = torch.tensor([n, 0], dtype=torch.int32)
    got = SK.soft_grad_reduce(pvals, pidx, ppl, ptf, ns, counts=counts)
    want = SK.soft_grad_reduce(pvals[:n], pidx[:n], ppl, ptf, ns)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        SK.soft_grad_reduce(pvals, pidx, ppl, ptf, ns, counts=counts.long())


def test_list_kernel_constants_mirror_the_cuda_source():
    """NB, the table rows and camera slots, the block sizes, the shared
    memory a block of the list kernel takes at MAX_SPHERES, the entry
    tables' scratch, the pre-tests' margins (powers of two), both structs'
    fields in order, and t_cap / (2 NB) as the kernel's multiply."""
    with open(SRC) as f:
        src = f.read()
    assert re.search(r"constexpr int NB = (\d+);", src).group(1) == str(BP._NB) == str(LK.NB)
    rows = dict(re.findall(r"\b([SPC]_[A-Z0-9]+) = (\d+)", src))
    for name, value in rows.items():
        assert getattr(P, name) == int(value), name
    assert len(rows) >= 20

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    for name in ("LIST_WARPS", "SPHERE_BYTES", "QUEUE", "ENTRY_THREADS", "ENTRY_MAX_BLOCKS"):
        assert const(name) == getattr(LK, name), name
    assert re.findall(r"__launch_bounds__\(([^)]+)\)", src) == [
        "LIST_WARPS * 32, LIST_MIN_BLOCKS", "ENTRY_THREADS"]
    assert re.findall(r"<<<(?:dim3\([^)]*\)|[^,]+), (\w+),", src) == ["block", "ENTRY_THREADS"]
    assert re.search(r"LIST_SMEM = (\d+) \* 1024;", src).group(1) == "227"
    # list_smem at MAX_SPHERES: the staged spheres, the warps' scratch (each
    # warp's float4s: its balls and its plane batch; its three masks and its
    # queue), over which the prologue's sort keys lie, and the block's masks
    ns, warps = LK.MAX_SPHERES, LK.LIST_WARPS
    nw = (ns + 31) // 32
    scratch = warps * (4 * (2 * LK.NB + const("PLANE_BATCH")) + 3 * nw + LK.QUEUE)
    assert LK.SPHERE_BYTES * ns + 4 * scratch + 8 * nw <= 227 * 1024
    assert scratch >= (ns + 3) & ~3
    assert "WARP_F4 = 2 * NB + PLANE_BATCH;" in src
    assert "LIST_WARPS * (4 * WARP_F4 + 3 * mask_words(ns) + QUEUE)" in src
    # the engine's scenes grow to max_grow_spheres slots, all of which the lists take
    assert LK.MAX_SPHERES >= EngineConfig().max_grow_spheres
    # the scratch: two lists' per-block totals (u64), then the epoch and block counters
    assert "status + 2 * ENTRY_MAX_BLOCKS" in src
    for name, power in (("KAPPA", -12), ("VIEW_MARGIN", -8), ("OCC_REL", -6), ("OCC_ABS", -8)):
        assert float(re.search(rf"{name} = ([0-9.]+)f;", src).group(1)) == 2.0 ** power, name
    # the reduction's warps: at most RED_WARP_CHUNKS, as reduce_params sizes them
    with open(os.path.join(os.path.dirname(SRC), "soft_render.cu")) as f:
        red = f.read()
    assert re.search(r"RED_WARP_CHUNKS = (\d+),", red).group(1) == str(SK.C.RED_WARP_CHUNKS)
    assert re.search(r"t_cap \* ([0-9.]+)f;  // t_cap / \(2 NB\)", src).group(1) == str(
        1.0 / (2 * BP._NB))
    for struct, mirror in (("ListParams", LK.ListParams), ("EntryParams", LK.EntryParams)):
        body = re.search(rf"struct {struct} \{{(.*?)\}};", src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        fields = [f.split("[")[0] for decl in body.split(";") if decl.strip()
                  for f in decl.strip().split(None, 1)[1].replace(" ", "").split(",")]
        assert fields == [name for name, _ in mirror._fields_], struct
    assert LK.MAX_SPHERES * LK.SPHERE_BYTES <= 227 * 1024


@pytest.mark.parametrize("hard", [False, True])
def test_list_params_are_the_plain_versions_f32_values(hard):
    """Each constant the kernel takes equals, in f32, the value broad_phase.py
    forms on the tables' device."""
    cfg = RenderConfig(width=1920, height=1080, shadows=True, **SOFT)
    tau = 0.0 if hard else 0.5
    prm = LK.list_params(cfg, tau, 16, 16, BP.tile_grid(1080, 1920, 16, 16), 20, 4, hard, False, 0)
    f32 = np.float32
    mp = cfg.soft_miss_penalty
    sub = (cfg.far + 16.0 * tau) / mp
    r_scale = 1.0 if hard else float(BP._f32_sqrt(1.0 + sub))
    assert prm.r_scale == r_scale and prm.reach == f32(0.0 if hard else sub)
    assert prm.r_scale40 == float(BP._f32_sqrt(1.0 + (cfg.far + 40.0 * tau) / mp))
    assert prm.keep_s == float(BP._f32_sqrt(1.0 + 16.0 / cfg.soft_shadow_k))
    assert prm.inv_h == f32(1.0) / f32(1080) and prm.inv_w == f32(1.0) / f32(1920)
    assert prm.inv_k == f32(1.0) / f32(cfg.soft_mask_k)
    assert prm.cover_lim == f32(cfg.far - 16.0 * tau - 1.0) and (prm.ti, prm.tj) == (68, 120)
    assert list(prm.light) == [float(f32(v)) for v in cfg.light_pos]


def test_list_wrappers_run_the_plain_version_on_the_cpu():
    _, sph, pl, cam, lists, shl = _packed_lists("posed camera")
    cfg = CASES["posed camera"][2]
    grid = BP.tile_grid(cfg.height, cfg.width, 16, 16)
    got = LK.tile_lists_with_aux(sph, pl, cam, cfg, 0.5, 16, 16, grid, True)
    want_lists, want_aux = BP.sphere_tile_lists(sph, cam, cfg, 0.5, 16, 16, grid)
    assert torch.equal(got[0], lists) and torch.equal(got[0], want_lists)
    assert torch.equal(got[1], shl) and all(torch.equal(a, b) for a, b in zip(got[2], want_aux))
    hard = LK.sphere_tile_lists(sph, cam, cfg, 0.0, 16, 16, grid, hard=True)
    assert torch.equal(hard[0], BP.sphere_tile_lists(sph, cam, cfg, 0.0, 16, 16, grid,
                                                     hard=True)[0])
    with pytest.raises(ValueError):
        LK._launch_lists(sph, pl, cam, cfg, 0.5, 16, 16, grid, True, False, False)  # no card


def _old_train_step(cfg, scene, camera, target, fused):
    """bench.train_step as it was: Adam on every float leaf, eager."""
    leaves, rebuild = bench._leaves(scene, camera)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    loss_of = bench._loss(cfg, target, fused, True, True)

    def step():
        loss = loss_of(*rebuild())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss
    return step, leaves


@pytest.mark.parametrize("fused", [True, False])
def test_captured_step_eager_form_equals_the_old_train_step(fused):
    cfg = RenderConfig(width=64, height=32, max_spheres=8, max_planes=2, shadows=True, **SOFT)
    scene = random_scene(6, max_spheres=8, max_planes=2, seed=3)
    cam = default_camera()
    target = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (32, 64, 3))
                              .astype(np.float32))
    old, old_leaves = _old_train_step(cfg, scene, cam, target, fused)
    new = bench.train_step(cfg, scene, cam, target, fused=fused)
    assert isinstance(new, CapturedStep) and not new.graph
    for _ in range(3):
        assert torch.equal(old().detach(), new())
    new_leaves = new.opt.param_groups[0]["params"]
    assert len(new_leaves) == len(old_leaves)
    assert all(torch.equal(a, b) for a, b in zip(old_leaves, new_leaves))


def test_captured_step_needs_a_card():
    p = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError):
        CapturedStep(lambda: (p * p).sum(), torch.optim.Adam([p]), graph=True)
    with pytest.raises(ValueError):
        Engine(RenderConfig(width=40, height=24), presenter=FramebufferSink(),
               interactive=False, device="cpu", graph=True)


@pytest.mark.parametrize("capturable", [True, False])
def test_captured_step_puts_only_a_capturable_update_in_the_graph(capturable):
    """A capturable optimiser's update is captured; torch's default Adam
    steps after each replay."""
    p = torch.zeros(3, requires_grad=True)
    step = CapturedStep(lambda: (p * p).sum(),
                        torch.optim.Adam([p], capturable=capturable), graph=False)
    assert step.in_graph == capturable


def test_captured_step_key_holds_every_parameter():
    """A new config key, or a parameter of another shape, dtype or storage,
    gives another capture key, so the step re-captures."""
    a, b = torch.zeros(3, requires_grad=True), torch.zeros(2, 2, requires_grad=True)
    opt = torch.optim.Adam([a, b])
    step = CapturedStep(lambda: (a * a).sum() + b.sum(), opt, graph=False)
    k = step.capture_key("cfg")
    assert k == step.capture_key("cfg") and k != step.capture_key("other")
    for new in (torch.zeros(4), torch.zeros(3, dtype=torch.float64), torch.zeros(3)):
        step.params[0] = new.requires_grad_(True)
        assert step.capture_key("cfg") != k


def test_fit_graph_false_equals_the_eager_fit_loop():
    """inverse_render.fit through CapturedStep's eager form equals the loop
    it replaced (torch's default Adam, a cosine LambdaLR), loss for loss and
    bit for bit: the captured fit rounds as the eager one."""
    from rtwc_tpu_torch.examples import inverse_render as IR

    cfg, scene = IR.build(32, 16, 3)
    cam = default_camera()
    stages = [(2.0, cfg), (0.5, cfg)]
    tgt, tgt_a = IR.make_target(scene, cam, stages[-1], False)
    start = scene.spheres.center + 0.3

    def args_of(c):
        return lambda: (scene.replace(spheres=scene.spheres.replace(center=c)), cam)

    c_new = start.clone().requires_grad_(True)
    loss_new, log_new = IR.fit(args_of(c_new), [c_new], stages, 5, 3e-2, tgt, tgt_a, 1.0,
                               False, graph=False)
    c_old = start.clone().requires_grad_(True)
    opt = torch.optim.Adam([c_old], lr=3e-2)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: 0.5 * (1.0 + math.cos(math.pi * min(i, 5) / 5)))
    losses = []
    for (tau, cfg_i), n, ws in zip(stages, (3, 2), (1.0, 0.0)):
        for _ in range(n):
            s, cm = args_of(c_old)()
            fb = IR.render_frame_soft_kernel(s, cm, cfg_i, tau=tau)
            loss = IR.loss_of(fb, tgt, tgt_a, ws, False)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            sched.step()
        losses.append(float(loss.detach()))
    assert [e["loss"] for e in log_new] == losses and loss_new == losses[-1]
    assert torch.equal(c_new, c_old)


def test_engine_device_step_equals_render_step():
    """The engine's frames (the packed camera and a tensor dt, the display
    graph's inputs) against _render_step's on the same scene and camera,
    cell for cell, through a spawn that doubles the capacity."""
    rcfg = RenderConfig(width=48, height=24, mode=RenderMode.RGB_ASCII, max_spheres=4,
                        shadows=True, supersample=2)
    eng = Engine(rcfg, EngineConfig(spawn=False, show_fps=False, seed=1),
                 presenter=FramebufferSink(), interactive=False, device="cpu")
    assert eng.display is None
    scene = eng.scene
    for i in range(4):
        if i == 2:
            eng._spawn()
            assert eng.scene.spheres.capacity == 2 * scene.spheres.capacity
            scene = eng.scene
        frame = eng.device_frame(0.05)
        assert frame.stream is None  # cells on the host: the host encodes them
        cells = frame.cells
        scene, want = _render_step(scene, eng.camera, 0.05, rcfg)
        assert all(torch.equal(a, b) for a, b in zip(cells, want)), i
        assert torch.equal(eng.scene.spheres.center, scene.spheres.center)


def test_fit_learning_rates_follow_the_cosine_schedule(monkeypatch):
    """inverse_render.fit sets step i's rate to LambdaLR's value for the
    same cosine decay."""
    from rtwc_tpu_torch.examples import inverse_render as IR

    seen = []
    orig = torch.optim.Adam.step

    def spy(self, *a, **kw):
        seen.append(self.param_groups[0]["lr"])
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.optim.Adam, "step", spy)
    cfg, scene = IR.build(32, 16, 3)
    c = scene.spheres.center.clone().requires_grad_(True)
    stages = [(2.0, cfg), (0.5, cfg)]
    tgt = torch.zeros((16, 32, 3))
    IR.fit(lambda: (scene.replace(spheres=scene.spheres.replace(center=c)), default_camera()),
           [c], stages, 5, 3e-2, tgt, torch.zeros((16, 32)), 1.0, False)
    ref = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=3e-2)
    sched = torch.optim.lr_scheduler.LambdaLR(
        ref, lambda i: 0.5 * (1.0 + math.cos(math.pi * min(i, 5) / 5)))
    want = []
    for _ in range(5):
        want.append(ref.param_groups[0]["lr"])
        sched.step()
    assert seen == want


def test_update_scene_takes_a_tensor_dt():
    scene = random_scene(6, max_spheres=8, seed=1)
    a = scene
    b = scene
    from rtwc_tpu_torch.scene import update_scene
    for _ in range(3):
        a = update_scene(a, 0.3)
        b = update_scene(b, torch.full((1,), np.float32(0.3)))
    assert all(torch.equal(getattr(a.spheres, f.name), getattr(b.spheres, f.name))
               for f in dataclasses.fields(a.spheres))
    with pytest.raises(ValueError):
        update_scene(scene, torch.full((2,), 0.3))
