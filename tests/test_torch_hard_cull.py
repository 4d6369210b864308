"""K7's shadow cull on the CPU (the kernel's plain version, which the CUDA
kernel equals bit for bit on the card: chip_smoke.py phase 2).

Each warp of a K7 block tests each live sphere against the hull of its
hit points' box and the light, and its pixels' shadow rays sweep only the
spheres it admits (every live sphere past the occluder list's capacity). The shadow
test is a boolean any-hit, so a sound cull changes no bit: here the plain
K7 with the cull is torch.equal to the plain K7 with every sphere
admitted, on chip_smoke.py's cull cases (grazing occluders, shadow origins
inside a sphere, the light inside a warp's hull, occluders behind the
light, a clump past the staging and occluder capacities, the engine's
grown scene); the hull test admits every sphere that blocks any hit pixel
of its warp in the full sweep, on seeded random scenes and on spheres
placed tangent to shadow rays; and the plain K7 still matches JAX
`render_frame_pallas` (interpret mode) with shadows, within
tests/test_torch_render.py's tolerance."""
import numpy as np
import pytest
import torch

import chip_smoke as CS
import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.render import reference as JR
from rtwc_tpu.render.pallas_kernel import render_frame_pallas
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import hard_kernel as HK
from rtwc_tpu_torch.render import pack as TP
from test_torch_render import CFG, compare_fb, shadow_flips

torch.set_num_threads(2)

W, H = 128, 48
CULLED = HK.shadow_occluders
CULL_CASES = sorted(CS._cull_scenes(W, H)) + ["the engine's grown scene"]


def _args(scene, cfg, cam=None):
    sph, pl, counts = TP.pack_scene(scene)
    camv = TP.pack_camera(cam if cam is not None else TC.default_camera())
    return (sph, pl, counts.reshape(1, 2), camv, HK.tile_lists(sph, camv, cfg, 16, 16))


def _case(label):
    if label == "the engine's grown scene":
        return CS._grown_scene("cpu", W, H), RenderConfig(width=W, height=H, shadows=True)
    return CS._cull_scenes(W, H)[label]


def _admit_all(p3, hit, sph, n_sph, light, bh, bw):
    admit, count, any_hit = CULLED(p3, hit, sph, n_sph, light, bh, bw)
    return torch.ones_like(admit), count, any_hit


def _full_sweep(args, cfg, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(HK, "shadow_occluders", _admit_all)
        return HK.hard_render_plain(*args, config=cfg, bh=16, bw=16)


@pytest.mark.parametrize("label", CULL_CASES)
def test_culled_shadows_equal_the_full_sweep(label, monkeypatch):
    scene, cfg = _case(label)
    args = _args(scene, cfg)
    stats = CS._cull_stats(HK, args, cfg)
    culled = HK.hard_render_packed(*args, config=cfg, bh=16, bw=16)
    assert torch.equal(culled, _full_sweep(args, cfg, monkeypatch))
    # each case reaches what it is named for
    assert stats["warps_with_a_hit"] > 0
    if label.startswith("a clump"):
        assert stats["full_sweep_warps"] > 0 and stats["longest_list"] > HK.MAX_THREADS
    else:
        assert stats["mean_admitted"] < stats["live_spheres"], stats
        assert stats["full_sweep_warps"] == 0
    if label.startswith("the light inside"):
        assert stats["warps_holding_the_light"] > 0
    # shadows are cast: some hit pixel differs from the unshadowed render
    plain_lit = HK.hard_render_plain(*args, config=cfg.replace(shadows=False), bh=16, bw=16)
    assert not torch.equal(culled[:3], plain_lit[:3])


def _blockers(args, cfg):
    """[Hp, Wp, n_sph] bool: sphere k blocks pixel p's shadow ray in the
    full sweep (a hit pixel, the kernel's sphere test, t < |light - p|)."""
    sph, pl, counts, cam, lists = args
    o3, d3, t_best, _, _ = HK._trace(sph, pl, counts, cam, lists, cfg, 16, 16, None)
    p3, l3, d2 = HK._light(cfg, o3, d3, t_best)
    so3 = tuple(p + ld * HK.SHADOW_BIAS for p, ld in zip(p3, l3))
    dist = torch.sqrt(d2)
    out = []
    for k in range(int(counts[0, 0])):
        t, valid = HK._sphere_t(sph[TP.S_CX, k], sph[TP.S_CY, k], sph[TP.S_CZ, k],
                                sph[TP.S_R, k], so3, l3)
        out.append(valid & (t < dist) & (t < HK.MISS_DISTANCE) & (t_best < HK.MISS_DISTANCE))
    return torch.stack(out, -1), p3, t_best < HK.MISS_DISTANCE


def _random_scene(rng):
    """Spheres between the floor and a light placed anywhere above or among
    them, some made tangent to the shadow ray of a floor point."""
    s = TS.empty_scene(40, 2)
    light = np.array([rng.uniform(-15, 15), rng.uniform(2, 60), rng.uniform(0, 50)])
    for _ in range(int(rng.integers(8, 24))):
        s = TS.add_sphere(s, float(rng.uniform(0.3, 4.0)),
                          (rng.uniform(-12, 12), rng.uniform(-2, 18), rng.uniform(12, 50)),
                          tuple(rng.uniform(30, 220, 3)), speed=1.0)
    for _ in range(8):
        p = np.array([rng.uniform(-8, 8), -3.0, rng.uniform(15, 45)])
        l_dir = (light - p) / np.linalg.norm(light - p)
        n = np.cross(l_dir, rng.normal(size=3))
        r = rng.uniform(0.2, 3.0)
        s = TS.add_sphere(s, float(r), tuple(p + l_dir * rng.uniform(0.5, 10.0)
                                             + n / np.linalg.norm(n) * r * (1 + 1e-7)),
                          (200.0, 200.0, 200.0), speed=1.0)
    s = TS.add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 80.0, 80.0)
    return s, RenderConfig(width=96, height=48, shadows=True, light_pos=tuple(light))


@pytest.mark.parametrize("seed", range(4))
def test_hull_admits_every_blocking_sphere(seed):
    rng = np.random.default_rng(seed)
    blocking = culled_out = 0
    for _ in range(6):
        scene, cfg = _random_scene(rng)
        args = _args(scene, cfg)
        block, p3, hit = _blockers(args, cfg)
        admit, count, _ = HK.shadow_occluders(p3, hit, args[0], block.shape[-1], cfg.light_pos,
                                              16, 16)
        assert (count <= HK.OCC_CAP).all()
        warp = HK._by_warp(torch.arange(hit.numel()).reshape(hit.shape), 16, 16)
        per_warp = block.reshape(-1, block.shape[-1])[warp].any(1)  # [G, n_sph]
        assert not (per_warp & ~admit).any(), "the cull dropped a blocking sphere"
        blocking += int(per_warp.sum())
        culled_out += int((~admit).sum())
    assert blocking > 0 and culled_out > 0  # the scenes cast shadows and the cull culls


@pytest.mark.parametrize("n,seed", [(10, 3), (20, 2)], ids=["10_spheres", "20_spheres"])
def test_culled_kernel_path_matches_jax_pallas(n, seed):
    cfg = CFG.replace(shadows=True)
    jscene = JS.random_scene(n, 1, max_spheres=32, max_planes=4, seed=seed)
    jcam = JC.default_camera()
    fb = HK.render_frame_kernel(TS.scene_from_numpy(jscene), TC.camera_from_numpy(jcam), cfg)
    ref = JR.render_frame(jscene, jcam, cfg)
    compare_fb(render_frame_pallas(jscene, jcam, cfg), fb, shadow_flips(jscene, jcam, cfg, ref))


def test_cull_constants_match_the_cuda_source():
    """The plain cull reads OCC_CAP, CULL_REL, CULL_ABS, SHADOW_BIAS and the
    largest block from hard_kernel; the kernel from csrc/hard_render.cu."""
    import os
    import re

    with open(os.path.join(os.path.dirname(HK.__file__), "..", "csrc", "hard_render.cu")) as f:
        src = f.read()
    assert re.search(r"constexpr int K7_THREADS = (\d+);", src).group(1) == str(HK.MAX_THREADS)
    assert re.search(r"constexpr int OCC_CAP = (\d+);", src).group(1) == str(HK.OCC_CAP)
    rel, abs_ = re.search(r"constexpr float CULL_REL = ([\d.e-]+)f, CULL_ABS = ([\d.e-]+)f;",
                          src).groups()
    assert (float(rel), float(abs_)) == (HK.CULL_REL, HK.CULL_ABS)
    bias = re.search(r"constexpr float SHADOW_BIAS = ([\d.e-]+)f;", src).group(1)
    assert float(bias) == HK.SHADOW_BIAS
    assert "__launch_bounds__(K7_THREADS, K7_MIN_BLOCKS)\nhard_render_kernel(" in src


def test_bound_charges_one_shadow_test_a_shadowed_pixel():
    """chip_smoke.py's K7 bound counts what the inputs need: the shadowed
    render costs one occluder test more for each hit pixel whose colour
    the shadow changes, and nothing for lit or missed pixels."""
    scene, cfg = CS._cull_scenes(W, H)["grazing occluders"]
    args = _args(scene, cfg)
    nbytes, ops = CS._hard_work(HK, args, cfg)
    nbytes_lit, ops_lit = CS._hard_work(HK, args, cfg.replace(shadows=False))
    shaded = HK.hard_render_plain(*args, config=cfg, bh=16, bw=16)
    lit = HK.hard_render_plain(*args, config=cfg.replace(shadows=False), bh=16, bw=16)
    shadowed = int(((shaded[:3] != lit[:3]).any(0) & (shaded[3] < HK.MISS_DISTANCE)).sum())
    assert 0 < shadowed < int((shaded[3] < HK.MISS_DISTANCE).sum())
    assert ops - ops_lit == shadowed * CS.OPS["hard_shadow"]
    assert nbytes == nbytes_lit == sum(t.numel() * 4 for t in args[:4] + (shaded,)) + 4 * int(
        args[4][:, 0, 0].sum() + args[4].shape[0])
