"""The port's shadow broad phase (render/broad_phase.py: plane_depth_bounds,
shadow_tile_lists, build_tile_lists) against the JAX package's
`_build_tile_lists` (rtwc_tpu/render/pallas_soft.py:769-982), and its
soundness.

- At zero pitch, on the same tile shape, the view lists are equal and every
  tile's shadow list is a superset of JAX's: the port bounds the plane
  depths soundly over the whole tile where JAX uses corner values (ROADMAP
  queue 3), which can only widen the hull.
- With and without pitch, every occluder the port leaves out of a tile's
  list blocks less than 1e-7 of the light at every pixel of the tile, at the
  hit point the shadowed forward actually uses (the blended depth): the
  mirror of tests/test_pallas_soft.py's
  test_depth_bounded_shadow_lists_conservative, checked pixel by pixel. The
  one exception is by design (pallas_soft.py:930-935): a tile certified as
  sky (no object above softmin weight e^-40) gets no occluders, since
  there the light's visibility cannot move the image; such pixels must
  show alpha and d(rgb)/d(vis) of 0.

(tests/test_pallas_soft.py's own exclusion assertion names sphere slot 3,
an inactive slot of its 3-object scene, so it holds for any list; the
scene here adds occluders that no tile's hull reaches and asserts that
they are left out.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import pack as JP
from rtwc_tpu.render.pallas_soft import C_NPL, C_NSPH, _build_tile_lists, _pick_tiles
from rtwc_tpu_torch.render import pack as TP
from rtwc_tpu_torch.render import shadow_kernel as SH
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.broad_phase import build_tile_lists, tile_grid

torch.set_num_threads(2)

CFG = RenderConfig(width=96, height=32, max_spheres=24, max_planes=4, soft_miss_penalty=300.0,
                   soft_mask_k=10.0, shadows=True)
TAU = 0.5
CAMERAS = {
    "level": JC.default_camera(),
    "posed": JC.Camera(pos=jnp.asarray([1.0, 2.0, -4.0], jnp.float32),
                       rot=jnp.asarray([0.2, 3.0, 0.0], jnp.float32)),
    "pitched down": JC.Camera(pos=jnp.asarray([0.0, 4.0, 0.0], jnp.float32),
                              rot=jnp.asarray([0.3, 0.0, 0.0], jnp.float32)),
}


def _far_occluder_scene():
    """tests/test_pallas_soft.py:434-439 (the 96x32 scene with an occluder
    and one beyond every hit depth), plus two occluders off to the side of
    and behind the camera, which no tile's hull reaches."""
    s = JS.empty_scene(CFG.max_spheres, CFG.max_planes)
    s = JS.add_sphere(s, 5.0, (0.0, 1.0, 20.0), (200.0, 40.0, 40.0), speed=1.0)
    s = JS.add_sphere(s, 3.0, (-4.0, -1.0, 28.0), (40.0, 200.0, 40.0), speed=1.0)
    s = JS.add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)
    s = JS.add_sphere(s, 3.0, (-2.0, 8.0, 22.0), (40.0, 40.0, 200.0), speed=1.0)
    s = JS.add_sphere(s, 2.0, (0.0, 20.0, 80.0), (90.0, 90.0, 90.0), speed=1.0)
    s = JS.add_sphere(s, 2.0, (-60.0, 10.0, 10.0), (90.0, 90.0, 90.0), speed=1.0)
    return JS.add_sphere(s, 2.0, (0.0, 10.0, -40.0), (90.0, 90.0, 90.0), speed=1.0)


SCENES = {
    "far occluder": lambda: _far_occluder_scene(),
    "random 24 seed 0": lambda: JS.random_scene(24, max_spheres=24, max_planes=4, seed=0),
    "random 24 seed 7": lambda: JS.random_scene(24, max_spheres=24, max_planes=4, seed=7),
}


def _jax_tables(scene, cam, cfg, bh, bw):
    sph, pl, counts = JP.pack_scene(scene)
    camv = JP.pack_camera(cam)
    camv = camv.at[0, C_NSPH].set(counts[0].astype(jnp.float32))
    camv = camv.at[0, C_NPL].set(counts[1].astype(jnp.float32))
    grid = tile_grid(cfg.height, cfg.width, bh, bw)
    return (sph, pl, camv), grid


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("tiles", ["jax", "16x16"])
def test_shadow_lists_superset_of_jax_at_zero_pitch(name, tiles):
    cfg = CFG.replace(far=100.0) if name == "far occluder" else CFG
    bh, bw = _pick_tiles(cfg, None, None) if tiles == "jax" else (16, 16)
    scene, cam = SCENES[name](), JC.default_camera()
    (sph, pl, camv), grid = _jax_tables(scene, cam, cfg, bh, bw)
    jl, jsh = (np.asarray(t) for t in _build_tile_lists(sph, pl, camv, cfg, TAU, bh, bw, grid,
                                                          True))
    tl, tsh = (t.numpy() for t in build_tile_lists(
        torch.from_numpy(np.asarray(sph)), torch.from_numpy(np.asarray(pl)),
        torch.from_numpy(np.asarray(camv)), cfg, TAU, bh, bw, grid, True))
    np.testing.assert_array_equal(tl, jl)
    extra = 0
    for t in range(jsh.shape[0]):
        want = set(jsh[t, 0, 1:1 + jsh[t, 0, 0]].tolist())
        got = set(tsh[t, 0, 1:1 + tsh[t, 0, 0]].tolist())
        assert want <= got, (t, want - got)
        extra += len(got - want)
        assert tsh[t, 0, 1:1 + tsh[t, 0, 0]].tolist() == sorted(got)  # index order
    assert tsh[:, 0, 0].sum() >= 1
    # the sound bound widens the hull only a little
    assert extra <= 0.25 * max(1, int(jsh[:, 0, 0].sum()))


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("view", list(CAMERAS))
def test_excluded_occluders_do_not_block(name, view):
    _check_excluded(name, view)


@pytest.mark.parametrize("name", list(SCENES))
def test_excluded_occluders_do_not_block_in_a_band(name):
    """The same for a band of the tile sharding (dist/mesh.py) that starts
    and ends inside a 16-row tile: the hull's depth bounds follow the
    band's own tiles."""
    _check_excluded(name, "posed", band=(8, 20))


def _check_excluded(name, view, band=None):
    cfg = CFG.replace(far=100.0) if name == "far occluder" else CFG
    ts = TS.scene_from_numpy(SCENES[name]())
    tc = TC.camera_from_numpy(CAMERAS[view])
    spec = SK.SoftSpec(cfg, TAU, band_h=band and band[1])
    sph, pl, cam = SK._packed(ts, tc)
    if band:
        cam = SK._at_row(cam, band[0])
    lists, shl = SH.build_lists(sph, pl, cam, spec, True)
    out, _ = SH.soft_sh_fwd(sph, pl, cam, lists, shl, spec=spec)
    c = spec.consts
    Hp, Wp = spec.extent
    ray, tile = SK._ray_planes(c, cam, Hp, Wp, spec.bh, spec.bw)
    depth = out[SK.SO_DEPTH]
    o = cam[0, :3]
    lr = O.light_ray(c, o[0] + ray[0] * depth, o[1] + ray[1] * depth, o[2] + ray[2] * depth)
    n_sph = int(cam[0, TP.C_NSPH].item())
    listed = torch.zeros((lists.shape[0], sph.shape[1]), dtype=torch.bool)
    for t in range(lists.shape[0]):
        listed[t, shl[t, 0, 1:1 + shl[t, 0, 0]].long()] = True
    excluded = 0
    for k in range(n_sph):
        _, args = O.shadow_sphere_pre(c, sph[0, k], sph[1, k], sph[2, k], sph[3, k], lr)
        out_of_list = ~listed[:, k][tile]
        excluded += int(out_of_list.any())
        blocks = out_of_list & (O.blocked(c, args) >= 1e-7)
        sky = (out[SK.SO_ALPHA] == 0.0) & (out[SH.SO_DVR:SH.SO_DVB + 1].abs().amax(0) == 0.0)
        assert not (blocks & ~sky).any(), (k, torch.nonzero(blocks & ~sky)[:4].tolist())
    if name == "far occluder":
        assert excluded >= 2  # the two occluders off the hull, at least

