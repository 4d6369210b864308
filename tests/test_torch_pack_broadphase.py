"""rtwc_tpu_torch pack tables and broad-phase work lists against the JAX
package (CPU), on the same scenes.

Pack tables and counts must be bit-equal. For cameras without pitch, list
counts, members and order must equal JAX's; where a float flip at a cone
boundary changes a tile's list, only a superset on the port's side is
accepted (the missing case fails) and such tiles are counted and bounded.
Cone axes / cosines match to atol 1e-6 (norms and arccos come from
different libraries).

With pitch the JAX package's cones are wrong (pallas_soft.py:640-642
builds vx*right + vy*up + fwd, while both renderers trace
(right.v, up.v, fwd.v)), so for the posed camera the port's lists are held
to what they must do instead, list every sphere that a ray of the tile
hits, and JAX's missing a hit sphere is pinned as the known fault."""
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import pack as JP
from rtwc_tpu.render.pallas_kernel import _best_bw, _round_up
from rtwc_tpu.render.pallas_soft import _sphere_tile_lists, _tile_cones
from rtwc_tpu_torch.render import pack as TP
from rtwc_tpu_torch.render import reference as TR
from rtwc_tpu_torch.render.broad_phase import _tile_cones as t_tile_cones
from rtwc_tpu_torch.render.broad_phase import sphere_tile_lists, tile_grid

torch.set_num_threads(2)

CFG = RenderConfig(width=120, height=48, max_spheres=16, max_planes=4)
POSED = JC.Camera(pos=np.array([3.0, 2.0, -5.0], np.float32),
                  rot=np.array([0.25, 2.8, 0.0], np.float32))
SCENES = {
    "default": (lambda: JS.default_scene(CFG), JC.default_camera),
    "posed": (lambda: JS.default_scene(CFG), lambda: POSED),
    "random10_seed3": (lambda: JS.random_scene(10, 1, max_spheres=16, max_planes=4, seed=3),
                       JC.default_camera),
}
# (16, 16): the port's display tile; the other: JAX's default tile at this
# size (render_frame_pallas: bh = min(64, round_up(H, 8)), bw = _best_bw(W)).
TILES = [(16, 16), (min(64, _round_up(CFG.height, 8)), _best_bw(CFG.width))]
# Tiles whose list may differ by a boundary flip (superset only), at most.
MAX_FLIP_TILES = 0.02


def _packed(name):
    jscene, jcam = SCENES[name][0](), SCENES[name][1]()
    return (JP.pack_scene(jscene), JP.pack_camera(jcam),
            TP.pack_scene(TS.scene_from_numpy(jscene)),
            TP.pack_camera(TC.camera_from_numpy(jcam)))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_bit_equal(name):
    (jsph, jpl, jcnt), jcam, (tsph, tpl, tcnt), tcam = _packed(name)
    np.testing.assert_array_equal(tsph.numpy(), np.asarray(jsph))
    np.testing.assert_array_equal(tpl.numpy(), np.asarray(jpl))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert tcnt.dtype == torch.int32 and tsph.dtype == tpl.dtype == torch.float32
    assert tcam.shape == (1, 16) and tcam.dtype == torch.float32
    np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), atol=1e-6, rtol=0)


def test_pack_compacts_stably():
    """Inactive slots between live ones: live objects move to the front in
    creation order (the shadow loop reads the first counts[0] columns)."""
    s = TS.random_scene(6, 1, max_spheres=8, seed=1)
    act = s.spheres.active.clone()
    act[1] = 0.0
    act[3] = 0.0
    s = s.replace(spheres=s.spheres.replace(active=act))
    sph, _, counts = TP.pack_scene(s)
    assert counts.tolist() == [4, 1]
    np.testing.assert_array_equal(sph[TP.S_R, :4].numpy(), s.spheres.radius[[0, 2, 4, 5]].numpy())


def _compare_lists(jl, tl):
    """Equal lists, or a port-side superset on a few tiles; returns the
    number of differing tiles."""
    jl, tl = np.asarray(jl)[:, 0], tl.numpy()[:, 0]
    assert jl.shape == tl.shape
    flips = 0
    for j_row, t_row in zip(jl, tl):
        jm, tm = j_row[1:1 + j_row[0]], t_row[1:1 + t_row[0]]
        if np.array_equal(jm, tm):
            continue
        missing = set(jm.tolist()) - set(tm.tolist())
        assert not missing, f"port list misses spheres {missing}"
        flips += 1
        # apart from the extra members, the order is the same
        np.testing.assert_array_equal(tm[np.isin(tm, jm)], jm)
    assert flips <= MAX_FLIP_TILES * len(jl), f"{flips} of {len(jl)} tiles differ"
    return flips


ZERO_PITCH = ["default", "random10_seed3"]


@pytest.mark.parametrize("tau", [0.0, 0.5], ids=["hard", "soft_tau0.5"])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("name", ZERO_PITCH)
def test_lists_match(name, tile, tau, record_property):
    (jsph, _, _), jcam, (tsph, _, _), tcam = _packed(name)
    bh, bw = tile
    grid = tile_grid(CFG.height, CFG.width, bh, bw)
    hard = tau == 0.0
    jl, jaux = _sphere_tile_lists(jsph, jcam, CFG, tau, bh, bw, grid, hard=hard)
    tl, taux = sphere_tile_lists(tsph, tcam, CFG, tau, bh, bw, grid, hard=hard)
    assert tl.dtype == torch.int32 and tl.shape == (grid[0] * grid[1], 1, 17)
    flips = _compare_lists(jl, tl)
    record_property("superset_tiles", flips)
    if flips == 0:
        np.testing.assert_allclose(taux[0].numpy(), np.asarray(jaux[0]), rtol=1e-6)
        np.testing.assert_array_equal(taux[1].numpy(), np.asarray(jaux[1]))


def _hit_sets(name, bh, bw):
    """Per tile, the spheres that some image pixel ray of the tile hits."""
    jscene, jcam = SCENES[name][0](), SCENES[name][1]()
    tscene, tcam = TS.scene_from_numpy(jscene), TC.camera_from_numpy(jcam)
    e1, e2 = TC.projection_elements(CFG)
    origin, dirs = TC.camera_rays(tcam, CFG.width, CFG.height, e1, e2)
    _, valid = TR.intersect_spheres(origin, dirs, tscene.spheres)     # [H, W, NS]
    Ti, Tj = tile_grid(CFG.height, CFG.width, bh, bw)
    return [set(np.flatnonzero(valid[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]
                               .reshape(-1, valid.shape[-1]).any(0).numpy()).tolist())
            for i in range(Ti) for j in range(Tj)]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_posed_lists_hold_every_hit_sphere(tile):
    (jsph, _, _), jcam, (tsph, _, _), tcam = _packed("posed")
    bh, bw = tile
    grid = tile_grid(CFG.height, CFG.width, bh, bw)
    hits = _hit_sets("posed", bh, bw)
    tl, _ = sphere_tile_lists(tsph, tcam, CFG, 0.0, bh, bw, grid, hard=True)
    soft, _ = sphere_tile_lists(tsph, tcam, CFG, 0.5, bh, bw, grid)
    for t, (want, row, srow) in enumerate(zip(hits, tl.numpy()[:, 0], soft.numpy()[:, 0])):
        listed = set(row[1:1 + row[0]].tolist())
        assert want <= listed, f"tile {t}: hit spheres {want - listed} not listed"
        # the soft rule reaches at least as far as the hard one
        assert listed <= set(srow[1:1 + srow[0]].tolist())
        # near-to-far order (distance of the centre from the camera)
        d = np.linalg.norm(tsph[:3].numpy().T[row[1:1 + row[0]]] - tcam[0, :3].numpy(), axis=1)
        assert (np.diff(d) >= 0).all()


def test_jax_lists_miss_hit_spheres_with_pitch():
    """Pins the JAX package's cone fault at 16x16 tiles for the posed
    camera (pitch 0.25); the port does not reproduce it."""
    (jsph, _, _), jcam, _, _ = _packed("posed")
    grid = tile_grid(CFG.height, CFG.width, 16, 16)
    jl, _ = _sphere_tile_lists(jsph, jcam, CFG, 0.0, 16, 16, grid, hard=True)
    missing = sum(len(want - set(row[1:1 + row[0]].tolist()))
                  for want, row in zip(_hit_sets("posed", 16, 16), np.asarray(jl)[:, 0]))
    assert missing > 0


def test_lists_disable_and_band_row():
    (jsph, _, _), jcam, (tsph, _, _), tcam = _packed("random10_seed3")
    jl, jaux = _sphere_tile_lists(jsph, jcam, CFG, 0.0, 16, 16, (3, 8), disable=True)
    tl, taux = sphere_tile_lists(tsph, tcam, CFG, 0.0, 16, 16, (3, 8), disable=True)
    assert jaux is None and taux is None
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # a band starting at row 20 (cam[0, C_ROW0])
    jcam2 = np.asarray(jcam).copy()
    jcam2[0, 14] = 20.0
    tcam2 = tcam.clone()
    tcam2[0, TP.C_ROW0] = 20.0
    jl, _ = _sphere_tile_lists(jsph, jcam2, CFG, 0.0, 16, 16, (2, 8), hard=True)
    tl, _ = sphere_tile_lists(tsph, tcam2, CFG, 0.0, 16, 16, (2, 8), hard=True)
    _compare_lists(jl, tl)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_tile_cones_match(tile):
    _, jcam, _, tcam = _packed("default")
    grid = tile_grid(CFG.height, CFG.width, *tile)
    for a, b in zip(_tile_cones(jcam, CFG, tile[0], tile[1], grid),
                    t_tile_cones(tcam, CFG, tile[0], tile[1], grid)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
