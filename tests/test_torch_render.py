"""rtwc_tpu_torch reference renderer against the JAX reference renderer
(CPU), with the cases of tests/test_pallas.py plus 2x supersampling.

Tolerance (tests/test_pallas.py:19-31): pixels that flip differ on < 0.5 %
of the image; on the other pixels that both call a hit, rgb, depth, normal
and shading are allclose(atol=2e-3, rtol=1e-4). A pixel flips when a ray
with disc ~ 0 changes its decision on a one-ulp change: a silhouette
pixel (hit masks differ) or, with shadows, a pixel whose shadow ray grazes
an occluder or the light's terminator on its own sphere. The JAX package's
XLA code contracts multiply-adds into FMAs and the port does not, so such
ulps differ. A shadow pixel counts as flipped when the JAX reference's
own shadow decision changes when its depth moves by +-2^-21 relative
(eight f32 ulps)."""
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render import reference as JR
from rtwc_tpu_torch.render import reference as TR

torch.set_num_threads(2)

CFG = RenderConfig(width=120, height=48, max_spheres=16, max_planes=4)
POSED = JC.Camera(pos=np.array([3.0, 2.0, -5.0], np.float32),
                  rot=np.array([0.25, 2.8, 0.0], np.float32))
FLIP_FRAC_MAX = 0.005
NUDGE = 2.0 ** -21


def shadow_flips(jscene, jcam, cfg, ref):
    """Pixels whose JAX hard-shadow decision changes when the hit depth
    moves by +-NUDGE relative (all False without shadows)."""
    hit = np.asarray(ref.hit)
    if not cfg.shadows:
        return np.zeros_like(hit)
    e1, e2 = JC.projection_elements(cfg)
    origin, dirs = JC.camera_rays(jcam, cfg.width, cfg.height, e1, e2)
    depth = np.asarray(ref.depth)
    vis = [np.asarray(JR._shadow_visibility(jscene, origin + dirs * (depth * f)[..., None], cfg))
           for f in (1.0 - NUDGE, 1.0, 1.0 + NUDGE)]
    return hit & ((vis[0] != vis[1]) | (vis[2] != vis[1]))


def compare_fb(ref, fb, flips=None, atol=2e-3):
    hit_ref, hit = np.asarray(ref.hit), fb.hit.numpy()
    flipped = (hit_ref != hit) | (flips if flips is not None else False)
    frac = np.mean(flipped)
    assert frac < FLIP_FRAC_MAX, f"{frac:.2%} of pixels flip"
    keep = hit_ref & hit & ~flipped
    for name in ("rgb", "depth", "normal", "shading", "coverage", "alpha"):
        a = np.asarray(getattr(ref, name))[keep]
        b = getattr(fb, name).numpy()[keep]
        np.testing.assert_allclose(b, a, atol=atol, rtol=1e-4, err_msg=name)


CASES = {
    "default": (lambda c: JS.default_scene(c), JC.default_camera, CFG),
    "posed_camera": (lambda c: JS.default_scene(c), lambda: POSED, CFG),
    "random_scene": (lambda c: JS.random_scene(10, 1, max_spheres=16, max_planes=4, seed=3),
                     JC.default_camera, CFG),
    "shadows": (lambda c: JS.default_scene(c), JC.default_camera, CFG.replace(shadows=True)),
    "nondivisible": (lambda c: JS.default_scene(c), JC.default_camera,
                     CFG.replace(width=100, height=37)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_jax(name):
    make_scene, make_cam, cfg = CASES[name]
    jscene, jcam = make_scene(cfg), make_cam()
    ref = JR.render_frame(jscene, jcam, cfg)
    fb = TR.render_frame(TS.scene_from_numpy(jscene), TC.camera_from_numpy(jcam), cfg)
    assert fb.rgb.shape == (cfg.height, cfg.width, 3) and fb.hit.dtype == torch.bool
    compare_fb(ref, fb, shadow_flips(jscene, jcam, cfg, ref))


def test_reference_supersample_matches_jax():
    cfg = CFG.replace(supersample=2, shadows=True)
    jscene = JS.random_scene(10, 1, max_spheres=16, max_planes=4, seed=3)
    ss = JR.supersampled_config(cfg)
    assert TR.supersampled_config(cfg) == ss and ss.width == 240
    ref = JR.downsample_framebuffer(JR.render_frame(jscene, JC.default_camera(), ss), 2)
    fb = TR.downsample_framebuffer(
        TR.render_frame(TS.scene_from_numpy(jscene), TC.default_camera(), ss), 2)
    assert fb.depth.shape == (cfg.height, cfg.width)
    compare_fb(ref, fb)
    # the pooled coverage carries the exact hit fraction (multiples of 1/4)
    np.testing.assert_array_equal(np.unique(fb.coverage.numpy() * 4) % 1, 0)


def test_reference_empty_scene_is_background():
    fb = TR.render_frame(TS.empty_scene(8, 2), TC.default_camera(), CFG)
    assert not fb.hit.any()
    assert (fb.rgb == 0).all() and (fb.depth == TR.MISS_DISTANCE).all()


def test_intersections_match_jax():
    rng = np.random.default_rng(0)
    jscene = JS.random_scene(10, 2, max_spheres=16, max_planes=4, seed=8)
    tscene = TS.scene_from_numpy(jscene)
    origin = np.array([0.5, 1.0, -2.0], np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:, 2] = np.abs(d[:, 2])
    for jf, tf, node in ((JR.intersect_spheres, TR.intersect_spheres, "spheres"),
                         (JR.intersect_planes, TR.intersect_planes, "planes")):
        jt, jv = jf(origin, d, getattr(jscene, node))
        tt, tv = tf(torch.from_numpy(origin), torch.from_numpy(d), getattr(tscene, node))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-4)
