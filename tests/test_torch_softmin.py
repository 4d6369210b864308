"""rtwc_tpu_torch soft renderer (render/softmin.py, torch autograd) against
the JAX package's render_frame_soft and jax.grad, on the scene of
tests/test_pallas_soft.py (96x32, 2 spheres + 1 plane, tau 0.5), with
shadows off and on.

Tolerances: forward rgb atol 2e-3, depth 1e-3, normal 1e-4 (the Pallas
tests' forward tolerances, tests/test_pallas_soft.py:32-37). XLA's CPU code
contracts multiply-adds into FMAs and torch does not. At a few
ill-conditioned pixels (silhouettes, where b*b - 4c cancels and
miss_penalty times the penalty slope amplifies its rounding; the far edge
of the ground plane) the two f32 renders then differ by up to a few 1e-2
in rgb, and each is as far from a float64 evaluation of the same scene:
JAX's own worst value here is 0.1 from it. So at most 0.5 % of the values
may exceed the tolerance, and no value of the port may be farther from the
float64 render than JAX's farthest value (plus the tolerance): the
flip-budget rule of tests/test_torch_render.py for soft images. Gradients per
leaf group at _assert_close_tree's rtol 2e-2 / atol 1e-6 (atol 5e-6 with
shadows, as tests/test_pallas_soft.py:164-167 allows for the shadow chain's
near-zero components)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.render as JR
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.render.reference as TR
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.config import RenderConfig
from rtwc_tpu_torch.render.softmin import render_frame_soft as t_render_frame_soft

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False  # no TF32 anywhere
torch.backends.cudnn.allow_tf32 = False

CFG = RenderConfig(width=96, height=32, max_spheres=4, max_planes=2,
                   soft_miss_penalty=300.0, soft_mask_k=10.0)
TAU = 0.5
LEAVES = (("spheres", "center"), ("spheres", "radius"), ("spheres", "color"),
          ("planes", "center"), ("planes", "normal"), ("planes", "width"),
          ("planes", "height"), ("planes", "color"))


def jax_scene(shadows: bool):
    s = JS.empty_scene(CFG.max_spheres, CFG.max_planes)
    s = JS.add_sphere(s, 5.0, (0.0, 1.0, 20.0), (200.0, 40.0, 40.0), speed=1.0)
    s = JS.add_sphere(s, 3.0, (-4.0, -1.0, 28.0), (40.0, 200.0, 40.0), speed=1.0)
    s = JS.add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)
    if shadows:  # occluder between the light and the others
        s = JS.add_sphere(s, 3.0, (-2.0, 8.0, 22.0), (40.0, 40.0, 200.0), speed=1.0)
    return s


def jax_camera():
    c = JC.default_camera()
    return JC.Camera(pos=jnp.asarray(c.pos), rot=jnp.asarray(c.rot))


BUDGET = 0.005


def scene64(ts):
    """A float64 copy of a port Scene (the exact-arithmetic arbiter)."""
    import dataclasses

    def grp(node, cls):
        return cls(**{f.name: getattr(node, f.name).detach().double()
                      for f in dataclasses.fields(node)})

    return TS.Scene(spheres=grp(ts.spheres, TS.Spheres), planes=grp(ts.planes, TS.Planes))


def camera64(tc):
    return TC.Camera(pos=tc.pos.detach().double(), rot=tc.rot.detach().double())


def assert_soft_fb_close(got, want, exact, what=""):
    """got / want / exact: dicts of rgb, depth, normal arrays (port, JAX,
    float64 port). The module docstring states the rule."""
    for name, atol in (("rgb", 2e-3), ("depth", 1e-3), ("normal", 1e-4)):
        a = np.asarray(got[name], np.float64)
        b = np.asarray(want[name], np.float64)
        e = np.asarray(exact[name], np.float64)
        tol = atol + 1e-4 * np.abs(b)
        bad = np.abs(a - b) > tol
        frac = bad.mean()
        assert frac < BUDGET, f"{what} {name}: {bad.sum()} values off ({frac:.4f})"
        jax_worst = np.abs(b - e).max()
        worse = np.abs(a - e) > jax_worst + tol
        assert not worse.any(), (
            f"{what} {name}: port farther from float64 than JAX's worst value "
            f"({jax_worst}) at {np.argwhere(worse)[:5].tolist()}")


def fb_arrays(fb):
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return {k: host(getattr(fb, k)) for k in ("rgb", "depth", "normal")}


def loss_of(fb, np_mod):
    """The loss of tests/test_pallas_soft.py:52-64 (rgb MSE + depth + normals)."""
    return (np_mod.mean((fb.rgb / 255.0) ** 2) + 0.01 * np_mod.mean(fb.depth) / CFG.far
            + 0.1 * np_mod.mean(fb.normal ** 2))


def assert_close_tree(a, b, rtol=2e-2, atol=1e-6, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(a), np.abs(b))
    bad = np.abs(a - b) > (atol + rtol * scale)
    assert not bad.any(), f"{what}: grad mismatch\njax={a[bad][:5]}\ntorch={b[bad][:5]}"


@pytest.fixture(scope="module", params=[False, True], ids=["unshadowed", "shadows"])
def case(request):
    """JAX forward and gradients, once per shadow setting."""
    shadows = request.param
    cfg = CFG.replace(shadows=shadows)
    scene, cam = jax_scene(shadows), jax_camera()
    fb = JR.render_frame_soft(scene, cam, cfg, tau=TAU)
    g_scene, g_cam = jax.grad(lambda s, c: loss_of(JR.render_frame_soft(s, c, cfg, tau=TAU), jnp),
                              argnums=(0, 1))(scene, cam)
    return cfg, scene, cam, fb, g_scene, g_cam


def test_forward_matches_jax(case):
    cfg, scene, cam, fb_j, _, _ = case
    ts, tc = TS.scene_from_numpy(scene), TC.camera_from_numpy(cam)
    fb = t_render_frame_soft(ts, tc, cfg, tau=TAU)
    fb64 = t_render_frame_soft(scene64(ts), camera64(tc), cfg, tau=TAU)
    assert fb.rgb.dtype == torch.float32 and fb64.rgb.dtype == torch.float64
    assert_soft_fb_close(fb_arrays(fb), fb_arrays(fb_j), fb_arrays(fb64), "render_frame_soft")
    np.testing.assert_allclose(fb.alpha.numpy(), np.asarray(fb_j.alpha), atol=1e-4)
    assert torch.equal(fb.hit, torch.from_numpy(np.array(fb_j.hit)))


def test_grads_match_jax(case):
    cfg, scene, cam, _, g_scene, g_cam = case
    ts = TS.scene_from_numpy(scene, requires_grad=("all",))
    tc = TC.camera_from_numpy(cam, requires_grad=("all",))
    loss_of(t_render_frame_soft(ts, tc, cfg, tau=TAU), torch).backward()
    got_s, got_c = TS.scene_grads_to_numpy(ts), TC.camera_grads_to_numpy(tc)
    atol = 5e-6 if cfg.shadows else 1e-6
    for group, leaf in LEAVES:
        assert_close_tree(getattr(getattr(g_scene, group), leaf),
                          getattr(getattr(got_s, group), leaf), atol=atol,
                          what=f"{group}.{leaf}")
    assert_close_tree(g_cam.pos, got_c.pos, atol=atol, what="camera pos")
    assert_close_tree(g_cam.rot, got_c.rot, atol=atol, what="camera rot")
    # the gradient reaches real geometry (not a vacuous all-zero match)
    assert np.abs(got_s.spheres.center[:2]).min(axis=-1).max() > 0
    assert np.abs(got_c.rot[:2]).max() > 0


def test_straight_through_forward_is_the_hard_image():
    scene, cam = jax_scene(False), jax_camera()
    ts = TS.scene_from_numpy(scene, requires_grad=("spheres.center",))
    tc = TC.camera_from_numpy(cam)
    fb = t_render_frame_soft(ts, tc, CFG, tau=TAU, straight_through=True)
    hard = TR.render_frame(ts, tc, CFG)
    assert torch.equal(fb.rgb.detach(), hard.rgb)
    assert torch.equal(fb.normal.detach(), hard.normal)
    assert torch.equal(fb.depth.detach(), torch.clamp(hard.depth, max=CFG.far))
    # the gradient is the soft path's plus what flows through the hard
    # image's own autograd graph, in both packages
    fb.rgb.sum().backward()
    g_j = jax.grad(lambda sc: jnp.sum(JR.render_frame_soft(
        sc, cam, CFG, tau=TAU, straight_through=True).rgb))(scene)
    assert_close_tree(g_j.spheres.center, ts.spheres.center.grad.numpy(),
                      what="straight-through sphere centers")
    fb_j = JR.render_frame_soft(scene, cam, CFG, tau=TAU, straight_through=True)
    np.testing.assert_allclose(fb.rgb.detach().numpy(), np.asarray(fb_j.rgb), atol=2e-3, rtol=1e-4)


def test_softplus_is_logaddexp_not_thresholded():
    """At k*x past torch's softplus threshold (20) the penalty keeps the
    exact logaddexp value and sigmoid gradient, as jax.nn.softplus does."""
    from rtwc_tpu_torch.render.softmin import softplus

    x = torch.tensor([-30.0, -5.0, 0.0, 15.0, 21.0, 40.0], requires_grad=True)
    y = softplus(x)
    y.sum().backward()
    xj = jnp.asarray(x.detach().numpy())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jax.nn.softplus(xj)), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(
        lambda v: jnp.sum(jax.nn.softplus(v)))(xj)), rtol=1e-6, atol=1e-12)
