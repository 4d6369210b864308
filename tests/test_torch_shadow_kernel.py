"""rtwc_tpu_torch's shadowed kernels K4 / K5 / K6 / K4-stats, run as their
plain torch versions on the CPU (the wrappers run them for CPU tensors),
against the JAX package's shadowed Pallas path in interpret mode
(`render_frame_soft_pallas`, `render_soft_mse_loss`, `soft_tile_diagnostics`
with shadows=True), the port's own torch soft renderer, and the port's
generic path; and the entry point `python -m
rtwc_tpu_torch.examples.fit_from_shadow` at 64x32.

Tolerances (tests/test_pallas_soft.py:119-235): rgb atol 2e-2 rtol 1e-4,
depth and normal atol 1e-3; gradients rtol 2e-2 atol 5e-6. XLA's CPU code
contracts multiply-adds into FMAs and the port does not: at silhouettes and
at the light's terminator that moves single values further, so at most
0.5 % of the values may leave the forward tolerance, and no kernel value
may be farther from a float64 render (the port's torch soft renderer in
float64) than the farther of two independent float32 renders, JAX's
Pallas path and the port's torch soft renderer (ROADMAP queue 3). Under the
saturating light a silhouette pixel's float32 depth error (7e-4, inside
the depth tolerance) becomes 0.05 in rgb, the same in the kernel and in the
port's torch renderer. K6 against the port's own generic path (same
arithmetic): loss rtol 1e-6, gradients 2e-5 of each table's largest
value."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.render as JR
import rtwc_tpu.render.softmin as JSM
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.camera import Camera as JCamera
from rtwc_tpu.config import RenderConfig as JRenderConfig
from rtwc_tpu.render.pallas_soft import _pick_tiles
from rtwc_tpu.render.pallas_soft import render_frame_soft_pallas as j_render
from rtwc_tpu.render.pallas_soft import render_soft_mse_loss as j_mse
from rtwc_tpu.render.pallas_soft import soft_tile_diagnostics as j_diag
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.examples import fit_from_shadow as FS
from rtwc_tpu_torch.render import shadow_kernel as SH
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.render import softmin as TSM
from rtwc_tpu_torch.render.softmin import render_frame_soft as t_soft
from rtwc_tpu_torch.utils import telemetry
from test_torch_soft_kernel import _slab_crowd, rel_err
from test_torch_softmin import (CFG, LEAVES, TAU, assert_close_tree, camera64, fb_arrays,
                                jax_camera, jax_scene, loss_of, scene64)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False  # no TF32 anywhere
torch.backends.cudnn.allow_tf32 = False

CFG_SH = CFG.replace(shadows=True)
BUDGET = 0.005
GRAD_ATOL = 5e-6


def assert_shadow_fb_close(got, want, exact, other=None, what=""):
    """The module note's forward rule, at the shadowed tolerances; `other`
    is a second independent float32 render (the port's torch renderer)."""
    for name, atol in (("rgb", 2e-2), ("depth", 1e-3), ("normal", 1e-3)):
        a, b, e = (np.asarray(x[name], np.float64) for x in (got, want, exact))
        tol = atol + 1e-4 * np.abs(b)
        frac = (np.abs(a - b) > tol).mean()
        assert frac < BUDGET, f"{what} {name}: {frac:.4f} of the values off"
        worst = np.abs(b - e).max()
        if other is not None:
            worst = max(worst, np.abs(np.asarray(other[name], np.float64) - e).max())
        worse = np.abs(a - e) > worst + tol
        assert not worse.any(), f"{what} {name}: port farther from float64 than the float32 " \
                                f"renders at {np.argwhere(worse)[:5].tolist()}"


def _port(scene, cam, **kw):
    return TS.scene_from_numpy(scene, **kw.get("s", {})), TC.camera_from_numpy(cam, **kw.get("c", {}))


def _check_forward(scene, cam, cfg, what, alpha_pixels=()):
    """Port K4 against JAX's shadowed Pallas forward and against the port's
    torch soft renderer; returns the port framebuffer. Alpha holds to 1e-4
    of JAX's, except at the (row, col) alpha_pixels a caller names: there
    the port's alpha is within 5e-4 of JAX's and no farther from a float64
    render than JAX's is (a silhouette where JAX's discriminant b^2 - 4c
    rounds farther than the port's 4 (r^2 - q . q))."""
    ts, tc = _port(scene, cam)
    n = dict(SK.LAUNCHES)
    fb = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU)
    assert SK.LAUNCHES == n  # CPU tensors: the plain versions, no launch
    fb_j = j_render(scene, cam, cfg, tau=TAU)
    fb64 = t_soft(scene64(ts), camera64(tc), cfg, tau=TAU)
    ref = t_soft(ts, tc, cfg, tau=TAU)
    assert_shadow_fb_close(fb_arrays(fb), fb_arrays(fb_j), fb_arrays(fb64), fb_arrays(ref), what)
    a, b, e = fb.alpha.numpy(), np.asarray(fb_j.alpha), fb64.alpha.numpy()
    named = np.zeros(a.shape, bool)
    for px in alpha_pixels:
        named[px] = True
    ok = np.abs(a - b) <= 1e-4
    ok |= named & (np.abs(a - b) <= 5e-4) & (np.abs(a - e) <= np.abs(b - e))
    assert ok.all(), f"{what} alpha: port {a[~ok]}, JAX {b[~ok]}, float64 {e[~ok]}"
    assert_shadow_fb_close(fb_arrays(fb), fb_arrays(ref), fb_arrays(fb64),
                           what=what + " vs torch")
    return fb


def _grads(scene, cam, cfg, loss):
    ts = TS.scene_from_numpy(scene, requires_grad=("all",))
    tc = TC.camera_from_numpy(cam, requires_grad=("all",))
    value = loss(ts, tc)
    value.backward()
    return value.item(), TS.scene_grads_to_numpy(ts), TC.camera_grads_to_numpy(tc)


def _assert_grads(gj, ps, pc, what, leaves=LEAVES):
    gs, gc = gj
    for group, leaf in leaves:
        assert_close_tree(getattr(getattr(gs, group), leaf), getattr(getattr(ps, group), leaf),
                          atol=GRAD_ATOL, what=f"{what} {group}.{leaf}")
    assert_close_tree(gc.pos, pc.pos, atol=GRAD_ATOL, what=f"{what} camera pos")
    assert_close_tree(gc.rot, pc.rot, atol=GRAD_ATOL, what=f"{what} camera rot")


def _generic_loss(cfg):
    return lambda s, c: loss_of(SK.render_frame_soft_kernel(s, c, cfg, tau=TAU), torch)


# -- K4 / K5 on the shadow scene of tests/test_pallas_soft.py ----------------------

@pytest.fixture(scope="module")
def shadow_case():
    scene, cam = jax_scene(True), jax_camera()
    g = jax.grad(lambda s, c: loss_of(j_render(s, c, CFG_SH, tau=TAU), jnp),
                 argnums=(0, 1))(scene, cam)
    return scene, cam, g


def test_k4_casts_the_shadow_jax_does(shadow_case):
    """The fault this slice repairs: with shadows=True the soft kernel path
    used to return the unshadowed image. Now it differs from it where the
    occluder casts its shadow, and matches JAX's shadowed render and the
    port's own torch soft renderer."""
    scene, cam, _ = shadow_case
    fb = _check_forward(scene, cam, CFG_SH, "K4")
    ts, tc = _port(scene, cam)
    lit = SK.render_frame_soft_kernel(ts, tc, CFG, tau=TAU)
    dark = (lit.rgb - fb.rgb).sum(-1)
    assert dark.max() > 20.0
    assert dark.min() > -5e-3  # shadows only remove light (tests/test_pallas_soft.py:141)


def test_k5_grads_match_jax(shadow_case):
    scene, cam, gj = shadow_case
    _, ps, pc = _grads(scene, cam, CFG_SH, _generic_loss(CFG_SH))
    _assert_grads(gj, ps, pc, "K5")
    assert np.abs(ps.spheres.center[2]).max() > 0  # the occluder, through its shadow


def test_k5_camera_grads_match_float64(shadow_case):
    """The camera gradients against the port's torch soft renderer in
    float64. In float32 that renderer builds its rays in the kernels' op
    order; in float64 their rounding no longer matters, so this arbiter
    shares none with the kernels: within 1.5e-2 of the largest component
    (ROADMAP queue 3's rotation carve-out)."""
    scene, cam, _ = shadow_case
    _, _, pc = _grads(scene, cam, CFG_SH, _generic_loss(CFG_SH))
    ts, tc = _port(scene, cam)
    c64 = TC.Camera(pos=tc.pos.double().requires_grad_(True),
                    rot=tc.rot.double().requires_grad_(True))
    loss_of(t_soft(scene64(ts), c64, CFG_SH, tau=TAU), torch).backward()
    for name in ("pos", "rot"):
        got, want = np.asarray(getattr(pc, name), np.float64), getattr(c64, name).grad.numpy()
        assert np.abs(got - want).max() <= 1.5e-2 * np.abs(want).max(), (name, got, want)


def test_k5_bwd_cull_off_matches(shadow_case):
    scene, cam, _ = shadow_case
    _, a, ac = _grads(scene, cam, CFG_SH, _generic_loss(CFG_SH))
    _, b, bc = _grads(scene, cam, CFG_SH, lambda s, c: loss_of(SK.render_frame_soft_kernel(
        s, c, CFG_SH, tau=TAU, bwd_cull=False), torch))
    for group, leaf in LEAVES:
        assert_close_tree(getattr(getattr(a, group), leaf), getattr(getattr(b, group), leaf),
                          rtol=1e-4, what=f"{group}.{leaf}")
    assert_close_tree(ac.rot, bc.rot, rtol=1e-4, what="camera rot")


# -- K6 --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mse_case():
    scene, cam = jax_scene(True), jax_camera()
    tgt = np.random.default_rng(1).uniform(0.0, 255.0, (CFG.height, CFG.width, 3)).astype(np.float32)
    lj, gj = jax.value_and_grad(lambda s, c: j_mse(s, c, jnp.asarray(tgt), CFG_SH, tau=TAU),
                                argnums=(0, 1))(scene, cam)
    return scene, cam, tgt, float(lj), gj


def _mse_losses(tgt, cfg):
    t = torch.from_numpy(tgt)

    def fused(s, c):
        return SK.render_soft_mse_loss(s, c, t, cfg, tau=TAU)

    def generic(s, c):
        return torch.mean(((SK.render_frame_soft_kernel(s, c, cfg, tau=TAU).rgb - t) / 255.0) ** 2)

    return fused, generic


def test_k6_matches_jax_and_the_generic_path(mse_case):
    scene, cam, tgt, lj, gj = mse_case
    fused, generic = _mse_losses(tgt, CFG_SH)
    lf, fs, fc = _grads(scene, cam, CFG_SH, fused)
    lg, ps, pc = _grads(scene, cam, CFG_SH, generic)
    np.testing.assert_allclose(lf, lg, rtol=1e-6)
    np.testing.assert_allclose(lf, lj, rtol=1e-5)
    for g, leaf in LEAVES:
        f, p = getattr(getattr(fs, g), leaf), getattr(getattr(ps, g), leaf)
        assert rel_err(f, p) < 2e-5 or np.abs(p).max() == 0, f"{g}.{leaf}"
    for f, p, name in ((fc.pos, pc.pos, "pos"), (fc.rot, pc.rot, "rot")):
        assert rel_err(f, p) < 2e-5, name
    _assert_grads(gj, fs, fc, "K6")
    with torch.no_grad():  # the un-differentiated call: K4 and the loss in torch
        ts, tc = _port(scene, cam)
        np.testing.assert_allclose(fused(ts, tc).item(), lj, rtol=1e-5)


def test_k6_target_cotangent(mse_case):
    scene, cam, tgt, _, _ = mse_case
    ts, tc = _port(scene, cam)
    t = torch.from_numpy(tgt).requires_grad_(True)
    SK.render_soft_mse_loss(ts, tc, t, CFG_SH, tau=TAU).backward()
    fb = SK.render_frame_soft_kernel(ts, tc, CFG_SH, tau=TAU)
    want = -2.0 / (255.0 ** 2 * tgt.size) * (fb.rgb.detach() - t.detach())
    np.testing.assert_allclose(t.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-12)


# -- special scenes -------------------------------------------------------------------

def _mse_grads_vs_jax(scene, cam, cfg, what, leaves=(("spheres", "center"), ("spheres", "color"))):
    tgt = np.zeros((cfg.height, cfg.width, 3), np.float32)
    gj = jax.grad(lambda s: j_mse(s, cam, jnp.asarray(tgt), cfg, tau=TAU))(scene)
    _, ps, _ = _grads(scene, cam, cfg, _mse_losses(tgt, cfg)[0])
    for group, leaf in leaves:
        assert_close_tree(getattr(getattr(gj, group), leaf), getattr(getattr(ps, group), leaf),
                          atol=GRAD_ATOL, what=f"{what} {group}.{leaf}")
    return ps


def test_saturating_clamp():
    """tests/test_pallas_soft.py:182: a light so bright that objects reach
    A + vis B >= 255, so the cached clamp correction does real work."""
    cfg = CFG_SH.replace(light_specular_power=3e5, light_diffuse_power=2e4)
    scene, cam = jax_scene(True), jax_camera()
    fb = _check_forward(scene, cam, cfg, "saturating light")
    assert (fb.rgb >= 254.5).any()
    _mse_grads_vs_jax(scene, cam, cfg, "saturating light")


def _crowd(n=14, seed=3):
    """n overlapping spheres in frame: some 16x16 tiles gate in more objects
    than the port's NC cache slots (tests/test_pallas_soft.py:205)."""
    rng = np.random.default_rng(seed)
    s = JS.empty_scene(16, 2)
    for _ in range(n):
        s = JS.add_sphere(s, float(rng.uniform(2.0, 4.0)),
                          (float(rng.uniform(-4, 4)), float(rng.uniform(-2, 2)),
                           float(rng.uniform(18, 30))),
                          tuple(float(c) for c in rng.uniform(30, 220, 3)), speed=1.0)
    return JS.add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)


def test_cache_overflow_takes_the_exact_rewalk():
    cfg = CFG_SH.replace(max_spheres=16)
    scene, cam = _crowd(), jax_camera()
    ts, tc = _port(scene, cam)
    counts, fwd_slots, fused_slots = SH.soft_cache_stats(ts, tc, cfg, tau=TAU)
    assert fwd_slots == fused_slots == SH.NC
    assert int(counts.max()) > SH.NC, "no tile overflows the cache; densify the scene"
    assert int(counts.min()) <= SH.NC  # both paths run in one frame
    # (11, 42): a silhouette pixel, alpha 2.8e-4 from JAX's, 3e-6 from float64
    _check_forward(scene, cam, cfg, "cache overflow", alpha_pixels=((11, 42),))
    _mse_grads_vs_jax(scene, cam, cfg, "cache overflow")


@pytest.mark.parametrize("crowd", ["slab", "cache"])
def test_k5_k6_on_crowded_tiles_match_jax(crowd):
    """Tiles that gate more objects than the card's SLAB slab slots
    (`slab`), and more culled-in objects than the NC cache slots (`cache`):
    the plain K5 (the generic path's backward) and K6 against JAX's
    gradients of every leaf, held as test_k5_grads_match_jax holds them.
    K6 runs against a zero target, as _mse_grads_vs_jax runs the other
    special scenes; test_k5_k6_on_the_slab_crowd_with_a_random_target
    holds the slab crowd against a random one."""
    scene, cfg = ((_slab_crowd(), CFG_SH.replace(max_spheres=48)) if crowd == "slab"
                  else (_crowd(), CFG_SH.replace(max_spheres=16)))
    cam = jax_camera()
    ts, tc = _port(scene, cam)
    spec = SK.SoftSpec(cfg, TAU)
    sph, pl, camv = SK._packed(ts, tc)
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    counts = SH.soft_sh_stats(sph, pl, camv, lists, shl, spec=spec)[2][:, 0]
    limit = SH.SLAB if crowd == "slab" else SH.NC
    assert int(counts.max()) > limit >= int(counts.min())
    gj = jax.grad(lambda s, c: loss_of(j_render(s, c, cfg, tau=TAU), jnp), argnums=(0, 1))(scene, cam)
    _, ps, pc = _grads(scene, cam, cfg, _generic_loss(cfg))
    _assert_grads(gj, ps, pc, f"K5 {crowd}")
    tgt = np.zeros((cfg.height, cfg.width, 3), np.float32)
    gj = jax.grad(lambda s, c: j_mse(s, c, jnp.asarray(tgt), cfg, tau=TAU), argnums=(0, 1))(scene, cam)
    _, fs, fc = _grads(scene, cam, cfg, _mse_losses(tgt, cfg)[0])
    _assert_grads(gj, fs, fc, f"K6 {crowd}")


def _mse_grads64(scene, cam, tgt, cfg):
    """Every leaf's gradient of the MSE loss through the port's torch soft
    renderer in float64 (the arbiter of the module note)."""
    ts, tc = _port(scene, cam)
    s64 = scene64(ts)
    for node in (s64.spheres, s64.planes):
        for leaf in vars(node).values():
            leaf.requires_grad_(True)
    c64 = TC.Camera(pos=tc.pos.double().requires_grad_(True),
                    rot=tc.rot.double().requires_grad_(True))
    t = torch.from_numpy(tgt).double()
    torch.mean(((t_soft(s64, c64, cfg, tau=TAU).rgb - t) / 255.0) ** 2).backward()
    return s64, c64


# (group, leaf, index) of the slab crowd's gradients that the per-pixel split
# pins to one ill-conditioned pixel (test_k5_k6_on_the_slab_crowd_with_a_random_target)
ILL_CONDITIONED = {("spheres", "radius", 37)}


def test_k5_k6_on_the_slab_crowd_with_a_random_target():
    """The slab crowd against mse_case's uniform(0, 255) target: the plain K5
    (the generic path) and K6 against JAX's gradients of every leaf
    (render_soft_mse_loss, the Pallas path), held as _assert_grads holds
    them. One value alone, pinned in ILL_CONDITIONED, may leave that
    tolerance, and is then held to the rule for ill-conditioned pixels
    (ROADMAP queue 3): no farther from float64 than the farther of JAX's two
    float32 renders, the Pallas path and softmin.py, plus GRAD_ATOL. Every
    other value of every leaf passes _assert_grads' tolerance. The pinned
    value is sphere 37's radius gradient: one pixel, (21, 33), carries it
    (a per-pixel split of the loss's forward-mode derivative), where the sphere's
    silhouette penalty competes with a sphere and the floor behind it and
    d rgb / d r is about -1735. The Pallas path gives 1.46e-5 and
    softmin.py 1.19e-5 against float64's 2.13e-5; the port gave 3.81e-5
    while its discriminant was b^2 - 4c (0.8 % off at that pixel, two
    thirds of it that cancellation) and gives 2.11e-5 with 4 (r^2 - q . q)
    (render/soft_objects.py `sphere_solve`)."""
    cfg = CFG_SH.replace(max_spheres=48)
    scene, cam = _slab_crowd(), jax_camera()
    tgt = np.random.default_rng(1).uniform(0.0, 255.0, (cfg.height, cfg.width, 3)).astype(np.float32)
    gj = jax.grad(lambda s, c: j_mse(s, c, jnp.asarray(tgt), cfg, tau=TAU), argnums=(0, 1))(scene, cam)
    s64, c64 = _mse_grads64(scene, cam, tgt, cfg)
    g_soft = None  # softmin.py's float32 gradients, only where the rule is needed
    keys = [("scene", g, leaf) for g, leaf in LEAVES] + [("camera", None, "pos"), ("camera", None, "rot")]

    def pick(tree, key):
        part, group, leaf = key
        node = tree[0 if part == "scene" else 1]
        return np.asarray(getattr(getattr(node, group), leaf) if group else getattr(node, leaf),
                          np.float64)

    fused, generic = _mse_losses(tgt, cfg)
    for name, loss in (("K5", generic), ("K6", fused)):
        _, ps, pc = _grads(scene, cam, cfg, loss)
        for key in keys:
            a, b = pick(gj, key), pick((ps, pc), key)
            ok = np.abs(a - b) <= GRAD_ATOL + 2e-2 * np.maximum(np.abs(a), np.abs(b))
            if ok.all():
                continue
            off = [(key[1], key[2]) + tuple(i) for i in np.argwhere(~ok).tolist()]
            assert set(off) <= ILL_CONDITIONED, (
                f"{name} {key[1:]}: port {b[~ok]}, JAX {a[~ok]} at {np.argwhere(~ok).tolist()}")
            if g_soft is None:
                g_soft = jax.grad(lambda s, c: jnp.mean(
                    ((JR.render_frame_soft(s, c, cfg, tau=TAU).rgb - tgt) / 255.0) ** 2),
                    argnums=(0, 1))(scene, cam)
            leaf64 = getattr(c64, key[2]) if key[0] == "camera" else getattr(getattr(s64, key[1]), key[2])
            e = leaf64.grad.numpy()
            jax_worst = np.maximum(np.abs(a - e), np.abs(pick(g_soft, key) - e))
            ok |= np.abs(b - e) <= jax_worst + GRAD_ATOL
            assert ok.all(), (f"{name} {key[1:]}: port {b[~ok]}, JAX {a[~ok]}, float64 {e[~ok]}")


def test_float64_renders_agree_on_the_slab_crowd():
    """The float64 arbiter. Given the same rays, JAX's softmin.py under
    jax_enable_x64 and the port's torch renderer in float64 agree to 1e-8
    on the slab crowd. Their own rays differ by up to 2e-8, which moves
    rgb at pixel (21, 33) by 5e-4: JAX's camera_rays
    (rtwc_tpu/camera/camera.py:103-108) takes cx, cy from a float32 arange
    and multiplies them by the Python floats e1, e2, so in an x64 run
    vx = cx e1 and vy = cy e2 are still rounded to float32 per pixel. The
    port's float64 rays use e1, e2 rounded to float32, the constants every
    float32 render receives (soft_objects.SoftConsts), and no float32 step
    after them."""
    cfg = CFG_SH.replace(max_spheres=48)
    scene, cam = _slab_crowd(), jax_camera()
    ts, tc = _port(scene, cam)
    origin, dirs = TSM._soft_rays(camera64(tc), cfg, "cpu")
    want = TSM.trace_soft(scene64(ts), origin, dirs, cfg, tau=TAU)
    with jax.enable_x64(True):
        js = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x, np.float64)), scene)
        got = JSM.trace_soft(js, jnp.asarray(origin.numpy()), jnp.asarray(dirs.numpy()), cfg,
                             tau=TAU)
        got = [np.asarray(x) for x in got]
        jc = JC.Camera(pos=jnp.asarray(np.asarray(cam.pos, np.float64)),
                       rot=jnp.asarray(np.asarray(cam.rot, np.float64)))
        e1, e2 = JC.projection_elements(cfg)
        j_dirs = np.asarray(JC.camera_rays(jc, cfg.width, cfg.height, e1, e2)[1])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=1e-8)
    # JAX's x64 rays are those of float32 vx, vy
    f = np.float32
    vx = (f(2.0) * np.arange(cfg.width, dtype=f) - f(cfg.width)) / f(cfg.width) * f(e1)
    vy = (f(cfg.height) - f(2.0) * np.arange(cfg.height, dtype=f)) / f(cfg.height) * f(e2)
    right, up, fwd = (np.asarray(v, np.float64) for v in TC.basis(camera64(tc).rot))
    d = (vx.astype(np.float64)[None, :, None] * np.array([right[0], up[0], fwd[0]])
         + vy.astype(np.float64)[:, None, None] * np.array([right[1], up[1], fwd[1]])
         + np.array([right[2], up[2], fwd[2]]))
    d = d / np.sqrt((d * d).sum(-1, keepdims=True))
    np.testing.assert_allclose(j_dirs, d, rtol=0, atol=1e-14)
    assert np.abs(j_dirs - dirs.numpy()).max() > 1e-9


def test_slab_and_cache_sizes_match_the_cuda_source():
    """The plain versions and chip_smoke.py read NC, SLAB, STAGED, K4's
    shared memory a block and the reduction's chunk from the modules; the
    kernels from csrc/. K4's size (`sh_fwd_smem`, evaluated here from its
    source) equals `fwd_shared_bytes`; K2 and K4 are built for
    K2_MIN_BLOCKS / K4_MIN_BLOCKS blocks an SM, and that many K4 blocks fit
    an SM's 228 KB of shared memory at the bench headline (20 spheres, 4
    planes), each with the 1 KB the runtime keeps a block."""
    src = os.path.join(os.path.dirname(SK.__file__), "..", "csrc")

    def read(name):
        with open(os.path.join(src, name)) as f:
            return f.read()

    shadow, block, render = read("soft_shadow.cu"), read("soft_block.cuh"), read("soft_render.cu")
    assert re.search(r"constexpr int NC = (\d+);", shadow).group(1) == str(SH.NC)
    assert re.search(r"constexpr int SLAB_SLOTS = (\d+);", block).group(1) == str(SH.SLAB)
    assert re.search(r"constexpr int STAGED = (\d+);", block).group(1) == str(SH.STAGED)
    assert re.search(r"constexpr int MAX_THREADS = (\d+);", block).group(1) == str(SK.C.MAX_THREADS)
    # the reduction's chunk: one a thread
    assert re.search(r"constexpr int RED_THREADS = (\d+),", render).group(1) == str(SK.C.RED_CHUNK)
    body = re.search(r"inline size_t sh_fwd_smem\(int np, int list_stride\) \{\s*return (.*?);\s*\}",
                     shadow, re.S).group(1)
    expr = " ".join(re.sub(r"sizeof\((?:float|int)\)", "4", body).replace("(size_t)", "").split())
    for n_planes, stride in ((4, 21), (4, 201), (1, 2), (1024, 257)):
        env = dict(np=n_planes, list_stride=stride, PL_ROWS=SK.P.PL_ROWS, NC=SH.NC,
                   STAGED=SH.STAGED, MAX_THREADS=SK.C.MAX_THREADS)
        assert eval(expr, {}, env) == SH.fwd_shared_bytes(n_planes, stride), (n_planes, stride)
    for name, kernel, text in (("K2", "soft_bwd_kernel", render),
                               ("K4", "soft_sh_fwd_kernel", shadow)):
        blocks = int(re.search(rf"constexpr int {name}_MIN_BLOCKS = (\d+);", text).group(1))
        assert f"__launch_bounds__(MAX_THREADS, {name}_MIN_BLOCKS)\n{kernel}(" in text
        assert 2 <= blocks <= 8
        if name == "K4":
            assert blocks * (SH.fwd_shared_bytes(4, 21) + 1024) <= 228 * 1024


def test_bound_bytes_count_what_the_kernels_touch():
    """chip_smoke.py's bounds count the bytes a kernel touches, not the
    tables it is given. On the slab crowd: `_list_bytes` is each list row's
    n + 1 ints, plus one gate int a listed sphere and a plane; every
    partial row that the plain K5 wrote nonzero, under seeded random
    cotangents, is among the rows `_partial_bytes` counts, which are fewer
    than the zeroed tables hold."""
    import chip_smoke as CS

    cfg = CFG_SH.replace(max_spheres=48)
    ts, tc = _port(_slab_crowd(), jax_camera())
    spec = SK.SoftSpec(cfg, TAU)
    sph, pl, camv = SK._packed(ts, tc)
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    out, gates = SH.soft_sh_fwd(sph, pl, camv, lists, shl, spec=spec)
    ent = SK.entry_tables(lists, shl)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(out.shape)).astype(np.float32))
    parts = SH.soft_sh_bwd(sph, pl, camv, lists, shl, ent.offsets, ent.sh_offsets, gates, out, g,
                           spec=spec)
    pvals, psh, ppl, ptf = parts
    npl, ns, T = int(camv[0, SK.P.C_NPL]), sph.shape[1], lists.shape[0]
    rows = [int(row[0]) for lst in (lists, shl) for row in lst[:, 0]]
    assert CS._list_bytes(npl, lists, shl, gate_rows=False) == 4 * sum(n + 1 for n in rows)
    assert CS._list_bytes(npl, lists, shl) == 4 * sum(2 * n + 1 + npl for n in rows)
    written = (32 * int((pvals != 0).any(1).sum()) + 16 * int((psh != 0).any(1).sum())
               + 48 * int((ppl[:, :npl] != 0).any(2).sum()) + 8 * 12 * T)
    assert not ptf[:, 12:].any() and not ppl[:, npl:].any()
    counted = CS._partial_bytes(gates, ns, npl, 12, shadowed=True)
    assert written <= counted < 4 * sum(t.numel() for t in parts), (written, counted)


def test_occluder_outside_the_frustum_gets_grad_through_its_shadow():
    """tests/test_pallas_soft.py:238-254."""
    s = JS.empty_scene(CFG.max_spheres, CFG.max_planes)
    s = JS.add_sphere(s, 5.0, (0.0, 1.0, 20.0), (200.0, 40.0, 40.0), speed=1.0)
    s = JS.add_sphere(s, 4.0, (3.5, 26.0, 10.0), (40.0, 40.0, 200.0), speed=1.0)
    ps = _mse_grads_vs_jax(s, jax_camera(), CFG_SH, "outside the frustum",
                           leaves=(("spheres", "center"), ("spheres", "radius")))
    assert np.abs(ps.spheres.center[1]).max() > 0.0


def _dark_scene():
    """A ceiling slab between the scene and the light: every floor and
    sphere pixel is in full shadow (vis at the 1e-7 floor), so the sweep's
    all-dark early-out skips the sphere occluders listed after it."""
    s = jax_scene(True)
    return JS.add_plane(s, (0.0, 20.0, 20.0), (0.0, -1.0, 0.0), (80.0, 80.0, 80.0), 400.0, 400.0)


def test_full_darkness_fires_the_early_out():
    scene, cam = _dark_scene(), jax_camera()
    ts, tc = _port(scene, cam)
    spec = SK.SoftSpec(CFG_SH, TAU)
    sph, pl, camv = SK._packed(ts, tc)
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    out, gates, counts = SH.soft_sh_stats(sph, pl, camv, lists, shl, spec=spec)
    vis = SK.tile_view(out[SH.SO_VIS], spec.bh, spec.bw)
    dark = (vis <= SH.VIS_EARLY_OUT).all(dim=1)
    assert dark.any()
    relevant = gates[:, 1].sum(dim=1)
    assert (counts[dark, 1] < relevant[dark]).any()  # occluders skipped in dark tiles
    _check_forward(scene, cam, CFG_SH, "full darkness")
    _mse_grads_vs_jax(scene, cam, CFG_SH, "full darkness",
                      leaves=(("spheres", "center"), ("planes", "center")))


@pytest.mark.parametrize("posed", [False, True], ids=["level", "pitched"])
def test_culling_is_conservative_with_shadows(posed):
    """Culled (lists + block gates + early-out) against cull=False, with the
    tolerances of tests/test_pallas_soft.py:300-326 plus a count check."""
    cfg = CFG_SH.replace(max_spheres=24)
    ts = TS.random_scene(24, max_spheres=24, max_planes=4, seed=7)
    tc = TC.camera_from_numpy(JCamera(pos=np.array([1.0, 2.0, -4.0], np.float32),
                                      rot=np.array([0.2, 3.0, 0.0], np.float32))) if posed \
        else TC.default_camera()
    fc = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU, cull=True)
    fn = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU, cull=False)
    np.testing.assert_allclose(fc.rgb.numpy(), fn.rgb.numpy(), rtol=0, atol=1e-2)
    np.testing.assert_allclose(fc.depth.numpy(), fn.depth.numpy(), rtol=1e-5, atol=1e-3)
    assert (np.abs(fc.rgb.numpy() - fn.rgb.numpy()) > 2e-3).mean() < 1e-3


# -- K4-stats --------------------------------------------------------------------------

def test_k4_stats_match_jax_diagnostics():
    """At JAX's tile shape (the plain version takes any tile), K4-stats'
    per-tile culled-in and applied-occluder counts and the list lengths
    equal soft_tile_diagnostics'."""
    scene, cam = _crowd(8, seed=5), jax_camera()
    cfg = CFG_SH.replace(max_spheres=16)
    bh, bw = _pick_tiles(cfg, None, None)
    dj = j_diag(scene, cam, cfg, tau=TAU)
    ts, tc = _port(scene, cam)
    spec = SK.SoftSpec(cfg, TAU, bh=bh, bw=bw)
    sph, pl, camv = SK._packed(ts, tc)
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    _, _, counts = SH.soft_sh_stats_plain(sph, pl, camv, lists, shl, spec=spec)
    np.testing.assert_array_equal(counts[:, 0].numpy(), dj["main_applied"])
    np.testing.assert_array_equal(counts[:, 1].numpy(), dj["shadow_applied"])
    np.testing.assert_array_equal(lists[:, 0, 0].numpy(), dj["list_len"])
    assert (shl[:, 0, 0].numpy() >= dj["shadow_list_len"]).all()
    d = SH.soft_tile_diagnostics(ts, tc, cfg, tau=TAU)
    Ti, Tj = SK.SoftSpec(cfg, TAU).grid
    assert d["bh"] == d["bw"] == 16 and d["n_planes"] == 1
    assert d["main_applied"].shape == d["list_len"].shape == (Ti * Tj,)


# -- port-only checks -----------------------------------------------------------------

def test_gate_row_one_zero_where_unlisted():
    cfg = CFG_SH.replace(max_spheres=24)
    ts = TS.random_scene(24, max_spheres=24, max_planes=4, seed=7)
    spec = SK.SoftSpec(cfg, TAU)
    sph, pl, cam = SK._packed(ts, TC.default_camera())
    lists, shl = SH.build_lists(sph, pl, cam, spec, True)
    _, gates = SH.soft_sh_fwd(sph, pl, cam, lists, shl, spec=spec)
    ns = sph.shape[1]
    listed = torch.zeros((lists.shape[0], ns), dtype=torch.bool)
    for t in range(lists.shape[0]):
        listed[t, shl[t, 0, 1:1 + shl[t, 0, 0]].long()] = True
    assert (gates[:, 1, :ns][~listed] == 0).all()
    assert gates[:, 1, :ns][listed].any()
    n_pl = int(cam[0, 13].item())
    assert (gates[:, :, ns + n_pl:] == 0).all()


def test_k6_equals_k4_plus_k5_tables():
    """The plain K6 partials against K5's under the MSE cotangents of K4's
    planes (same lists, gates and arithmetic)."""
    cfg = CFG_SH
    ts, tc = _port(jax_scene(True), jax_camera())
    spec = SK.SoftSpec(cfg, TAU)
    sph, pl, cam = SK._packed(ts, tc)
    lists, shl = SH.build_lists(sph, pl, cam, spec, True)
    offsets, _, sh_offsets, _, _ = SK.entry_tables(lists, shl)
    out, gates = SH.soft_sh_fwd(sph, pl, cam, lists, shl, spec=spec)
    Hp, Wp = spec.extent
    tgt = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (3, Hp, Wp)).astype(np.float32))
    H, W = cfg.height, cfg.width
    g = torch.zeros_like(out)
    g[:3, :H, :W] = torch.tensor(2.0 / (255.0 ** 2 * 3 * H * W)) * (out[:3, :H, :W] - tgt[:, :H, :W])
    a = SH.soft_sh_mse(sph, pl, cam, lists, shl, offsets, sh_offsets, tgt, spec=spec)
    b = SH.soft_sh_bwd(sph, pl, cam, lists, shl, offsets, sh_offsets, gates, out, g, spec=spec)
    for x, y, name in zip(a, b, ("pvals", "psh", "ppl", "ptf")):
        if name == "ptf":
            x, y = x[:, :12], y[:, :12]
        assert rel_err(x.numpy(), y.numpy()) < 2e-5 or y.abs().max() == 0, name
    assert a[1].abs().max() > 0  # the occluder's partials are there


# -- K6's tile classes --------------------------------------------------------------------

def _k6_lists(name):
    """(spec, sph, pl, cam, lists, shl) of `fit_1080p_s20.shadowed_mse`'s
    scene at its constants (the bench headline), or of the slab crowd at
    320x96, where some tiles list no sphere."""
    if name == "headline":
        cfg = RenderConfig(width=1920, height=1080, max_spheres=20, max_planes=4, shadows=True,
                           soft_miss_penalty=300.0, soft_mask_k=10.0)
        ts, tc = TS.random_scene(20, max_spheres=20, max_planes=4, seed=0), TC.default_camera()
    else:
        cfg = CFG_SH.replace(width=320, height=96, max_spheres=48)
        ts, tc = _port(_slab_crowd(), jax_camera())
    spec = SK.SoftSpec(cfg, TAU)
    sph, pl, cam = SK._packed(ts, tc)
    return (spec, sph, pl, cam) + SH.build_lists(sph, pl, cam, spec, True)


@pytest.mark.parametrize("name", ["headline", "slab crowd"])
def test_k6_tile_classes_cover_every_tile_once(name):
    """K6's split (`tile_classes`, the kernels' rule): the plane-only class
    is the tiles whose view list and shadow list are both empty, in tile
    order; the other class is the rest, in tile order; every tile is in one
    class once. At the headline two thirds of the tiles are plane-only
    (PERF.md section 6)."""
    *_, lists, shl = _k6_lists(name)
    T = lists.shape[0]
    po, full = SH.tile_classes(lists, shl)
    mask = (lists[:, 0, 0] == 0) & (shl[:, 0, 0] == 0)
    assert torch.equal(po.long(), torch.nonzero(mask).flatten())
    assert torch.equal(full.long(), torch.nonzero(~mask).flatten())
    assert torch.equal(torch.sort(torch.cat([po, full])).values, torch.arange(T, dtype=torch.int32))
    assert po.numel() > 0 and full.numel() > 0
    if name == "headline":
        assert (T, po.numel()) == (8160, 5497)


def test_k6_wrapper_counts_its_tiles_by_class():
    """A plain K6 call adds its classes' sizes to the counters
    `k6.tiles_plane_only` and `k6.tiles_full` of telemetry.counters()."""
    spec, sph, pl, cam, lists, shl = _k6_lists("slab crowd")
    offsets, _, sh_offsets, _, _ = SK.entry_tables(lists, shl)
    tgt = torch.zeros((3,) + spec.extent)
    before = telemetry.counters()
    SH.soft_sh_mse(sph, pl, cam, lists, shl, offsets, sh_offsets, tgt, spec=spec)
    after = telemetry.counters()
    mask = (lists[:, 0, 0] == 0) & (shl[:, 0, 0] == 0)
    n_po = int(mask.sum())
    assert after["k6.tiles_plane_only"] - before["k6.tiles_plane_only"] == n_po
    assert after["k6.tiles_full"] - before["k6.tiles_full"] == lists.shape[0] - n_po


def _enum_values(body: str) -> dict:
    """A C enum's body as {name: value}."""
    out, nxt = {}, 0
    for item in (x.strip() for x in re.sub(r"//[^\n]*", "", body).split(",")):
        if not item:
            continue
        name, _, expr = (x.strip() for x in item.partition("="))
        nxt = eval(expr, {}, dict(out)) if expr else nxt
        out[name] = nxt
        nxt += 1
    return out


def test_k6_split_matches_the_cuda_source():
    """K6's work buffer header and C entry's pointer count mirror
    csrc/soft_shadow.cu; `k6_shared_bytes` equals `k6_smem` (evaluated from
    its source, the stash's size from soft_block.cuh's StashField); the
    plane-only variant is built for K6_LEAN_MIN_BLOCKS blocks an SM, at
    least 4 and more than the full kernel's K6_MIN_BLOCKS, and that many of
    its blocks fit an SM's 228 KB of shared memory at the headline and at
    4K / 200, each with its static shared memory and the 1 KB the runtime
    keeps a block."""
    src = os.path.join(os.path.dirname(SK.__file__), "..", "csrc")
    with open(os.path.join(src, "soft_shadow.cu")) as f:
        shadow = f.read()
    with open(os.path.join(src, "soft_block.cuh")) as f:
        block = f.read()
    stash = _enum_values(re.search(r"enum StashField \{(.*?)\};", block, re.S).group(1))
    assert stash["ST_FIELDS"] == SH.ST_FIELDS
    assert re.search(r"constexpr int K6_WORK_HEADER = (\d+);", shadow).group(1) == str(
        SH.K6_WORK_HEADER)
    entry = re.search(r'extern "C" int rtwc_soft_sh_mse\((.*?)\)', shadow, re.S).group(1)
    pointers = [a for a in entry.split(",")
                if "*" in a and "SoftParams" not in a and "stream" not in a]
    assert len(pointers) == SK.C._ENTRIES["rtwc_soft_sh_mse"][1]
    body = re.search(r"inline size_t k6_smem\(const SoftParams& p, bool plane_only\) \{(.*?)\n\}",
                     shadow, re.S).group(1)
    lists = re.search(r"const size_t lists = plane_only \? 0\s*:(.*?);", body, re.S).group(1)
    total = re.search(r"return (.*?);", body, re.S).group(1)

    def ev(expr, env):
        expr = re.sub(r"sizeof\((?:float|int)\)", "4", expr).replace("(size_t)", "")
        expr = re.sub(r"\(([^()?]*)\?([^():]*):([^()]*)\)", r"((\2) if (\1) else (\3))",
                      expr.replace("p.", ""))
        return eval(" ".join(expr.split()), {}, env)

    full_blocks = int(re.search(r"K6_MIN_BLOCKS = (\d+);", shadow).group(1))
    lean_blocks = int(re.search(r"constexpr int K6_LEAN_MIN_BLOCKS = (\d+);", shadow).group(1))
    assert lean_blocks >= 4 and lean_blocks > full_blocks
    static = 4 * (8 * 13 * 2) + 4 * (32 * 8 * 11) + 8 * 32 + 4 * 32 + 4  # Reduce, Slab, the claim
    for ns, n_planes, stride in ((20, 4, 21), (200, 4, 201), (1, 1, 2), (48, 2, 49)):
        for plane_only in (False, True):
            env = dict(ns=ns, np=n_planes, list_stride=stride, PL_ROWS=SK.P.PL_ROWS, NC=SH.NC,
                       STAGED=SH.STAGED, MAX_THREADS=SK.C.MAX_THREADS, ST_FIELDS=SH.ST_FIELDS,
                       plane_only=plane_only)
            env["lists"] = 0 if plane_only else ev(lists, env)
            got = SH.k6_shared_bytes(ns, n_planes, stride, plane_only)
            assert ev(total, env) == got, (ns, n_planes, stride, plane_only)
            if plane_only and ns in (20, 200):
                assert lean_blocks * (got + static + 1024) <= 228 * 1024


def test_reduction_adds_shadow_entries():
    rng = np.random.default_rng(6)
    ns, T = 5, 40
    pvals = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    pidx = torch.from_numpy(rng.integers(0, ns, 300).astype(np.int32))
    psh = torch.from_numpy(rng.normal(size=(700, 4)).astype(np.float32))
    pshidx = torch.from_numpy(rng.integers(0, ns, 700).astype(np.int32))
    ppl = torch.zeros((T, 1, 12))
    ptf = torch.zeros((T, SK.NTF, 2))
    dsph, _, _ = SK.soft_grad_reduce(pvals, pidx, ppl, ptf, ns, psh=psh, pshidx=pshidx)
    for k in range(ns):
        want = pvals[pidx == k].double().sum(0)[:7]
        want[:4] += psh[pshidx == k].double().sum(0)
        np.testing.assert_allclose(dsph[:7, k].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        SK.soft_grad_reduce(pvals, pidx, ppl, ptf, ns, psh=psh)


@pytest.mark.parametrize("which", ["unshadowed", "shl"])
def test_shadow_wrappers_reject_bad_inputs(which):
    ts, tc = _port(jax_scene(True), jax_camera())
    spec = SK.SoftSpec(CFG_SH, TAU)
    sph, pl, cam = SK._packed(ts, tc)
    lists, shl = SH.build_lists(sph, pl, cam, spec, True)
    with pytest.raises(ValueError):
        if which == "unshadowed":
            SH.soft_sh_fwd(sph, pl, cam, lists, shl, spec=SK.SoftSpec(CFG, TAU))
        else:
            SH.soft_sh_fwd(sph, pl, cam, lists, shl[:1], spec=spec)


# -- the entry point ----------------------------------------------------------------------

def _jax_cfg(cfg: RenderConfig) -> JRenderConfig:
    return JRenderConfig(width=cfg.width, height=cfg.height, max_spheres=cfg.max_spheres,
                         max_planes=cfg.max_planes, soft_miss_penalty=cfg.soft_miss_penalty,
                         soft_mask_k=cfg.soft_mask_k, shadows=cfg.shadows)


def test_fit_from_shadow_entry_point_and_first_step(capsys):
    rc = FS.main(["--device", "cpu", "--width", "64", "--height", "32", "--steps", "3"])
    out = capsys.readouterr().out
    assert rc in (0, 1)  # three steps need not converge
    assert float(re.search(r"contribution \(unshadowed\): (\S+)", out).group(1)) < 1e-3
    assert "FIT" in out.splitlines()[-1]
    # the first step's loss and (x, z) gradient against JAX's value_and_grad
    cfg, ts = FS.build(64, 32)
    cam = TC.default_camera()
    with torch.no_grad():
        target = SK.render_frame_soft_kernel(ts, cam, cfg, tau=0.5).rgb
    xz = (torch.tensor([FS.TRUE_OCCLUDER[0], FS.TRUE_OCCLUDER[2]]) + torch.tensor([3.0, 4.0]))
    xz.requires_grad_(True)
    lt = FS.image_loss(FS.scene_at(ts, xz), cam, cfg, 0.5, target)
    lt.backward()
    js = JS.Scene(
        spheres=JS.Spheres(**{f: jnp.asarray(getattr(ts.spheres, f).numpy()) for f in
                              ("center", "radius", "color", "speed", "mover", "active")}),
        planes=JS.Planes(**{f: jnp.asarray(getattr(ts.planes, f).numpy()) for f in
                            ("center", "normal", "color", "width", "height", "active")}))
    jcam = JCamera(pos=jnp.asarray(cam.pos.numpy()), rot=jnp.asarray(cam.rot.numpy()))
    jcfg = _jax_cfg(cfg)
    tgt = jnp.asarray(target.numpy())

    def j_loss(v):
        c = jnp.stack([v[0], jnp.float32(FS.TRUE_OCCLUDER[1]), v[1]])
        sc = js.replace(spheres=js.spheres.replace(center=js.spheres.center.at[FS.OCCLUDER].set(c)))
        fb = j_render(sc, jcam, jcfg, tau=0.5)
        return jnp.mean(((fb.rgb - tgt) / 255.0) ** 2)

    lj, gj = jax.value_and_grad(j_loss)(jnp.asarray(xz.detach().numpy()))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-4)
    assert np.abs(xz.grad.numpy()).max() > 0
    assert_close_tree(np.asarray(gj), xz.grad.numpy(), atol=1e-9, what="occluder (x, z)")
