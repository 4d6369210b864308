"""rtwc_tpu_torch soft kernels K1 / K2 / K3 and the gradient reduction, run
as their plain torch versions on the CPU (the wrappers run them for CPU
tensors), against the JAX package: `render_frame_soft_pallas` and
`render_soft_mse_loss` in interpret mode, `jax.vjp` of the
`_make_object_fns` closures, and the port's own torch soft renderer.

Tolerances, and why:
- the hand-written adjoints against jax.vjp and torch autograd, per
  pixel: 1e-5 of each gradient's largest magnitude (float32 reassociation
  in the reverse sweep), a sphere's ray cotangent normal to the ray, in
  float32 away from the sphere's silhouette and in float64 on every ray
  (its discriminant's formula differs from JAX's, `_check_vjp`);
- forward planes against JAX's Pallas render: the rule of
  tests/test_torch_softmin.py (atol 2e-3 / 1e-3 / 1e-4 for rgb / depth /
  normal; XLA's FMA contraction moves < 0.5 % of the values further, never
  further from a float64 render than JAX's own worst value); against the
  port's torch soft renderer, with which it shares the arithmetic, the
  plain tolerances of tests/test_pallas_soft.py:32-37;
- gradients against jax.grad of the generic Pallas loss: _assert_close_tree
  (rtol 2e-2, atol 1e-6);
- K3: loss rtol 1e-6 against JAX; gradients 2e-5 of each table's max
  against the port's own generic path (same arithmetic), and against JAX's
  fused loss at the generic-gradient tolerance, because FMA-moved
  silhouette pixels shift single contributions by ~5e-4 of the max;
- the two-float reduction: 1e-10 relative of the float64 sum
  (tests/test_pallas_soft.py:267-297); every sum of the plain reduction
  within the rounding bound of its summation order."""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.render.pallas_soft import _make_object_fns, _make_raygen
from rtwc_tpu.render.pallas_soft import render_frame_soft_pallas as j_render
from rtwc_tpu.render.pallas_soft import render_soft_mse_loss as j_mse
from rtwc_tpu_torch.render import _cuda
from rtwc_tpu_torch.render import pack as TP
from rtwc_tpu_torch.render import soft_core as C
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.render.softmin import render_frame_soft as t_soft
from test_torch_softmin import (CFG, LEAVES, TAU, assert_close_tree, assert_soft_fb_close,
                                camera64, fb_arrays, jax_camera, jax_scene, loss_of, scene64)

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False  # no TF32 anywhere
torch.backends.cudnn.allow_tf32 = False

POSED = JC.Camera(pos=jnp.asarray([1.0, 2.0, -4.0], jnp.float32),
                  rot=jnp.asarray([0.2, 3.0, 0.0], jnp.float32))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# -- the hand-written adjoints ----------------------------------------------------

def _obj_inputs(seed, n=(8, 16)):
    """Rays through a sphere's silhouette and a plane's edge region."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=n + (3,)).astype(np.float32) * 0.15 + np.array([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return rng, tuple(np.ascontiguousarray(d[..., i]) for i in range(3))


def normal_to(d, g):
    """The components of the cotangents g [3] normal to the rays d [3]."""
    g = [np.asarray(x, np.float64) for x in g]
    gd = sum(a * np.asarray(b, np.float64) for a, b in zip(g, d))
    return [a - gd * np.asarray(b, np.float64) for a, b in zip(g, d)]


SILHOUETTE_K = 32.0


def silhouette(scalars, rays, k=SILHOUETTE_K):
    """The rays at which JAX's sphere discriminant b^2 - 4c cancels more
    than log2(k) of float32's 24 bits, b^2 > k |b^2 - 4c| in float64 (the
    sphere's centre and radius lead `scalars`, the ray origin ends them).
    There JAX's float32 rounding of b^2 - 4c, about u b^2, moves the
    outputs past the tolerances, and the port's 4 (r^2 - q . q) rounds
    otherwise (render/soft_objects.py `sphere_solve`)."""
    oc = [o - c for o, c in zip(scalars[-3:], scalars[:3])]
    d = [np.asarray(x, np.float64) for x in rays]
    b = 2.0 * sum(a * o for a, o in zip(d, oc))
    disc = b * b - 4.0 * (sum(o * o for o in oc) - scalars[3] ** 2)
    return b * b > k * np.abs(disc)


def _check_vjp(kind, scalars, rays, cts, cfg, tau, tol=1e-5, vis=None, k=SILHOUETTE_K):
    """Every input as a per-pixel plane (the plain kernels gather a list
    slot's object per pixel), so JAX's vjp returns per-pixel cotangents,
    not sums over pixels. Both sides run in float32 and are held at tol on
    every ray but a sphere's silhouette rays (`silhouette`, with k). A
    sphere runs again in float64 on both sides, on every ray, at tol (the
    port's plain functions take float64 tensors, JAX's closures run under
    jax_enable_x64; the scalars as float64, the rays made unit in
    float64), which compares the formulas and not their float32 roundings.
    A sphere's ray cotangent is compared normal to the ray: its
    discriminant is 4 (r^2 - q . q) in the port and b^2 - 4c in JAX, equal
    for a unit ray, so their derivatives in the ray differ along it, which
    raygen's VJP projects out. Returns the float32 adjoints for the
    caller's autograd check."""
    c = O.SoftConsts.make(cfg, tau)
    ns = len(scalars) - 3  # object scalars before the rays
    shape = rays[0].shape
    sphere = kind == "sphere"
    tf = O.sphere_f if sphere else O.plane_f
    tvjp = O.sphere_f_vjp if sphere else O.plane_f_vjp
    far = ~silhouette(scalars, rays, k) if sphere else np.ones(shape, bool)
    for dt in (np.float32, np.float64) if sphere else (np.float32,):
        d = [np.asarray(x, dt) for x in rays]
        if dt is np.float64:
            norm = np.sqrt(sum(x * x for x in d))
            d = [x / norm for x in d]
        m = far if dt is np.float32 else np.ones(shape, bool)
        planes = [np.full(shape, v, dt) for v in scalars[:ns]] + d + \
                 [np.full(shape, v, dt) for v in scalars[ns:]]
        with jax.enable_x64(dt is np.float64):
            fns = _make_object_fns(cfg, tau)
            jf = fns.sphere_f if sphere else fns.plane_f
            vj = None if vis is None else jnp.asarray(vis.astype(dt))
            vals, vjp = jax.vjp(lambda *a: jf(*a, vis=vj), *(jnp.asarray(x) for x in planes))
            gj = [np.asarray(g) for g in vjp(tuple(jnp.asarray(x, dt) for x in cts))]
            vals = [np.asarray(v) for v in vals]
        targs = [torch.from_numpy(x) for x in planes]
        tv = None if vis is None else torch.from_numpy(vis.astype(dt))
        got = tvjp(c, *targs, tuple(torch.from_numpy(x.astype(dt)) for x in cts), vis=tv)
        if dt is np.float32:
            out = (c, targs, got)
        if not m.any():
            continue  # every ray a silhouette ray: float64 alone
        for a, b in zip(tf(c, *targs, vis=tv), vals):
            np.testing.assert_allclose(a.numpy()[m], b[m], rtol=1e-5, atol=1e-4)
        gt = [a.numpy() for a in got]
        if sphere:
            gt[7:10], gj[7:10] = normal_to(d, gt[7:10]), normal_to(d, gj[7:10])
        for i, (a, b) in enumerate(zip(gt, gj)):
            a, b = a[m], b[m]
            assert rel_err(a, b) <= tol or np.abs(a - b).max() < 1e-9, (kind, dt.__name__, i)
    return out


def _cts(rng, shape):
    return tuple(rng.normal(size=shape).astype(np.float32) for _ in range(8))


@pytest.mark.parametrize("kind", ["sphere", "plane"])
@pytest.mark.parametrize("seed", [0, 1])
def test_adjoints_match_jax_vjp_and_autograd(kind, seed):
    cfg = CFG
    rng, rays = _obj_inputs(seed)
    if kind == "sphere":
        scalars = (0.5, 0.3, 20.0, 3.0, 200.0, 40.0, 90.0, 0.1, -0.2, 0.3)
    else:
        scalars = (0.0, -3.0, 30.0, 0.1, 1.0, 0.05, 4.0, 40.0, 100.0, 120.0, 80.0, 0.2, 1.0, 0.0)
    cts = _cts(rng, rays[0].shape)
    c, targs, gt = _check_vjp(kind, scalars, rays, cts, cfg, TAU)
    # torch autograd of the same plain forward (no ties at these inputs)
    leaves = [a.clone().requires_grad_(True) for a in targs]
    f = O.sphere_f if kind == "sphere" else O.plane_f
    outs = f(c, *leaves)
    torch.autograd.backward(outs, tuple(torch.from_numpy(x) for x in cts))
    for i, (a, b) in enumerate(zip(gt, leaves)):
        assert rel_err(a.numpy(), b.grad.numpy()) <= 1e-5 or \
            np.abs(a.numpy() - b.grad.numpy()).max() < 1e-9, (kind, i)


def test_adjoints_at_ties():
    """JAX's tie rules where a tie is reachable: t2 exactly 0 and exactly
    far (clip), r exactly 1e-3 (maximum), and a plane hit exactly at its
    centre column (abs)."""
    cfg = CFG
    one = np.ones((1, 1), np.float32)
    z = np.zeros((1, 1), np.float32)
    rays = (z, z, one)  # d = (0, 0, 1)
    rng = np.random.default_rng(5)
    # t2 == 0: origin on the sphere's near surface (c = 0 exactly)
    _check_vjp("sphere", (0.0, 0.0, 2.0, 2.0, 100.0, 100.0, 100.0, 0.0, 0.0, 0.0),
               rays, _cts(rng, (1, 1)), cfg, TAU)
    # t2 == far: 0.5 * (520 - 20) = 250; b^2 = 676 |b^2 - 4c|, but every
    # value is an integer that float32 holds exactly, so float32 holds too
    _check_vjp("sphere", (0.0, 0.0, 260.0, 10.0, 100.0, 100.0, 100.0, 0.0, 0.0, 0.0),
               rays, _cts(rng, (1, 1)), cfg, TAU, k=np.inf)
    # r == 1e-3 in float32: scale = 1e3 makes the radius cotangent a sum of
    # ~1e6-sized terms that cancel, so it holds to 1e-3 here. b^2 = 100 and
    # b^2 - 4c = 4e-6: JAX's float32 t is 3.8e-4 short of 4.999, so this
    # one ray is held in float64 alone
    _check_vjp("sphere", (0.0, 0.0, 5.0, float(np.float32(1e-3)), 100.0, 100.0, 100.0,
                          0.0, 0.0, 0.0), rays, _cts(rng, (1, 1)), cfg, TAU, tol=1e-3)
    # |px - pcx| == 0: ray straight down onto the plane's centre
    down = (z, -one, z)
    _check_vjp("plane", (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 4.0, 4.0, 100.0, 120.0, 80.0,
                         0.0, 5.0, 0.0), down, _cts(rng, (1, 1)), cfg, TAU)
    c = O.SoftConsts.make(cfg, TAU)
    t = torch.tensor([0.0, c.far])
    assert O.clip_grad(t, 0.0, c.far).tolist() == [0.5, 0.5]
    assert O.abs_grad(torch.tensor([0.0])).item() == 1.0


def test_raygen_and_its_vjp_match_jax():
    cfg = CFG
    bh, bw = 16, 16
    c = O.SoftConsts.make(cfg, TAU)
    cam = np.asarray(TP.pack_camera(TC.camera_from_numpy(POSED)))[0]
    raygen = _make_raygen(cfg, bh, bw)
    i, j = jnp.int32(1), jnp.int32(2)
    cam9 = [jnp.float32(v) for v in cam[3:12]]
    jout, vjp = jax.vjp(lambda *b: raygen.full(i, j, jnp.float32(0.0), *b)[:3], *cam9)
    rowf = (torch.arange(bh, dtype=torch.float32)[:, None] + 16.0).expand(bh, bw)
    colf = (torch.arange(bw, dtype=torch.float32)[None, :] + 32.0).expand(bh, bw)
    tout = O.raygen(c, rowf, colf, tuple(torch.tensor(v) for v in cam[3:12]))
    for a, b in zip(tout[:3], jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(2)
    g = [rng.normal(size=(bh, bw)).astype(np.float32) for _ in range(3)]
    gj = vjp(tuple(jnp.asarray(x) for x in g))
    gt = O.raygen_vjp(*(torch.from_numpy(x) for x in g), *tout)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.sum().item(), float(b), rtol=1e-4, atol=1e-6)


# -- K1 ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_fwd():
    scene, cam = jax_scene(False), jax_camera()
    return scene, cam, j_render(scene, cam, CFG, tau=TAU)


def _torch_inputs(scene, cam, **kw):
    return TS.scene_from_numpy(scene, **kw.get("s", {})), TC.camera_from_numpy(cam, **kw.get("c", {}))


def test_k1_matches_jax_pallas(jax_fwd):
    scene, cam, fb_j = jax_fwd
    ts, tc = _torch_inputs(scene, cam)
    n = dict(SK.LAUNCHES)
    fb = SK.render_frame_soft_kernel(ts, tc, CFG, tau=TAU)
    assert SK.LAUNCHES == n  # CPU tensors: plain versions, no launch
    fb64 = t_soft(scene64(ts), camera64(tc), CFG, tau=TAU)
    assert_soft_fb_close(fb_arrays(fb), fb_arrays(fb_j), fb_arrays(fb64), "K1")
    np.testing.assert_allclose(fb.alpha.numpy(), np.asarray(fb_j.alpha), atol=1e-4)


@pytest.mark.parametrize("size", [(96, 32), (97, 33)], ids=["96x32", "97x33"])
def test_k1_with_pitch_matches_torch_soft_renderer(size):
    """A pitched camera over more than one tile row, and a ragged image:
    the JAX Pallas lists are wrong with pitch (ROADMAP queue 3), so the
    reference is the port's torch soft renderer."""
    cfg = CFG.replace(width=size[0], height=size[1])
    ts, tc = _torch_inputs(jax_scene(False), POSED)
    assert SK.SoftSpec(cfg, TAU).grid[0] >= 2
    fb = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU)
    ref = t_soft(ts, tc, cfg, tau=TAU)
    assert fb.rgb.shape == (size[1], size[0], 3)
    assert ref.hit.any()
    np.testing.assert_allclose(fb.rgb.numpy(), ref.rgb.numpy(), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(fb.depth.numpy(), ref.depth.numpy(), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(fb.normal.numpy(), ref.normal.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(fb.alpha.numpy(), ref.alpha.numpy(), atol=1e-5)


def test_k1_count_below_capacity():
    s = JS.empty_scene(8, 4)
    s = JS.add_sphere(s, 4.0, (2.0, 0.0, 15.0), (10.0, 220.0, 10.0), speed=1.0)
    cfg = CFG.replace(max_spheres=8, max_planes=4)
    ts, tc = _torch_inputs(s, jax_camera())
    fb = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU)
    ref = t_soft(ts, tc, cfg, tau=TAU)
    fj = j_render(s, jax_camera(), cfg, tau=TAU)
    np.testing.assert_allclose(fb.rgb.numpy(), ref.rgb.numpy(), atol=2e-3, rtol=1e-4)
    fb64 = t_soft(scene64(ts), camera64(tc), cfg, tau=TAU)
    assert_soft_fb_close(fb_arrays(fb), fb_arrays(fj), fb_arrays(fb64), "K1 count < capacity")


def test_gates_zero_where_unlisted():
    cfg = CFG.replace(max_spheres=24)
    ts = TS.random_scene(24, max_spheres=24, max_planes=4, seed=7)
    spec = SK.SoftSpec(cfg, TAU)
    sph, pl, cam = SK._packed(ts, TC.default_camera())
    lists = SK.build_lists(sph, cam, spec, True)
    _, gates = SK.soft_fwd(sph, pl, cam, lists, spec=spec)
    listed = torch.zeros((lists.shape[0], sph.shape[1]), dtype=torch.bool)
    for t in range(lists.shape[0]):
        listed[t, lists[t, 0, 1:1 + lists[t, 0, 0]].long()] = True
    assert (gates[:, 0, :sph.shape[1]][~listed] == 0).all()
    assert (gates[:, 1] == 0).all()
    assert gates[:, 0, :sph.shape[1]][listed].any()  # some listed sphere is gated in
    n_pl = int(cam[0, TP.C_NPL].item())
    assert (gates[:, 0, sph.shape[1] + n_pl:] == 0).all()


@pytest.mark.parametrize("posed", [False, True], ids=["level", "pitched"])
def test_culling_is_conservative(posed):
    """Culled (broad-phase lists + block gates) against cull=False on
    random_scene(24), with the tolerances of tests/test_pallas_soft.py:300-326,
    plus a count check: values off by more than 2e-3 stay below 0.1 %."""
    cfg = CFG.replace(max_spheres=24)
    for seed in (0, 7):
        ts = TS.random_scene(24, max_spheres=24, max_planes=4, seed=seed)
        tc = TC.camera_from_numpy(POSED) if posed else TC.default_camera()
        fc = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU, cull=True)
        fn = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU, cull=False)
        np.testing.assert_allclose(fc.rgb.numpy(), fn.rgb.numpy(), rtol=0, atol=1e-2)
        np.testing.assert_allclose(fc.depth.numpy(), fn.depth.numpy(), rtol=1e-5, atol=1e-3)
        assert (np.abs(fc.rgb.numpy() - fn.rgb.numpy()) > 2e-3).mean() < 1e-3


# -- K2 ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_generic_grads():
    scene, cam = jax_scene(False), jax_camera()
    g = jax.grad(lambda s, c: loss_of(j_render(s, c, CFG, tau=TAU), jnp), argnums=(0, 1))(scene, cam)
    return scene, cam, g


def _port_grads(scene, cam, render, cfg=CFG, loss=None):
    ts = TS.scene_from_numpy(scene, requires_grad=("all",))
    tc = TC.camera_from_numpy(cam, requires_grad=("all",))
    value = loss(ts, tc) if loss is not None else loss_of(render(ts, tc, cfg, tau=TAU), torch)
    value.backward()
    return value.item(), TS.scene_grads_to_numpy(ts), TC.camera_grads_to_numpy(tc)


def test_k2_grads_match_jax(jax_generic_grads):
    scene, cam, (gs, gc) = jax_generic_grads
    _, ps, pc = _port_grads(scene, cam, SK.render_frame_soft_kernel)
    for group, leaf in LEAVES:
        assert_close_tree(getattr(getattr(gs, group), leaf), getattr(getattr(ps, group), leaf),
                          what=f"{group}.{leaf}")
    assert_close_tree(gc.pos, pc.pos, what="camera pos")
    assert_close_tree(gc.rot, pc.rot, what="camera rot")
    assert np.abs(pc.rot[:2]).min() > 0


def test_k2_inactive_slots_zero_grad(jax_generic_grads):
    scene, cam, _ = jax_generic_grads
    _, ps, _ = _port_grads(scene, cam, SK.render_frame_soft_kernel)
    live = np.asarray(scene.spheres.active) > 0.5
    assert (ps.spheres.center[~live] == 0).all()
    # sphere 1 sits behind sphere 0 (JAX's gradient for it is ~1e-11); the
    # visible one must get a gradient
    assert np.abs(ps.spheres.center[0]).sum() > 0
    assert (ps.planes.center[np.asarray(scene.planes.active) < 0.5] == 0).all()


def test_k2_bwd_cull_off_matches():
    scene, cam = jax_scene(False), jax_camera()
    _, a, ac = _port_grads(scene, cam, SK.render_frame_soft_kernel)
    _, b, bc = _port_grads(scene, cam, lambda s, c, cfg, tau: SK.render_frame_soft_kernel(
        s, c, cfg, tau=tau, bwd_cull=False))
    for group, leaf in LEAVES:
        assert_close_tree(getattr(getattr(a, group), leaf), getattr(getattr(b, group), leaf),
                          rtol=1e-4, what=f"{group}.{leaf}")
    assert_close_tree(ac.rot, bc.rot, rtol=1e-4, what="camera rot")


def _slab_crowd(n=40, seed=3):
    """n spheres packed into a short depth range in front of the floor: some
    16x16 tiles gate in more objects than the SLAB slots that the card's
    backward sweeps sum at once, so their sweeps fill the slab more than
    once; others stay below it (chip_smoke.py phases 2b and 2c run the same
    scene on the card)."""
    rng = np.random.default_rng(seed)
    s = JS.empty_scene(48, 2)
    for _ in range(n):
        s = JS.add_sphere(s, float(rng.uniform(2.0, 4.0)),
                          (float(rng.uniform(-3, 3)), float(rng.uniform(-1.5, 1.5)),
                           float(rng.uniform(20, 27))),
                          tuple(float(c) for c in rng.uniform(30, 220, 3)), speed=1.0)
    return JS.add_plane(s, (0.0, -3.0, 30.0), (0.0, 1.0, 0.0), (100.0, 100.0, 100.0), 60.0, 60.0)


def test_k2_k3_on_the_slab_crowd_match_jax():
    """The slab crowd without shadows: tiles that gate more objects than the
    card's SLAB slab slots, so K2 and K3 flush the slab in mid-sweep there.
    The plain K2 (the generic path) and K3, against mse_case's uniform(0,
    255) target (the target that showed the shadowed slab crowd's drift)
    and a zero target, against JAX's unshadowed Pallas path, every leaf at
    test_torch_shadow_kernel's `_assert_grads` tolerances (rtol 2e-2, atol
    5e-6)."""
    from test_torch_shadow_kernel import _assert_grads

    cfg = CFG.replace(max_spheres=48)
    scene, cam = _slab_crowd(), jax_camera()
    ts, tc = _torch_inputs(scene, cam)
    spec = SK.SoftSpec(cfg, TAU)
    sph, pl, camv = SK._packed(ts, tc)
    _, gates = SK.soft_fwd(sph, pl, camv, SK.build_lists(sph, camv, spec, True), spec=spec)
    gated = gates[:, 0].sum(1)
    assert int(gated.max()) > SK.SH.SLAB >= int(gated.min())
    gj = jax.grad(lambda s, c: loss_of(j_render(s, c, cfg, tau=TAU), jnp), argnums=(0, 1))(scene, cam)
    _, ps, pc = _port_grads(scene, cam, SK.render_frame_soft_kernel, cfg=cfg)
    _assert_grads(gj, ps, pc, "K2 slab crowd")
    rand = np.random.default_rng(1).uniform(0.0, 255.0, (cfg.height, cfg.width, 3))
    for name, tgt in (("random", rand.astype(np.float32)),
                      ("zero", np.zeros((cfg.height, cfg.width, 3), np.float32))):
        gj = jax.grad(lambda s, c: j_mse(s, c, jnp.asarray(tgt), cfg, tau=TAU),
                      argnums=(0, 1))(scene, cam)
        _, fs, fc = _port_grads(scene, cam, None, loss=lambda s, c: SK.render_soft_mse_loss(
            s, c, torch.from_numpy(tgt), cfg, tau=TAU))
        _assert_grads(gj, fs, fc, f"K3 slab crowd, {name} target")


# -- K3 ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mse_case():
    scene, cam = jax_scene(False), jax_camera()
    tgt = np.random.default_rng(1).uniform(0.0, 255.0, (CFG.height, CFG.width, 3)).astype(np.float32)
    lj, gj = jax.value_and_grad(lambda s, c: j_mse(s, c, jnp.asarray(tgt), CFG, tau=TAU),
                                argnums=(0, 1))(scene, cam)
    return scene, cam, tgt, float(lj), gj


def _fused(tgt):
    return lambda s, c: SK.render_soft_mse_loss(s, c, torch.from_numpy(tgt), CFG, tau=TAU)


def _generic(tgt):
    def loss(s, c):
        fb = SK.render_frame_soft_kernel(s, c, CFG, tau=TAU)
        return torch.mean(((fb.rgb - torch.from_numpy(tgt)) / 255.0) ** 2)
    return loss


def test_k3_matches_jax_and_the_generic_path(mse_case):
    scene, cam, tgt, lj, (gs, gc) = mse_case
    lf, fs, fc = _port_grads(scene, cam, None, loss=_fused(tgt))
    lg, ps, pc = _port_grads(scene, cam, None, loss=_generic(tgt))
    np.testing.assert_allclose(lf, lj, rtol=1e-6)
    np.testing.assert_allclose(lf, lg, rtol=1e-6)
    pairs = [(getattr(getattr(fs, g), l), getattr(getattr(ps, g), l),
              getattr(getattr(gs, g), l), f"{g}.{l}") for g, l in LEAVES]
    pairs += [(fc.pos, pc.pos, gc.pos, "camera pos"), (fc.rot, pc.rot, gc.rot, "camera rot")]
    for fused, generic, jx, name in pairs:
        assert rel_err(fused, generic) < 2e-5 or np.abs(generic).max() == 0, name
        assert_close_tree(jx, fused, what=name)


def test_k3_target_cotangent(mse_case):
    scene, cam, tgt, _, _ = mse_case
    ts, tc = _torch_inputs(scene, cam)
    t = torch.from_numpy(tgt).requires_grad_(True)
    SK.render_soft_mse_loss(ts, tc, t, CFG, tau=TAU).backward()
    fb = SK.render_frame_soft_kernel(ts, tc, CFG, tau=TAU)
    want = -2.0 / (255.0 ** 2 * tgt.size) * (fb.rgb.detach() - t.detach())
    np.testing.assert_allclose(t.grad.numpy(), want.numpy(), rtol=1e-4, atol=1e-12)
    gt = jax.grad(lambda x: j_mse(scene, cam, x, CFG, tau=TAU))(jnp.asarray(tgt))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gt), rtol=1e-2, atol=1e-9)


def test_k3_no_grad_uses_k1_and_torch_loss(mse_case):
    scene, cam, tgt, lj, _ = mse_case
    ts, tc = _torch_inputs(scene, cam)
    with torch.no_grad():
        loss = SK.render_soft_mse_loss(ts, tc, torch.from_numpy(tgt), CFG, tau=TAU)
    np.testing.assert_allclose(loss.item(), lj, rtol=1e-6)


# -- the reduction ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 256), (8, 128), (32, 640), (16, 128)])
def test_twofloat_reduction_against_float64(shape):
    """Adversarially scaled values (tests/test_pallas_soft.py:291-297)
    through the block two-float sums over 16x16 tiles and the cross-block
    reduction: within 1e-10 relative of the float64 sum."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape) * 4.0)).astype(np.float32)
    hi, lo = SK.block_tf_sum_plain(SK.tile_view(torch.from_numpy(x), 16 if shape[0] % 16 == 0 else 8, 16))
    T = hi.shape[0]
    ptf = torch.stack([hi, lo], dim=-1)[:, None, :].contiguous()
    _, _, dtf = SK.soft_grad_reduce(torch.zeros((1, 8)), torch.zeros(0, dtype=torch.int32),
                                    torch.zeros((T, 0, 12)), ptf, 0)
    truth = float(np.sum(x.astype(np.float64)))
    got = float(dtf[0, 0]) + float(dtf[0, 1])
    assert abs(got - truth) <= 1e-10 * abs(truth), (shape, got, truth)
    assert abs(float(x.sum(dtype=np.float32)) - truth) > 1e-10 * abs(truth)  # plain f32 is not


def test_reduction_sums_entries_by_sphere_in_tile_order():
    rng = np.random.default_rng(3)
    n, ns, T = 1000, 5, 70
    pvals = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    pidx = torch.from_numpy(rng.integers(0, ns, n).astype(np.int32))
    ppl = torch.from_numpy(rng.normal(size=(T, 3, 12)).astype(np.float32))
    ptf = torch.zeros((T, SK.NTF, 2))
    dsph, dpl, _ = SK.soft_grad_reduce(pvals, pidx, ppl, ptf, ns)
    for k in range(ns):
        want = pvals[pidx == k].double().sum(0)[:7]
        np.testing.assert_allclose(dsph[:7, k].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert (dsph[7] == 0).all()
    np.testing.assert_allclose(dpl[:11].numpy(), ppl.double().sum(0).T[:11].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert (dpl[11] == 0).all()


def _tile_lists(rng, ns, T, most):
    """Sphere indices of T tiles' lists in tile order: each tile a random
    set of up to `most` distinct spheres, so every sphere's entries
    interleave with the others' across tiles."""
    return np.concatenate([rng.choice(ns, size=rng.integers(0, most + 1), replace=False)
                           for _ in range(T)] + [np.zeros(0, np.int64)]).astype(np.int32)


@pytest.mark.parametrize("case", ["many spheres", "shadow entries", "ragged", "empty"])
def test_reduction_against_float64_within_its_rounding_bound(case):
    """The plain reduction (the kernels' order) against float64 sums of the
    same adversarially scaled partials, each within the rounding bound of
    its summation: d u sum |x_i| for a sum whose terms pass through at
    most d float32 additions (u = 2^-24), d u^2 sum |x_i| (times 2) for
    the two-float camera sums. Cases: 40 spheres interleaved across 300
    tiles' lists; shadow-list entries; entry and tile counts off the
    chunks of RED_CHUNK entries and reduce_tile_chunk tiles; nothing."""
    rng = np.random.default_rng(11)
    u = 2.0 ** -24
    ns, T, n_sh = {"many spheres": (40, 300, 0), "shadow entries": (7, 2100, 2 * C.RED_CHUNK - 5),
                   "ragged": (3, 2100, 1), "empty": (4, 5, 0)}[case]
    pidx = (_tile_lists(rng, ns, T, 30) if case == "many spheres" else
            rng.integers(0, ns, {"shadow entries": 3 * C.RED_CHUNK + 17, "ragged": C.RED_CHUNK - 1,
                                 "empty": 0}[case]).astype(np.int32))
    n = pidx.shape[0]

    def adversarial(*shape):
        return (rng.normal(size=shape) * np.exp(rng.normal(size=shape) * 2.0)).astype(np.float32)

    pvals, psh = adversarial(max(n, 1), 8), adversarial(n_sh, 4)
    pshidx = rng.integers(0, ns, n_sh).astype(np.int32)
    ppl, x = adversarial(T, 2, 12), adversarial(T, SK.NTF)
    ptf = np.stack([x, np.zeros_like(x)], axis=-1)
    t = torch.from_numpy
    kw = dict(psh=t(psh), pshidx=t(pshidx)) if n_sh else {}
    dsph, dpl, dtf = SK.soft_grad_reduce(t(pvals), t(pidx), t(ppl), t(ptf), ns, **kw)
    assert (dsph[7] == 0).all() and (dpl[11] == 0).all()
    for k in range(ns):
        rows = pvals[:n][pidx == k, :7].astype(np.float64)
        sh = np.pad(psh[pshidx == k].astype(np.float64), ((0, 0), (0, 3)))
        terms = np.concatenate([rows, sh])
        # a block sum (5 + 7), a lane's chunks, the butterfly (5), main + shadow (1)
        chunks = (-(-m // C.RED_CHUNK) for m in (rows.shape[0], sh.shape[0]))
        lane_chunks = max(-(-c // 32) for c in chunks)
        d = 12 + lane_chunks + 5 + 1
        err = np.abs(dsph[:7, k].numpy().astype(np.float64) - terms.sum(0))
        assert (err <= d * u * np.abs(terms).sum(0)).all(), (case, k)
    tch = C.reduce_tile_chunk(T)
    d = tch // 8 + 7 + -(-(-(-T // tch)) // 32) + 5
    want = ppl.astype(np.float64).sum(0).T[:11]
    err = np.abs(dpl[:11].numpy().astype(np.float64) - want)
    assert (err <= d * u * np.abs(ppl.astype(np.float64)).sum(0).T[:11]).all(), case
    got = dtf[:, 0].double().numpy() + dtf[:, 1].double().numpy()
    err = np.abs(got - x.astype(np.float64).sum(0))
    assert (err <= 2 * d * u * u * np.abs(x.astype(np.float64)).sum(0)).all(), case


@pytest.mark.parametrize("struct, src", [("SoftParams", "soft_common.cuh"),
                                         ("ReduceParams", "soft_render.cu")])
def test_params_mirror_the_cuda_structs(struct, src):
    """The ctypes mirrors in render/soft_core.py name the C structs'
    members in their order, with their C types, so a launch reads the
    values the wrapper set."""
    with open(os.path.join(os.path.dirname(SK.__file__), "..", "csrc", src)) as f:
        body = re.search(r"struct " + struct + r" \{(.*?)\};", f.read(), re.S).group(1)
    members = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            ctype, names = decl.split(None, 1)
            for name in names.split(","):
                name = name.strip()
                n = int(name[name.index("[") + 1:-1]) if "[" in name else 0
                members.append((name.split("[")[0], ctype, n))
    fields = getattr(C, struct)._fields_
    assert [m[0] for m in members] == [f[0] for f in fields]
    for (name, ctype, n), (_, ftype) in zip(members, fields):
        base = {"int": ctypes.c_int, "float": ctypes.c_float}[ctype]
        assert ftype == (base * n if n else base) or (n and ftype._type_ is base
                                                      and ftype._length_ == n), name


def test_block_sums_follow_the_warp_order():
    x = torch.randn(3, 256)
    s = C.block_sum_plain(x)
    np.testing.assert_allclose(s.numpy(), x.double().sum(1).numpy(), rtol=1e-5, atol=1e-5)
    warps = x.reshape(3, 8, 32)
    for off in (16, 8, 4, 2, 1):
        warps = warps[..., :off] + warps[..., off:2 * off]
    manual = warps[:, 0, 0]
    for w in range(1, 8):
        manual = manual + warps[:, w, 0]
    assert torch.equal(s, manual)


# -- wrappers and the build rule -------------------------------------------------------

@pytest.mark.parametrize("which", ["dtype", "lists", "tile", "device", "target"])
def test_wrappers_reject_bad_inputs(which):
    ts, tc = _torch_inputs(jax_scene(False), jax_camera())
    spec = SK.SoftSpec(CFG, TAU)
    sph, pl, cam = SK._packed(ts, tc)
    lists = SK.build_lists(sph, cam, spec, True)
    with pytest.raises((ValueError, TypeError)):
        if which == "dtype":
            SK.soft_fwd(sph.double(), pl, cam, lists, spec=spec)
        elif which == "lists":
            SK.soft_fwd(sph, pl, cam, SK.build_lists(sph, cam, SK.SoftSpec(CFG, TAU, 8, 8), True),
                        spec=spec)
        elif which == "tile":
            bad = SK.SoftSpec(CFG, TAU, 4, 4)
            SK.soft_fwd(sph, pl, cam, SK.build_lists(sph, cam, bad, True), spec=bad)
        elif which == "device":
            SK.soft_fwd(sph, pl, cam.to("meta"), lists, spec=spec)
        else:
            SK.soft_mse(sph, pl, cam, lists, SK.entry_tables(lists).offsets,
                        torch.zeros(3, 8, 8), spec=spec)


def test_library_is_rebuilt_when_a_header_changes(tmp_path, monkeypatch):
    """_cuda.stale: the library is stale when the .cu or any csrc/*.cuh
    is newer than it (checked on a temp copy; needs no nvcc)."""
    src, build = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    build.mkdir()
    monkeypatch.setattr(_cuda, "SRC_DIR", str(src))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(build))
    (src / "k.cu").write_text("// kernel")
    (src / "common.cuh").write_text("// header")
    assert _cuda.stale("k")  # no library yet
    so = build / "libk.so"
    so.write_text("")
    os.utime(src / "k.cu", (100, 100))
    os.utime(src / "common.cuh", (100, 100))
    os.utime(so, (200, 200))
    assert not _cuda.stale("k")
    os.utime(src / "common.cuh", (300, 300))
    assert _cuda.stale("k")  # an edited header
    os.utime(so, (400, 400))
    os.utime(src / "k.cu", (500, 500))
    assert _cuda.stale("k")  # an edited source
    assert _cuda.library_path("soft_render").endswith(os.path.join("_build", "libsoft_render.so"))
