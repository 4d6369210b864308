"""The port's shadow-occluder functions and their hand-written adjoints
(render/soft_objects.py, the plain twins of csrc/soft_common.cuh) against
the JAX package's `_make_object_fns` closures and jax.vjp, per pixel.

Tolerances: values and adjoints within 1e-5 of each output's largest
magnitude (float32 reassociation in the reverse sweep), as
tests/test_torch_soft_kernel.py holds the object adjoints. XLA's CPU code
contracts b*b - 4c into an FMA and the port does not; in the penumbra a
steep sigmoid (ks = 50) turns that ulp into up to ~1e-4 of the largest
value at single pixels. There the same port functions run in float64 are
the arbiter: no port value may be farther from them than JAX's farthest
value (plus the tolerance). Ties follow
JAX's rules (jnp.minimum's 0.5 split at the exponent clamp, jnp.abs' +1 at
0, the |denom| < eps branch), and a saturated product of sigmoid factors
keeps finite gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtwc_tpu.config import RenderConfig
from rtwc_tpu.render.pallas_soft import _make_object_fns
from rtwc_tpu_torch.render import soft_objects as O
from test_torch_soft_kernel import _check_vjp

torch.set_num_threads(2)

CFG = RenderConfig(width=96, height=32, max_spheres=4, max_planes=2, soft_miss_penalty=300.0,
                   soft_mask_k=10.0, shadows=True)
TAU = 0.5


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _points(seed, center, spread, shape=(8, 16)):
    rng = np.random.default_rng(seed)
    p = np.asarray(center, np.float32) + rng.uniform(-1, 1, shape + (3,)).astype(np.float32) \
        * np.asarray(spread, np.float32)
    return tuple(np.ascontiguousarray(p[..., i]) for i in range(3))


def _close(a, b, e, tol, what):
    """a (port f32) within tol of b (JAX f32) relative to b's largest
    magnitude, or no farther from e (port f64) than b is (module note)."""
    a, b, e = (np.asarray(x, np.float64) for x in (a, b, e))
    scale = max(np.abs(b).max(), 1e-30)
    if np.abs(a - b).max() <= tol * scale or np.abs(a - b).max() < 1e-9:
        return
    worst = np.abs(b - e).max()
    assert np.abs(a - e).max() <= worst + tol * scale, (what, np.abs(a - b).max() / scale)


def _check(kind, geo, pts, cfg=CFG, seed=0, tol=1e-5):
    """shadow_{kind}_f and its adjoint against JAX, with every input a
    per-pixel plane (JAX's vjp then returns per-pixel cotangents)."""
    fns = _make_object_fns(cfg, TAU)
    c = O.SoftConsts.make(cfg, TAU)
    shape = pts[0].shape
    planes = [np.full(shape, v, np.float32) for v in geo] + list(pts)
    jf = fns.shadow_sphere_f if kind == "sphere" else fns.shadow_plane_f
    val, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in planes))
    ct = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    gj = vjp(jnp.asarray(ct))
    tf = O.shadow_sphere_f if kind == "sphere" else O.shadow_plane_f
    tvjp = O.shadow_sphere_f_vjp if kind == "sphere" else O.shadow_plane_f_vjp
    targs = [torch.from_numpy(x) for x in planes]
    args64 = [x.double() for x in targs]
    _close(tf(c, *targs).numpy(), val, tf(c, *args64).numpy(), tol, (kind, "value"))
    gt = tvjp(c, *targs, torch.from_numpy(ct))
    g64 = tvjp(c, *args64, torch.from_numpy(ct).double())
    assert len(gt) == len(planes)
    for i, (a, b, e) in enumerate(zip(gt, gj, g64)):
        assert np.isfinite(a.numpy()).all(), (kind, i)
        _close(a.numpy(), b, e.numpy(), tol, (kind, i))
    return np.asarray(val)


@pytest.mark.parametrize("seed", [0, 1])
def test_shadow_sphere_adjoint_matches_jax_vjp(seed):
    """Hit points on the floor around the occluder's penumbra, so every
    sigmoid factor is live somewhere."""
    val = _check("sphere", (0.5, 10.0, 20.0, 3.0), _points(seed, (1.0, -3.0, 21.0),
                                                          (4.0, 0.5, 4.0)), seed=seed)
    assert val.min() < 0.5 < val.max()  # umbra and lit pixels both present


@pytest.mark.parametrize("seed", [0, 1])
def test_shadow_plane_adjoint_matches_jax_vjp(seed):
    """A downward-facing slab between the floor and the light, with hit
    points under and around its edges."""
    val = _check("plane", (0.0, 15.0, 20.0, 0.1, -1.0, 0.05, 4.0, 3.0),
                 _points(seed, (0.5, -3.0, 20.0), (7.0, 0.5, 6.0)), seed=seed)
    assert val.min() < 0.5 < val.max()


def test_shadow_adjoints_at_ties():
    """|ppx - cx| = |ppz - cz| = 0 exactly (the hit point straight below the
    light and the slab's centre: jnp.abs' gradient +1), and a plane whose
    normal is perpendicular to the shadow ray (the |denom| < eps branch)."""
    below = tuple(np.full((1, 4), v, np.float32) for v in (1.0, -3.0, 0.0))
    below[1][0, 1:] = (-2.0, 0.0, 5.0)  # several heights, same column
    _check("plane", (1.0, 30.0, 0.0, 0.0, -1.0, 0.0, 2.0, 2.0), below)
    _check("plane", (1.0, 30.0, 0.0, 1.0, 0.0, 0.0, 2.0, 2.0), below)
    _check("sphere", (1.0, 30.0, 0.0, 2.0), below)  # shadow ray through the centre


def _transmittance_case(args, cfg):
    fns = _make_object_fns(cfg, TAU)
    c = O.SoftConsts.make(cfg, TAU)
    args = [np.asarray(a, np.float32) for a in args]
    val, vjp = jax.vjp(lambda *a: fns.shadow_transmittance(a), *(jnp.asarray(a) for a in args))
    ct = np.ones_like(args[0])
    gj = vjp(jnp.asarray(ct))
    targs = [torch.from_numpy(a) for a in args]
    got = O.shadow_transmittance(c, targs)
    gt = O.transmittance_vjp(c, targs, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(val), rtol=1e-6, atol=1e-7)
    for a, b in zip(gt, gj):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-12)
    return got.numpy(), [g.numpy() for g in gt]


def test_blocked_ties_and_saturation():
    """ks = 40 makes -ks * a = 20 exact at a = -0.5 (the exponent clamp's
    tie, gradient 0.5); 4 and 5 saturated factors (the 5-factor product
    overflows float32 to inf and the block is exactly 0) keep finite
    gradients that agree with JAX's."""
    cfg = CFG.replace(soft_shadow_k=40.0)
    tie = [np.array([-0.5, 0.3, -0.5]), np.array([0.2, -0.5, 0.1]), np.array([0.1, 0.2, 0.3]),
           np.array([0.05, 0.1, -0.5])]
    _transmittance_case(tie, cfg)
    c = O.SoftConsts.make(cfg, TAU)
    assert O.min_grad(torch.tensor([-c.ks * -0.5]), 20.0).item() == 0.5
    sat4 = [np.array([-3.0, -1.0]), np.array([-2.0, -0.6]), np.array([-5.0, -0.7]),
            np.array([0.3, -0.8])]
    val, grads = _transmittance_case(sat4, CFG)
    assert (val == 1.0).all()
    sat5 = [np.array([-3.0]), np.array([-2.0]), np.array([-5.0]), np.array([-1.0]),
            np.array([-4.0])]
    val, grads = _transmittance_case(sat5, CFG)
    P = np.prod([1.0 + np.exp(np.minimum(-CFG.soft_shadow_k * a, 20.0)) for a in sat5], axis=0)
    assert np.isinf(np.float32(P)).all() and (val == 1.0).all()
    assert all((g == 0.0).all() for g in grads)


def test_stage_a_then_b_is_the_whole_solve():
    """preB(preA(...)) is bit-equal to shadow_sphere_pre, and both match
    JAX's shadow_sphere_pre; the plane pre's min_arg matches JAX's."""
    fns = _make_object_fns(CFG, TAU)
    c = O.SoftConsts.make(CFG, TAU)
    px, py, pz = (torch.from_numpy(x) for x in _points(3, (1.0, -3.0, 21.0), (6.0, 1.0, 6.0)))
    lr = O.light_ray(c, px, py, pz)
    geo = tuple(torch.tensor(v) for v in (0.5, 10.0, 20.0, 3.0))
    disc, dss, b, dist = O.shadow_sphere_preA(c, *geo, lr)
    m_ab, args_ab = O.shadow_sphere_preB(disc, dss, b, dist)
    m_w, args_w = O.shadow_sphere_pre(c, *geo, lr)
    assert torch.equal(m_ab, m_w) and all(torch.equal(a, b) for a, b in zip(args_ab, args_w))
    jlr = fns.light_ray(*(jnp.asarray(x.numpy()) for x in (px, py, pz)))
    for a, b in zip(lr, jlr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    jm, jargs = fns.shadow_sphere_pre(*(float(v) for v in geo), jlr)
    np.testing.assert_allclose(m_w.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-3)
    pgeo = tuple(torch.tensor(v) for v in (0.0, 15.0, 20.0, 0.1, -1.0, 0.05, 4.0, 3.0))
    pm, pargs = O.shadow_plane_pre(c, *pgeo, lr)
    jpm, _ = fns.shadow_plane_pre(*(float(v) for v in pgeo), jlr)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jpm), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(O.shadow_transmittance(c, pargs).numpy(),
                               np.asarray(fns.shadow_transmittance(
                                   tuple(jnp.asarray(a.numpy()) for a in pargs))),
                               rtol=1e-6, atol=1e-7)


def test_shaded_object_adjoint_matches_jax_with_vis():
    """sphere_f / plane_f with vis (rgb = min(255, A + vis B)) and their
    adjoints against jax.vjp of JAX's closures with vis held constant, as
    tests/test_torch_soft_kernel.py `_check_vjp` holds them: float32 away
    from the sphere's silhouette, the sphere in float64 on every ray, its
    ray cotangent normal to the ray."""
    rng = np.random.default_rng(4)
    shape = (8, 16)
    d = rng.normal(size=shape + (3,)).astype(np.float32) * 0.15 + np.array([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = [np.ascontiguousarray(d[..., i]) for i in range(3)]
    vis = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    for kind, scal in (("sphere", (0.5, 0.3, 20.0, 3.0, 200.0, 40.0, 90.0, 0.1, -0.2, 0.3)),
                       ("plane", (0.0, -3.0, 30.0, 0.1, 1.0, 0.05, 4.0, 40.0, 100.0, 120.0, 80.0,
                                  0.2, 1.0, 0.0))):
        cts = [rng.normal(size=shape).astype(np.float32) for _ in range(8)]
        _check_vjp(kind, scal, rays, cts, CFG, TAU, vis=vis)


def _hidden_crowd(cfg, n=12, seed=5):
    """fit_from_shadow's floor and visible sphere (slot 0) with n occluders
    in slots 1..n, each at a random height above the camera frustum (as the
    fit's occluder is) on the line from the light to a random floor point in
    view, so that their penumbrae fall on the floor the camera sees and
    overlap there."""
    import rtwc_tpu.scene as JS

    rng = np.random.default_rng(seed)
    lx, ly, lz = cfg.light_pos
    s = JS.empty_scene(n + 1, 1)
    s = JS.add_plane(s, (0.0, -4.0, 40.0), (0.0, 1.0, 0.0), (120.0, 120.0, 120.0), 120.0, 120.0)
    s = JS.add_sphere(s, 4.0, (-8.0, 0.0, 45.0), (220.0, 60.0, 60.0), speed=1.0)
    for _ in range(n):
        y = float(rng.uniform(22.0, 30.0))
        f = (ly - y) / (ly + 4.0)  # the share of the way from the light to the floor
        fx, fz = float(rng.uniform(-8.0, 8.0)), float(rng.uniform(12.0, 36.0))
        s = JS.add_sphere(s, float(rng.uniform(1.5, 3.0)),
                          (lx + f * (fx - lx), y, lz + f * (fz - lz)),
                          tuple(float(c) for c in rng.uniform(30, 220, 3)), speed=1.0)
    return s


def _occluder_case(name):
    """(JAX scene, camera, config, target [H, W, 3], the sphere slots whose
    gradients to compare). The 40-sphere slab crowd against mse_case's
    uniform(0, 255) target, every slot: all its spheres are also on camera,
    so camera-ray terms weigh in its leaves. The hidden crowd (_hidden_crowd)
    against the same target, and fit_from_shadow's scene at 96x32 with the
    hidden occluder moved by the fit's starting offset against the render at
    its true place: only the hidden slots, whose gradients come through
    their shadows alone."""
    import rtwc_tpu.scene as JS
    import rtwc_tpu_torch.camera as TC
    from rtwc_tpu_torch.examples import fit_from_shadow as FS
    from rtwc_tpu_torch.render import soft_kernel as SK
    from test_torch_shadow_kernel import CFG_SH, _slab_crowd
    from test_torch_softmin import jax_camera

    cam = jax_camera()
    rand = np.random.default_rng(1).uniform(0.0, 255.0, (CFG.height, CFG.width, 3))
    if name == "slab_crowd":
        return _slab_crowd(), cam, CFG_SH.replace(max_spheres=48), rand.astype(np.float32), None
    cfg, ts = FS.build(96, 32)
    if name == "hidden_crowd":
        cfg = cfg.replace(max_spheres=13)
        return _hidden_crowd(cfg), cam, cfg, rand.astype(np.float32), np.arange(1, 13)
    with torch.no_grad():
        tgt = SK.render_frame_soft_kernel(ts, TC.default_camera(), cfg, tau=TAU).rgb.numpy()
    s = JS.Scene(
        spheres=JS.Spheres(**{f: jnp.asarray(getattr(ts.spheres, f).numpy()) for f in
                              ("center", "radius", "color", "speed", "mover", "active")}),
        planes=JS.Planes(**{f: jnp.asarray(getattr(ts.planes, f).numpy()) for f in
                            ("center", "normal", "color", "width", "height", "active")}))
    moved = np.asarray(FS.TRUE_OCCLUDER, np.float32) + np.array([3.0, 0.0, 4.0], np.float32)
    s = s.replace(spheres=s.spheres.replace(center=s.spheres.center.at[FS.OCCLUDER].set(moved)))
    return s, cam, cfg, tgt, np.array([FS.OCCLUDER])


@pytest.mark.parametrize("case", ["slab_crowd", "hidden_crowd", "fit_from_shadow"])
def test_shadow_ray_discriminant_is_no_farther_from_float64_than_jax(case):
    """The shadow ray's sphere test keeps JAX's b^2 - 4c (soft_common.cuh
    `shadow_sphere_preA`, `shadow_sphere_f_vjp`; soft_objects.py), whose
    terms cancel at an occluder's silhouette, where the penumbra sigmoid
    on dss amplifies the rounding. The plain K4 / K5 (the generic path)
    against JAX's float32 `render_soft_mse_loss` and the port's torch soft
    renderer in float64 (the arbiter of test_float64_renders_agree_on_the_
    slab_crowd): no value of the compared spheres' centre and radius
    gradients lies farther from float64 than JAX's farthest value of the
    same leaf plus GRAD_ATOL (ROADMAP queue 3's rule for FMA contraction).
    In the hidden crowd and the fit no camera ray reaches the compared
    spheres (the unshadowed render is the same without them), so these
    values are shadow-ray terms alone; at least three of them (the fit: its
    one) carry a gradient above 1e-6."""
    from rtwc_tpu.render.pallas_soft import render_soft_mse_loss as j_mse
    from rtwc_tpu_torch.render import soft_kernel as SK
    from test_torch_shadow_kernel import GRAD_ATOL, _grads, _mse_grads64, _mse_losses, _port

    scene, cam, cfg, tgt, slots = _occluder_case(case)
    s64, _ = _mse_grads64(scene, cam, tgt, cfg)
    if slots is not None:
        ts, tc = _port(scene, cam)
        off = ts.spheres.active.clone()
        off[slots] = 0.0
        lit = cfg.replace(shadows=False)
        with torch.no_grad():
            a = SK.render_frame_soft_kernel(ts, tc, lit, tau=TAU).rgb
            b = SK.render_frame_soft_kernel(
                ts.replace(spheres=ts.spheres.replace(active=off)), tc, lit, tau=TAU).rgb
        assert torch.equal(a, b), f"{case}: a camera ray reaches a compared sphere"
        reached = (np.abs(s64.spheres.center.grad.numpy()[slots]).max(1) > 1e-6).sum()
        assert reached >= min(len(slots), 3), f"{case}: {reached} occluders carry a gradient"
    gj = jax.grad(lambda s: j_mse(s, cam, jnp.asarray(tgt), cfg, tau=TAU))(scene)
    _, ps, _ = _grads(scene, cam, cfg, _mse_losses(tgt, cfg)[1])
    pick = slice(None) if slots is None else slots
    for leaf in ("center", "radius"):
        e = getattr(s64.spheres, leaf).grad.numpy()[pick]
        port = np.abs(np.asarray(getattr(ps.spheres, leaf), np.float64)[pick] - e)
        jax_worst = np.abs(np.asarray(getattr(gj.spheres, leaf), np.float64)[pick] - e).max()
        print(f"{case} spheres.{leaf}: port farthest {port.max()!r} from float64, "
              f"JAX {jax_worst!r}; largest |float64| {np.abs(e).max()!r}")
        assert (port <= jax_worst + GRAD_ATOL).all(), (
            f"{case} spheres.{leaf}: port {port.max()} from float64 at "
            f"{np.argwhere(port > jax_worst + GRAD_ATOL)[:5].tolist()}, JAX {jax_worst}")
