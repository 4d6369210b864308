"""rtwc_tpu_torch.dist and the soft band entry points on the CPU against
the JAX package (rtwc_tpu.dist on conftest.py's 8 virtual CPU devices, the
Pallas band entry points in interpret mode), the row-band renders against
the single render, and gloo meshes of 2 and 4 processes against one.

Tolerances, and why:
- band planes against JAX's Pallas band: tests/test_torch_softmin.py's
  rule, atol 2e-3 / 1e-3 / 1e-4 / 1e-4 (rgb / depth / normal / alpha) plus
  rtol 1e-4 on all but 0.5 % of the values (XLA's FMA contraction), and
  no value farther from the float64 torch soft render of the same rows
  than JAX's farthest value plus that atol;
- gradients against JAX: assert_close_tree (rtol 2e-2, atol 1e-6), as
  tests/test_dist.py holds JAX's two backends to each other; losses 1e-6
  relative;
- the fused band loss against the port's generic band loss (the same
  arithmetic): 2e-5 of each gradient's largest magnitude;
- sharded renders against the single render: equal (every pixel's
  arithmetic is the same, and K7's lists are exact for hard hits);
- a band against the same rows of the whole-image soft render: the
  culling error, weights below e^-16 of the softmin (atol 1e-4);
- train steps take SGD at lr 2^16, and the gradient is (old - new) / lr:
  at lr 1 the float32 update would round the gradient to the parameter's
  ulp (2e-6 at a centre of 20, for gradients of 1e-5).
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.dist import make_mesh as j_make_mesh
from rtwc_tpu.dist import make_sharded_train_step as j_step
from rtwc_tpu.render import pack as JP
from rtwc_tpu.render import render_frame_soft as j_render_soft
from rtwc_tpu.render.pallas_soft import C_NPL, C_NSPH
from rtwc_tpu.render.pallas_soft import soft_band_mse_loss as j_band_mse
from rtwc_tpu.render.pallas_soft import soft_band_packed as j_band
from rtwc_tpu_torch.benchmarks import scaling
from rtwc_tpu_torch.dist import make_mesh, make_sharded_train_step, render_frame_sharded
from rtwc_tpu_torch.dist.mesh import _leaves
from rtwc_tpu_torch.render import render_frame, render_frame_kernel, render_frame_soft
from rtwc_tpu_torch.render import soft_core as C
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.render.softmin import render_frame_soft as t_soft
from test_torch_softmin import (LEAVES, TAU, assert_close_tree, assert_soft_fb_close, camera64,
                                fb_arrays, jax_camera, jax_scene, scene64)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
CFG = RenderConfig(width=64, height=32, max_spheres=16, max_planes=4)
STEP_CFG = CFG.replace(soft_miss_penalty=300.0, soft_mask_k=10.0)
BAND_CFG = RenderConfig(width=96, height=48, max_spheres=4, max_planes=2,
                        soft_miss_penalty=300.0, soft_mask_k=10.0)
ROW0, BAND_H = 12, 20   # a band that starts and ends inside a 16-row tile
LR = 2.0 ** 16
BUDGET = 0.005


# -- the band entry points ------------------------------------------------------------

def _band_loss(out, np_mod):
    """tests/test_torch_softmin.py's loss_of on a band's planes."""
    return (np_mod.mean((out[0:3] / 255.0) ** 2) + 0.01 * np_mod.mean(out[3]) / BAND_CFG.far
            + 0.1 * np_mod.mean(out[4:7] ** 2))


def _fb(planes):
    """rgb / depth / normal of a band's planes, [rows, W(, 3)]."""
    return {"rgb": np.moveaxis(planes[0:3], 0, -1), "depth": planes[3],
            "normal": np.moveaxis(planes[4:7], 0, -1)}


def _j_packed(scene, cam):
    sph, pl_, counts = JP.pack_scene(scene)
    camv = JP.pack_camera(cam)
    camv = camv.at[0, C_NSPH].set(counts[0].astype(jnp.float32))
    return sph, pl_, camv.at[0, C_NPL].set(counts[1].astype(jnp.float32))


def _port_leaves(scene, cam):
    return (TS.scene_from_numpy(scene, requires_grad=("all",)),
            TC.camera_from_numpy(cam, requires_grad=("all",)))


def _port_grads(ts, tc):
    return TS.scene_grads_to_numpy(ts), TC.camera_grads_to_numpy(tc)


def _assert_grads(gs, gc, ps, pc):
    for group, leaf in LEAVES:
        assert_close_tree(getattr(getattr(gs, group), leaf), getattr(getattr(ps, group), leaf),
                          what=f"{group}.{leaf}")
    assert_close_tree(gc.pos, pc.pos, what="camera pos")
    assert_close_tree(gc.rot, pc.rot, what="camera rot")


@pytest.fixture(scope="module", params=[False, True], ids=["unshadowed", "shadows"])
def band_case(request):
    """JAX's band planes, generic gradients, fused loss and its gradients."""
    cfg = BAND_CFG.replace(shadows=request.param)
    scene, cam = jax_scene(request.param), jax_camera()
    tgt = np.random.default_rng(2).uniform(0.0, 255.0, (BAND_H, cfg.width, 3)).astype(np.float32)

    def planes(s, c):
        return j_band(*_j_packed(s, c), ROW0, config=cfg, tau=TAU, band_h=BAND_H,
                      interpret=True)

    (_, out), g = jax.value_and_grad(lambda s, c: (_band_loss(planes(s, c), jnp),
                                                   planes(s, c)),
                                     argnums=(0, 1), has_aux=True)(scene, cam)
    lf, gf = jax.value_and_grad(
        lambda s, c: j_band_mse(*_j_packed(s, c), ROW0, jnp.asarray(tgt), config=cfg, tau=TAU,
                                band_h=BAND_H, interpret=True), argnums=(0, 1))(scene, cam)
    return cfg, scene, cam, np.asarray(out), g, tgt, float(lf), gf


def test_soft_band_packed_matches_jax(band_case):
    cfg, scene, cam, out_j, (gs, gc), _, _, _ = band_case
    ts, tc = _port_leaves(scene, cam)
    n = dict(C.LAUNCHES)
    out = SK.soft_band_packed(*C._packed(ts, tc), ROW0, config=cfg, tau=TAU, band_h=BAND_H)
    assert C.LAUNCHES == n  # CPU tensors: the plain versions
    assert out.shape == (14 if cfg.shadows else 10, BAND_H, cfg.width)
    fb64 = t_soft(scene64(ts), camera64(tc), cfg, tau=TAU)
    rows = slice(ROW0, ROW0 + BAND_H)
    exact = {"rgb": fb64.rgb[rows], "depth": fb64.depth[rows], "normal": fb64.normal[rows]}
    assert_soft_fb_close(_fb(out.detach().numpy()), _fb(out_j), fb_arrays(SimpleNamespace(**exact)),
                         "soft_band_packed")
    a, b, e = out[7].detach().numpy(), out_j[7], fb64.alpha[rows].detach().numpy()
    bad = np.abs(a - b) > 1e-4
    assert bad.mean() < BUDGET and not (np.abs(a - e) > np.abs(b - e).max() + 1e-4).any()
    _band_loss(out, torch).backward()
    _assert_grads(gs, gc, *_port_grads(ts, tc))


def test_band_is_the_rows_of_the_whole_render(band_case):
    """The band's planes are rows [ROW0, ROW0 + BAND_H) of the whole image
    (its tiles, and so its culling, differ)."""
    cfg, scene, cam = band_case[:3]
    ts, tc = TS.scene_from_numpy(scene), TC.camera_from_numpy(cam)
    band = SK.soft_band_packed(*C._packed(ts, tc), ROW0, config=cfg, tau=TAU, band_h=BAND_H)
    fb = SK.render_frame_soft_kernel(ts, tc, cfg, tau=TAU)
    rows = slice(ROW0, ROW0 + BAND_H)
    np.testing.assert_allclose(band[0:3].permute(1, 2, 0).numpy(), fb.rgb[rows].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(band[3].numpy(), fb.depth[rows].numpy(), atol=1e-4)


def test_soft_band_mse_loss_matches_jax_and_the_generic_band(band_case):
    cfg, scene, cam, _, _, tgt, lj, (gs, gc) = band_case
    ts, tc = _port_leaves(scene, cam)
    loss = SK.soft_band_mse_loss(*C._packed(ts, tc), ROW0, torch.from_numpy(tgt), config=cfg,
                                 tau=TAU, band_h=BAND_H)
    loss.backward()
    np.testing.assert_allclose(loss.item(), lj, rtol=1e-6)
    fs, fc = _port_grads(ts, tc)
    _assert_grads(gs, gc, fs, fc)
    ts, tc = _port_leaves(scene, cam)
    out = SK.soft_band_packed(*C._packed(ts, tc), ROW0, config=cfg, tau=TAU, band_h=BAND_H)
    generic = torch.mean(((out[0:3].permute(1, 2, 0) - torch.from_numpy(tgt)) / 255.0) ** 2)
    generic.backward()
    np.testing.assert_allclose(loss.item(), generic.item(), rtol=1e-6)
    ps, pc = _port_grads(ts, tc)
    for a, b, name in [(getattr(getattr(fs, g), lf), getattr(getattr(ps, g), lf), f"{g}.{lf}")
                       for g, lf in LEAVES] + [(fc.rot, pc.rot, "camera rot")]:
        assert np.abs(a - b).max() <= 2e-5 * np.abs(b).max(), name


def test_band_rejects_a_band_past_the_image():
    ts, tc = TS.scene_from_numpy(jax_scene(False)), TC.camera_from_numpy(jax_camera())
    with pytest.raises(ValueError):
        SK.soft_band_packed(*C._packed(ts, tc), 0, config=BAND_CFG, tau=TAU,
                            band_h=BAND_CFG.height + 1)


# -- render_frame_sharded ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_render_equals_the_single_render(n, backend):
    """Bands in turn in one process; "pallas" runs K7 a band (its plain
    version on the CPU), "jnp" the reference renderer; shadows on."""
    cfg = CFG.replace(shadows=True)
    scene = TS.scene_from_numpy(JS.random_scene(10, 1, max_spheres=16, max_planes=4, seed=3))
    cam = TC.default_camera()
    single = (render_frame_kernel if backend == "pallas" else render_frame)(scene, cam, cfg)
    mesh = make_mesh(n)
    assert mesh.axis_name == "tiles" and list(mesh.bands()) == list(range(n))
    fb = render_frame_sharded(scene, cam, cfg, mesh, backend=backend)
    for name in ("rgb", "normal", "depth", "shading", "hit", "coverage", "alpha"):
        assert torch.equal(getattr(fb, name), getattr(single, name)), name


def test_sharded_render_and_step_reject_bad_height():
    cfg = CFG.replace(height=30)  # not divisible by 8
    scene, cam = TS.default_scene(cfg), TC.default_camera()
    with pytest.raises(ValueError):
        render_frame_sharded(scene, cam, cfg, make_mesh(8))
    with pytest.raises(ValueError):
        make_sharded_train_step(cfg, make_mesh(8), tau=0.5)
    with pytest.raises(ValueError):
        render_frame_sharded(scene, cam, CFG, make_mesh(2), backend="xla")


# -- make_sharded_train_step ---------------------------------------------------------------

def _sgd(leaves):
    return torch.optim.SGD(list(leaves.values()), lr=LR)


def _port_sgd_step(cfg, n, backend, scene, cam, target):
    """(loss, {leaf: gradient}) of one SGD step at lr LR on an n-band mesh."""
    step = make_sharded_train_step(cfg, make_mesh(n), tau=0.5, optimizer=_sgd, backend=backend)
    params = (scene, cam)
    new, _, loss = step(params, step.init(params), target)
    old_l, new_l = _leaves(params), _leaves(new)
    return float(loss), {k: ((old_l[k] - new_l[k]) / LR).numpy() for k in old_l}


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("shadows", [False, True], ids=["unshadowed", "shadows"])
def test_sgd_step_matches_jax(shadows, backend):
    """One SGD step of the port's 4-band step against JAX's on its
    4-device virtual mesh (tests/test_dist.py's case), and the port's
    camera gradient against its own unsharded step."""
    cfg = STEP_CFG.replace(shadows=shadows)
    jscene, jcam = JS.default_scene(cfg), JC.default_camera()
    jtarget = j_render_soft(jscene, jcam, cfg, tau=0.5).rgb + 10.0
    jstep = j_step(cfg, j_make_mesh(4), tau=0.5, optimizer=optax.sgd(LR), backend=backend)
    (jnew, _), _, jloss = jstep((jscene, jcam), jstep.init((jscene, jcam)), jtarget)
    jg = {f: (np.asarray(getattr(jscene.spheres, f)) - np.asarray(getattr(jnew.spheres, f))) / LR
          for f in ("center", "color")}
    scene, cam = TS.scene_from_numpy(jscene), TC.camera_from_numpy(jcam)
    target = torch.from_numpy(np.array(jtarget))
    loss, g = _port_sgd_step(cfg, 4, backend, scene, cam, target)
    assert abs(loss - float(jloss)) < 1e-6 * max(1.0, abs(float(jloss)))
    np.testing.assert_allclose(g["spheres.center"], jg["center"], rtol=2e-2,
                               atol=1e-6 if shadows else 1e-7)
    np.testing.assert_allclose(g["spheres.color"], jg["color"], rtol=2e-2, atol=1e-9)
    loss1, g1 = _port_sgd_step(cfg, 1, backend, scene, cam, target)
    np.testing.assert_allclose(loss, loss1, rtol=1e-6)
    for k in ("camera.pos", "camera.rot", "spheres.center", "spheres.radius"):
        assert_close_tree(g1[k], g[k], what=k)


def test_sharded_train_step_animated():
    """BASELINE config 4 (tests/test_dist.py's case): the animated step
    equals the plain step at dt = 0, and at dt > 0 the plain step on the
    pre-ticked scene."""
    cfg = STEP_CFG
    scene, cam = TS.default_scene(cfg), TC.default_camera()
    target = torch.zeros((cfg.height, cfg.width, 3))

    def probe(leaves):
        return torch.optim.SGD(list(leaves.values()), lr=0.0)

    anim = make_sharded_train_step(cfg, make_mesh(4), tau=0.5, optimizer=probe, animate=True)
    plain = make_sharded_train_step(cfg, make_mesh(4), tau=0.5, optimizer=probe)
    params = (scene, cam)
    _, _, loss_dt0 = anim(params, anim.init(params), target, 0.0)
    _, _, loss_plain = plain(params, plain.init(params), target)
    assert np.isfinite(float(loss_dt0))
    np.testing.assert_allclose(float(loss_dt0), float(loss_plain), rtol=1e-6)
    dt = 0.25
    _, _, loss_anim = anim(params, anim.init(params), target, dt)
    ticked = TS.update_scene(scene, dt, cfg.bob_min_y, cfg.bob_max_y)
    _, _, loss_ticked = plain((ticked, cam), plain.init((ticked, cam)), target)
    np.testing.assert_allclose(float(loss_anim), float(loss_ticked), rtol=1e-6)
    assert float(loss_anim) != float(loss_dt0)


def test_sharded_train_step_decreases_loss():
    """tests/test_dist.py's case: the sphere centres, perturbed by 0.5,
    trained alone with Adam on an 8-band mesh against the soft render of
    the true scene, lower the loss within 30 steps."""
    cfg = STEP_CFG
    true_scene, cam = TS.default_scene(cfg), TC.default_camera()
    target = render_frame_soft(true_scene, cam, cfg, tau=0.5).rgb.detach()
    bad = true_scene.replace(spheres=true_scene.spheres.replace(
        center=true_scene.spheres.center + 0.5))
    step = make_sharded_train_step(
        cfg, make_mesh(8), tau=0.5,
        optimizer=lambda leaves: torch.optim.Adam([leaves["spheres.center"]], lr=5e-2))
    params = (bad, cam)
    state = step.init(params)
    params, state, loss0 = step(params, state, target)
    losses = []
    for _ in range(30):
        params, state, loss = step(params, state, target)
        losses.append(float(loss))
    assert min(losses[-5:]) < float(loss0), (float(loss0), losses)
    assert torch.equal(params[1].rot, cam.rot)  # only the centres train


@pytest.mark.parametrize("n", [1, 2])
def test_sharded_step_keeps_static_buffers(n):
    """The step's buffers stay put: step.init makes the leaves once, each
    leaf's .grad is a view of the one flat buffer (every gradient, then the
    loss), the returned params are aliases of the leaves (passed back in,
    nothing is copied), the loss is a tensor of its own, a target of a new
    shape gets a new static target, and a caller's fresh params are copied
    into the leaves in place. graph=False and graph=None (eager on the CPU)
    are bit-equal, and a graph on the CPU is refused."""
    cfg = STEP_CFG.replace(shadows=True)
    scene, cam = TS.default_scene(cfg), TC.default_camera()
    target = torch.zeros((cfg.height, cfg.width, 3))
    runs = []
    for graph in (None, False):
        step = make_sharded_train_step(cfg, make_mesh(n), tau=0.5, backend="pallas",
                                       animate=True, graph=graph)
        state = step.init((scene, cam))
        leaves = dict(state.leaves)
        ptrs = {k: v.data_ptr() for k, v in leaves.items()}
        off = 0
        for v in leaves.values():
            assert v.grad.data_ptr() == state.flat.data_ptr() + 4 * off
            off += v.numel()
        assert off + 1 == state.flat.numel() and state.replay_launches is None
        assert not state.phases[0].graph
        params, losses = (scene, cam), []
        for i in range(3):
            params, state, loss = step(params, state, target, torch.tensor([1.0 / 60.0]))
            losses.append(loss)
            tgt_ptr = state.target.data_ptr()
            assert loss.data_ptr() != state.flat.data_ptr() + 4 * off
            for k, v in _leaves(params).items():
                assert v.data_ptr() == ptrs[k] and not v.requires_grad
        assert state.leaves == leaves and float(losses[0]) != float(losses[-1])
        assert state.target_src[0] is target  # copied once, then left as it was
        target.add_(1.0)  # written in place: copied again at the next step
        step(params, state, target)
        assert torch.equal(state.target, target)
        target.sub_(1.0)
        params, state, loss = step(params, state, target[:, :, :2].repeat(1, 1, 2)[..., :3])
        assert state.target.data_ptr() == tgt_ptr  # same shape: the same buffer
        runs.append((torch.stack(losses), [v.detach().clone() for v in leaves.values()]))
        fresh = (TS.default_scene(cfg), cam)
        step(fresh, state, torch.zeros((cfg.height, cfg.width, 3)))
        assert all(v.data_ptr() == ptrs[k] for k, v in state.leaves.items())
    (l0, p0), (l1, p1) = runs
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(p0, p1))
    step = make_sharded_train_step(cfg, make_mesh(n), tau=0.5, graph=True)
    with pytest.raises(ValueError):
        step.init((scene, cam))


def test_sharded_frame_graph_buffers_on_the_cpu():
    """render_frame_sharded's graph object in its eager form on the CPU
    (its CUDA graph runs on the card only, chip_smoke.py phase 7): equal to
    the single render; a scene of the same capacity is copied into the
    static buffers, one of a new capacity replaces them; a graph on the CPU
    is refused."""
    from rtwc_tpu_torch.dist import mesh as M

    cfg = CFG.replace(shadows=True)
    mesh = make_mesh(4)
    fg = M._FrameGraph(cfg, mesh.size, mesh.bands(), torch.device("cpu"), graph=False)
    cam = TC.default_camera()
    scenes = [TS.scene_from_numpy(JS.random_scene(k, 1, max_spheres=16, max_planes=4, seed=s))
              for k, s in ((10, 3), (6, 4))]
    scenes.append(TS.grow_scene(scenes[0], max_spheres=32))
    for i, scene in enumerate(scenes):
        before = fg.inputs.scene
        fb = fg(scene, cam)
        single = render_frame_kernel(scene, cam, cfg)
        for name in ("rgb", "normal", "depth", "shading", "hit", "coverage", "alpha"):
            assert torch.equal(getattr(fb, name), getattr(single, name)), (i, name)
        assert fg.inputs.scene is not scene
        if i == 1:
            assert fg.inputs.scene is before  # copied in place
        if i == 2:
            assert fg.inputs.scene is not before  # a new capacity: new buffers
    with pytest.raises(ValueError):
        M._frame_graph(cfg, mesh.size, mesh.bands(), torch.device("cpu"))
    with pytest.raises(ValueError):
        render_frame_sharded(scenes[0], cam, cfg, mesh, backend="pallas", graph=True)


# -- gloo meshes of processes ---------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_one_rank(world, tmp_path):
    """world processes, one band each, joined by initialize_multihost over
    gloo: one SGD step of the shadowed kernel path. Every rank's loss and
    parameters are bit-equal; each step makes exactly one all_reduce, whose
    buffer carries every leaf and the loss; loss and gradients equal the
    one-rank step's; render_frame_sharded gives every rank the whole frame,
    equal to the single render."""
    coordinator = f"127.0.0.1:{scaling._free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, coordinator, str(world), str(r), outs[r],
                               "pallas", "1"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
             for r in range(world)]
    try:
        res = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, res):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    ranks = [dict(np.load(o)) for o in outs]
    cfg = STEP_CFG.replace(shadows=True)
    scene, cam = TS.default_scene(cfg), TC.default_camera()
    target = render_frame_soft(scene, cam, cfg, tau=0.5).rgb.detach() + 10.0
    loss1, g1 = _port_sgd_step(cfg, 1, "pallas", scene, cam, target)
    n_leaves = sum(v.numel() for v in _leaves((scene, cam)).values())
    for r in ranks:
        assert int(r["n_all_reduce"]) == 1 and list(r["sizes"]) == [n_leaves + 1]
        assert r["loss"].tobytes() == ranks[0]["loss"].tobytes()
        for k in g1:
            assert np.array_equal(r[f"param.{k}"], ranks[0][f"param.{k}"]), k
    np.testing.assert_allclose(float(ranks[0]["loss"]), loss1, rtol=1e-6)
    single = render_frame_kernel(scene, cam, cfg)
    for r in ranks:
        for f in ("rgb", "depth", "normal", "hit"):
            assert np.array_equal(r[f"fb.{f}"], getattr(single, f).numpy()), f
    for k in g1:
        assert_close_tree(g1[k], ranks[0][f"grad.{k}"], what=k)


# -- Adam across band counts, in both packages (ROADMAP queue 3, settled) ------------------

DRIFT_CFG = RenderConfig(width=128, height=64, max_spheres=16, max_planes=4,
                         soft_miss_penalty=300.0, soft_mask_k=10.0)
DRIFT_BANDS, DRIFT_STEPS = (1, 2, 4), 9
EARLY_RTOL = 1e-5     # steps 1-4 across band counts, in each package
DRIFT_MARGIN = 2.0    # the port's spread at the last step against JAX's own
SGD_RTOL = 2e-6       # SGD: every step across band counts, in each package


def _band_losses(cfg, optimizer: str) -> tuple:
    """[len(DRIFT_BANDS), DRIFT_STEPS] losses of JAX's and the port's
    sharded step (jnp backend) on 1, 2 and 4 bands from random_scene(16),
    tau 0.5, a zero target, `optimizer` at lr 1e-2 on every leaf."""
    jscene = JS.random_scene(16, max_spheres=16, max_planes=4, seed=0)
    jcam = JC.default_camera()
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)
    j_opt = optax.adam(1e-2) if optimizer == "adam" else optax.sgd(1e-2)
    t_opt = torch.optim.Adam if optimizer == "adam" else torch.optim.SGD
    jl, pl = [], []
    for n in DRIFT_BANDS:
        jstep = j_step(cfg, j_make_mesh(n), tau=0.5, optimizer=j_opt, backend="jnp")
        params, losses = (jscene, jcam), []
        state = jstep.init(params)
        for _ in range(DRIFT_STEPS):
            params, state, loss = jstep(params, state, jnp.asarray(target))
            losses.append(float(loss))
        jl.append(losses)
        step = make_sharded_train_step(cfg, make_mesh(n), tau=0.5, backend="jnp",
                                       optimizer=lambda lv: t_opt(list(lv.values()), lr=1e-2))
        params, losses = (TS.scene_from_numpy(jscene), TC.camera_from_numpy(jcam)), []
        state = step.init(params)
        for _ in range(DRIFT_STEPS):
            params, state, loss = step(params, state, torch.from_numpy(target))
            losses.append(float(loss))
        pl.append(losses)
    return np.array(jl), np.array(pl)


def _spread(losses: np.ndarray) -> np.ndarray:
    """Each step's spread across band counts, relative to its largest loss."""
    return (losses.max(0) - losses.min(0)) / np.abs(losses).max(0)


@pytest.mark.parametrize("shadows", [False, True], ids=["unshadowed", "shadows"])
def test_adam_runs_part_across_band_counts_in_jax_too(shadows):
    """Adam at lr 1e-2 on every leaf, 9 steps on 1, 2 and 4 bands: JAX's own
    losses part across band counts from step 5 on, as the port's do (128x64,
    at step 9: JAX 9.1e-3 unshadowed and 3.3e-3 shadowed, the port 6.7e-3
    and 5.5e-4). Adam moves every leaf whose gradient clears eps by about
    lr times that gradient's sign, so it turns the bands' last bits in
    near-zero gradients into whole steps; under SGD the band counts stay
    together (the next test). Held: steps 1-4 agree across band counts to
    EARLY_RTOL in each package; JAX's last step spreads past 1e-4; the
    port's last-step spread is at most DRIFT_MARGIN times JAX's; step 1
    agrees across the packages to 2e-6."""
    jl, pl = _band_losses(DRIFT_CFG.replace(shadows=shadows), "adam")
    for name, losses in (("jax", jl), ("port", pl)):
        early = _spread(losses)[:4]
        assert early.max() < EARLY_RTOL, (name, early)
    js, ps = _spread(jl)[-1], _spread(pl)[-1]
    assert js > 1e-4, jl[:, -1]
    assert ps <= DRIFT_MARGIN * js, (ps, js, pl[:, -1], jl[:, -1])
    np.testing.assert_allclose(pl[:, 0], jl[:, 0], rtol=2e-6)


def test_sgd_runs_stay_together_across_band_counts():
    """The same case unshadowed under SGD at lr 1e-2: every step of 1, 2 and
    4 bands agrees to SGD_RTOL in each package (about 6e-7 in JAX, 1.2e-7
    in the port), so the bands' roundings are small and Adam amplifies
    them."""
    jl, pl = _band_losses(DRIFT_CFG, "sgd")
    for name, losses in (("jax", jl), ("port", pl)):
        assert _spread(losses).max() < SGD_RTOL, (name, _spread(losses))
