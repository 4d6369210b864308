"""The port's train path on the CPU: the anneal ladder, the straight-through
quantization head, one step of the inverse-render loss (RGB + IoU on the
soft alpha) through render_frame_soft_kernel against JAX's value_and_grad
of the same loss through render_frame_soft_pallas (interpret mode), and the
entry point `python -m rtwc_tpu_torch.examples.inverse_render` at a tiny
size.

Tolerances: the loss to rtol 2e-4: at the coarse stage (tau 20) the
penalties are large and each float32 render, JAX's and the port's, sits
~5e-5 from a float64 evaluation in alpha and ~1e-2 in depth; gradients at
_assert_close_tree's rtol 2e-2 / atol 1e-6, as tests/test_pallas_soft.py
holds the Pallas path to jnp."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
from rtwc_tpu.config import RenderConfig
from rtwc_tpu.heads.ansi256 import quantize_rgb_ste as j_quant
from rtwc_tpu.render.anneal import AnnealSchedule as JAnneal
from rtwc_tpu.render.pallas_soft import render_frame_soft_pallas as j_render
from rtwc_tpu_torch.camera import camera_from_numpy, camera_grads_to_numpy
from rtwc_tpu_torch.examples import inverse_render as IR
from rtwc_tpu_torch.heads import quantize_rgb_ste as t_quant
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.render.anneal import AnnealSchedule as TAnneal
from test_torch_softmin import assert_close_tree

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False  # no TF32 anywhere
torch.backends.cudnn.allow_tf32 = False
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kw", [{}, {"n_stages": 1}, {"n_stages": 3, "tau0": 5.0, "tau1": 0.1,
                                                       "penalty0": 100.0, "mask_k0": 2.0}])
def test_anneal_stages_equal_jax(kw):
    base = RenderConfig(width=64, height=32)
    j, t = JAnneal(**kw), TAnneal(**kw)
    assert [j.stage(i) for i in range(j.n_stages)] == [t.stage(i) for i in range(t.n_stages)]
    assert list(j.configs(base)) == list(t.configs(base))
    assert j.split_steps(17) == t.split_steps(17)
    with pytest.raises(ValueError):
        TAnneal(n_stages=0)


def test_quantize_ste_forward_equal_backward_identity():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0.0, 255.0, (16, 24, 3)).astype(np.float32)
    x = torch.from_numpy(rgb).requires_grad_(True)
    q = t_quant(x)
    np.testing.assert_array_equal(q.detach().numpy(), np.asarray(j_quant(jnp.asarray(rgb))))
    g = rng.normal(size=rgb.shape).astype(np.float32)
    q.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(x.grad.numpy(), g)


def _jax_scene(ts):
    def grp(node, cls):
        return cls(**{f: jnp.asarray(getattr(node, f).numpy()) for f in
                      ("center", "radius", "color", "speed", "mover", "active")}) \
            if cls is JS.Spheres else \
            cls(**{f: jnp.asarray(getattr(node, f).numpy()) for f in
                   ("center", "normal", "color", "width", "height", "active")})

    return JS.Scene(spheres=grp(ts.spheres, JS.Spheres), planes=grp(ts.planes, JS.Planes))


def test_one_inverse_render_step_matches_jax():
    """Phase A's loss at the coarse stage (tau 20, silhouette term on) and
    phase B's at the sharp stage, from the same perturbed parameters, with
    the same target arrays given to both packages."""
    cfg, ts = IR.build(96, 32, 3)
    js = _jax_scene(ts)
    stages = list(TAnneal().configs(cfg))
    jcam = JC.Camera(pos=jnp.zeros(3, jnp.float32), rot=jnp.asarray(JC.default_camera().rot))
    fb_t = j_render(js, jcam, stages[-1][1], tau=stages[-1][0])
    target, target_a = np.asarray(fb_t.rgb), np.asarray(fb_t.alpha)
    noise = np.random.default_rng(0).normal(0, 1.5, (cfg.max_spheres, 3)).astype(np.float32)
    noise[np.asarray(js.spheres.active) < 0.5] = 0.0
    centers = np.asarray(js.spheres.center) + noise

    def j_loss(center, rot, stage, w_sil):
        tau, scfg = stage
        sc = js.replace(spheres=js.spheres.replace(center=center))
        fb = j_render(sc, JC.Camera(pos=jcam.pos, rot=rot), scfg, tau=tau)
        loss = jnp.mean(((fb.rgb - target) / 255.0) ** 2)
        if w_sil:
            inter = jnp.sum(fb.alpha * target_a)
            union = jnp.sum(fb.alpha + target_a - fb.alpha * target_a)
            loss = loss + w_sil * (1.0 - inter / jnp.maximum(union, 1e-6))
        return loss

    rot0 = np.asarray(jcam.rot) + np.array([0.02, -0.03, 0.0], np.float32)
    for stage, w_sil, center, rot in ((stages[0], 1.0, centers, np.asarray(jcam.rot)),
                                      (stages[-1], 0.0, np.asarray(js.spheres.center), rot0)):
        lj, (gcj, grj) = jax.value_and_grad(j_loss, argnums=(0, 1))(
            jnp.asarray(center), jnp.asarray(rot), stage, w_sil)
        c = torch.from_numpy(center.copy()).requires_grad_(True)
        cam = camera_from_numpy(JC.Camera(pos=jcam.pos, rot=rot), requires_grad=("rot",))
        fb = SK.render_frame_soft_kernel(ts.replace(spheres=ts.spheres.replace(center=c)), cam,
                                         stage[1], tau=stage[0])
        lt = IR.loss_of(fb, torch.from_numpy(target), torch.from_numpy(target_a), w_sil, False)
        lt.backward()
        np.testing.assert_allclose(lt.item(), float(lj), rtol=2e-4)
        assert_close_tree(np.asarray(gcj), c.grad.numpy(), what=f"centers at tau {stage[0]}")
        assert_close_tree(np.asarray(grj), camera_grads_to_numpy(cam).rot,
                          what=f"rotation at tau {stage[0]}")
        assert np.abs(c.grad.numpy()).max() > 0


def test_entry_point_runs_and_writes_the_artifact(tmp_path):
    out = tmp_path / "fit.json"
    n = dict(SK.LAUNCHES)
    rc = IR.main(["--device", "cpu", "--width", "64", "--height", "32", "--steps", "4",
                  "--json-out", str(out)])
    assert rc in (0, 1)  # four steps need not converge
    assert SK.LAUNCHES == n  # CPU: plain versions only
    rec = json.loads(out.read_text())
    assert rec["kind"] == "inverse_render_fit" and rec["config"]["width"] == 64
    assert len(rec["phase_a_stages"]) == 5 and len(rec["phase_b_stages"]) == 2
    assert all(np.isfinite(s["loss"]) for s in rec["phase_a_stages"] + rec["phase_b_stages"])
    assert rec["sub_pixel"] == (rc == 0)


def test_train_path_imports_no_jax():
    code = ("import sys\n"
            "import rtwc_tpu_torch.examples.inverse_render, rtwc_tpu_torch.render.soft_kernel\n"
            "import rtwc_tpu_torch.render.softmin, rtwc_tpu_torch.render.anneal\n"
            "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr


def test_entry_point_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "rtwc_tpu_torch.examples.inverse_render",
                           "--steps", "1", "--width", "32", "--height", "16"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
