"""`python -m rtwc_tpu_torch.utils.cam_grad_precision` (the port of
scripts/cam_grad_precision.py) at a small size on the CPU: the float32
rotation gradient's error splits into the per-ray cotangent part and the
summation part, the per-ray Jacobian reproduces autograd's float64
gradient, and the entry point prints one JSON line."""
import json

import numpy as np

from rtwc_tpu_torch.utils import cam_grad_precision as CGP


def test_split_of_the_rotation_gradients_error(capsys):
    out = CGP.measure(width=48, height=27, bands=2)
    g64 = np.array(out["rot_grad_f64"])
    g32 = np.array(out["rot_grad_f32"])
    e32 = np.array(out["rot_grad_exact_sum_of_f32_rays"])
    scale = np.abs(g64).max()
    assert scale > 0 and np.isfinite([g64, g32, e32]).all()
    # the split: g32 - g64 = (e32 - g64) + (g32 - e32)
    assert out["rel_err_f32_total"] <= (out["rel_err_per_ray_cotangents"]
                                        + out["rel_err_summation"]) * (1 + 1e-6) + 1e-12
    np.testing.assert_allclose(out["rel_err_per_ray_cotangents"],
                               np.abs(e32 - g64).max() / scale, rtol=1e-6)
    # the float64 rays' shares, summed, are autograd's float64 gradient
    assert out["rel_err_f64_jacobian_check"] < 1e-12
    assert 0 < out["rel_err_f32_total"] < 0.1
    assert out["per_ray_err_max"] >= out["per_ray_err_p999"] >= 0.0
    assert CGP.main(["--width", "32", "--height", "18", "--bands", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0])["config"]["width"] == 32


def test_per_ray_rotation_gradient_error_is_no_larger_than_jaxs():
    """ROADMAP queue 3's settled rotation-gradient finding, pinned at 96x54
    (grad_cam_rot_rel's scene, shadows, the study loss): each ray's share of
    d loss / d rot is c = J^T g, with g the per-ray cotangent dL/d(ray
    direction) and J = d(direction)/d(rot) in float64. Against the float64
    shares of the port's torch renderer (the float64 arbiter), the port's
    float32 shares are no farther than those of JAX's float32 trace_soft on
    JAX's camera_rays rays, both in their sum and ray by ray (measured: the
    port 5.6e-5 / 9.9e-5 of the largest float64 component, JAX 4.0e-3 /
    2.9e-3)."""
    import jax
    import jax.numpy as jnp
    import torch

    import rtwc_tpu.camera as JC
    import rtwc_tpu.scene as JS
    from rtwc_tpu.config import RenderConfig as JConfig
    from rtwc_tpu.render.softmin import trace_soft as j_trace_soft
    from rtwc_tpu_torch.config import RenderConfig

    W, H = 96, 54
    kw = dict(width=W, height=H, max_spheres=24, max_planes=4, soft_miss_penalty=300.0,
              soft_mask_k=10.0, shadows=True)
    cfg, jcfg = RenderConfig(**kw), JConfig(**kw)
    g32, _ = CGP.per_ray(cfg, torch.float32, 1)
    g64, rot64 = CGP.per_ray(cfg, torch.float64, 1)
    J = CGP.ray_jacobian(cfg)
    jscene = JS.random_scene(20, max_spheres=24, max_planes=4, seed=0)
    e1, e2 = JC.projection_elements(jcfg)
    origin, dirs = JC.camera_rays(JC.default_camera(), W, H, e1, e2)

    def loss(d):
        rgb, depth, _, _ = j_trace_soft(jscene, origin, d, jcfg, tau=CGP.TAU)
        return (jnp.sum((rgb / 255.0) ** 2) / (3.0 * H * W)
                + 0.01 * jnp.sum(depth) / (H * W) / jcfg.far)

    gj = torch.from_numpy(np.asarray(jax.grad(loss)(dirs), np.float64))
    c64 = torch.einsum("hwd,hwdk->hwk", g64, J)
    scale = float(rot64.abs().max())
    errs = {}
    for name, g in (("port", g32.double()), ("jax", gj)):
        c = torch.einsum("hwd,hwdk->hwk", g, J)
        errs[name] = (float((c.sum((0, 1)) - c64.sum((0, 1))).abs().max()) / scale,
                      float((c - c64).abs().amax(-1).max()) / scale)
    assert 0 < errs["port"][0] <= errs["jax"][0], errs
    assert 0 < errs["port"][1] <= errs["jax"][1], errs
