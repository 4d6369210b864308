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
