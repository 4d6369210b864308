"""`python -m rtwc_tpu_torch.utils.fit_precision` (phase A of the
inverse-render fit under five forms: the kernel path with torch's default,
foreach=False and fused Adam; the plain torch renderer in row bands in
float32 and in float64) at a small size on the CPU: its default form is the
entry point's phase A bit for bit, every form prints finite errors, and an
unknown variant is refused."""
import json

import numpy as np
import pytest

from rtwc_tpu_torch.examples import inverse_render as IR
from rtwc_tpu_torch.utils import fit_precision as FP

ARGS = ["--device", "cpu", "--width", "64", "--height", "32", "--spheres", "6", "--steps", "4",
        "--tau0", "2.0",
        "--perturb", "1.5", "--bands", "2"]


def test_fit_precision_default_is_the_entry_points_phase_a(tmp_path, capsys):
    out = tmp_path / "fit.json"
    IR.main(ARGS[:-2] + ["--json-out", str(out)])
    entry = json.loads(out.read_text())
    capsys.readouterr()
    assert FP.main(ARGS) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(rec["variants"]) == list(FP.VARIANTS)
    default = rec["variants"]["default"]
    # the entry point writes its errors rounded to 4 decimals
    np.testing.assert_allclose(default["reproj_px"], entry["phase_a_reproj_px_after"], rtol=0,
                               atol=5.01e-5)
    np.testing.assert_allclose(default["size_px"], entry["phase_a_size_err_px"], rtol=0,
                               atol=5.01e-5)
    assert default["stage_losses"] == [s["loss"] for s in entry["phase_a_stages"]]
    for got, stage in zip(default["stage_reproj_px"], entry["phase_a_stages"]):
        np.testing.assert_allclose(got, stage["reproj_px"], rtol=0, atol=5.01e-5)
    np.testing.assert_allclose(default["stage_reproj_px"][-1], default["reproj_px"])
    for name, v in rec["variants"].items():
        assert len(v["reproj_px"]) == 6 and np.isfinite(v["reproj_px"]).all(), name
        assert np.isfinite(v["stage_losses"]).all(), name
    assert len(rec["f32_reproj_scatter_px"]) == 6


def test_fit_precision_refuses_an_unknown_variant():
    with pytest.raises(SystemExit):
        FP.main(ARGS + ["--variants", "default,float16"])


def test_inverse_render_fit_tracks_float64_closer_than_jax(tmp_path, capsys):
    """ROADMAP queue 3's 1080p fit, at 96x54 on the CPU: JAX's
    examples/inverse_render.py (a subprocess, JAX_PLATFORMS=cpu) and the
    port's entry point with `--spheres 20 --width 96 --height 54 --steps 4
    --tau0 2.0 --perturb 0.5`, beside the port's fit in float64 (the torch
    renderer, fit_precision's float64 form). Both start from the same
    centres. The port's stage losses lie within 2e-6 of float64's and its
    reprojection errors within 1e-3 px (measured: 7e-7, 2.1e-4 px); JAX's
    lie within 1e-2 and 0.03 px (4.6e-3 at the third step, tau 0.316,
    where JAX's Pallas render of the same centres is 3.6e-4 from float64,
    and 0.0145 px), and no port number is farther from float64 than JAX's.
    Phase B's stage losses agree to 1e-4 (6.3e-5)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = ["--spheres", "20", "--width", "96", "--height", "54", "--steps", "4", "--tau0",
            "2.0", "--perturb", "0.5"]
    j_out, t_out = tmp_path / "jax.json", tmp_path / "port.json"
    proc = subprocess.run([sys.executable, os.path.join(root, "examples", "inverse_render.py"),
                           *args, "--json-out", str(j_out)], cwd=root, capture_output=True,
                          text=True, timeout=600,
                          env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root))
    assert proc.returncode in (0, 1), proc.stderr[-3000:]
    IR.main(args + ["--device", "cpu", "--json-out", str(t_out)])
    capsys.readouterr()
    assert FP.main(args + ["--device", "cpu", "--variants", "float64", "--bands", "2"]) == 0
    f64 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["variants"]["float64"]
    jax_rec, port = json.loads(j_out.read_text()), json.loads(t_out.read_text())
    assert jax_rec["phase_a_reproj_px_before"] == port["phase_a_reproj_px_before"]
    exact = np.array(f64["stage_losses"])
    for rec, rtol in ((port, 2e-6), (jax_rec, 1e-2)):
        np.testing.assert_allclose([s["loss"] for s in rec["phase_a_stages"]], exact, rtol=rtol)
    dist = {name: np.abs(np.array([s["loss"] for s in rec["phase_a_stages"]]) - exact)
            for name, rec in (("port", port), ("jax", jax_rec))}
    assert (dist["port"] <= dist["jax"]).all(), dist
    exact_px = np.array(f64["reproj_px"])
    px = {name: np.abs(np.array(rec["phase_a_reproj_px_after"]) - exact_px).max()
          for name, rec in (("port", port), ("jax", jax_rec))}
    assert px["port"] < 1e-3 and px["jax"] < 0.03 and px["port"] <= px["jax"], px
    np.testing.assert_allclose([s["loss"] for s in port["phase_b_stages"]],
                               [s["loss"] for s in jax_rec["phase_b_stages"]], rtol=1e-4)
