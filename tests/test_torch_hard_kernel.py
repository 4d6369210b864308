"""rtwc_tpu_torch K7 path on the CPU (the wrapper runs the kernel's plain
torch version for CPU tensors) against JAX `render_frame_pallas` in
interpret mode and against JAX `render_frame`, plus the band hook, the
launch counter, the wrapper's input checks and an import without nvcc.

Framebuffer tolerance and flip accounting: see tests/test_torch_render.py
(hit or shadow flips on < 0.5 % of pixels; elsewhere allclose(atol=2e-3,
rtol=1e-4) on pixels both call a hit). The CUDA kernel itself runs only
on a card: chip_smoke.py holds it against this plain version there."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.render import pack as JP
from rtwc_tpu.render import reference as JR
from rtwc_tpu.render.pallas_kernel import hard_band_packed as j_band
from rtwc_tpu.render.pallas_kernel import render_frame_pallas
from rtwc_tpu_torch.render import _cuda, hard_kernel
from rtwc_tpu_torch.render import pack as TP
from test_torch_render import CASES, CFG, compare_fb, shadow_flips

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(name):
    make_scene, make_cam, cfg = CASES[name]
    jscene, jcam = make_scene(cfg), make_cam()
    return jscene, jcam, cfg, TS.scene_from_numpy(jscene), TC.camera_from_numpy(jcam)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_path_matches_jax_pallas(name):
    jscene, jcam, cfg, tscene, tcam = _inputs(name)
    launches = hard_kernel.LAUNCHES
    fb = hard_kernel.render_frame_kernel(tscene, tcam, cfg)
    assert hard_kernel.LAUNCHES == launches  # CPU tensors: plain version, no launch
    assert fb.rgb.shape == (cfg.height, cfg.width, 3)
    ref = JR.render_frame(jscene, jcam, cfg)
    compare_fb(render_frame_pallas(jscene, jcam, cfg), fb, shadow_flips(jscene, jcam, cfg, ref))


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_path_matches_jax_reference(name):
    jscene, jcam, cfg, tscene, tcam = _inputs(name)
    ref = JR.render_frame(jscene, jcam, cfg)
    compare_fb(ref, hard_kernel.render_frame_kernel(tscene, tcam, cfg),
               shadow_flips(jscene, jcam, cfg, ref))


@pytest.mark.parametrize("tile", [(16, 16), (8, 32)], ids=["16x16", "8x32"])
def test_band_matches_jax_band(tile):
    jscene, jcam, _, tscene, tcam = _inputs("random_scene")
    cfg = CFG.replace(shadows=True)
    row0, band_h = 16, 24
    jsph, jpl, jcnt = JP.pack_scene(jscene)
    jout = np.asarray(j_band(jsph, jpl, jcnt.reshape(1, 2), JP.pack_camera(jcam), row0,
                             config=cfg, band_h=band_h))[:, :band_h, :cfg.width]
    tsph, tpl, tcnt = TP.pack_scene(tscene)
    tout = hard_kernel.hard_band_packed(tsph, tpl, tcnt, TP.pack_camera(tcam), row0,
                                        config=cfg, band_h=band_h, bh=tile[0], bw=tile[1])
    assert tout.shape == (8, hard_kernel.round_up(band_h, tile[0]),
                          hard_kernel.round_up(cfg.width, tile[1]))
    tout = tout[:, :band_h, :cfg.width].numpy()
    hit_j, hit_t = jout[3] < 1e8, tout[3] < 1e8
    assert np.mean(hit_j != hit_t) < 0.005
    both = hit_j & hit_t
    np.testing.assert_allclose(tout[:, both], jout[:, both], atol=2e-3, rtol=1e-4)
    # the band is the same rows of the full frame
    full = hard_kernel.render_frame_kernel(tscene, tcam, cfg)
    np.testing.assert_array_equal(tout[3], full.depth.numpy()[row0:row0 + band_h])


def test_plain_is_what_the_wrapper_runs_on_cpu():
    _, _, cfg, tscene, tcam = _inputs("shadows")
    sph, pl, counts = TP.pack_scene(tscene)
    cam = TP.pack_camera(tcam)
    lists = hard_kernel.tile_lists(sph, cam, cfg, 16, 16)
    args = (sph, pl, counts.reshape(1, 2), cam, lists)
    a = hard_kernel.hard_render_packed(*args, config=cfg, bh=16, bw=16)
    b = hard_kernel.hard_render_plain(*args, config=cfg, bh=16, bw=16)
    assert a.shape == (8, 48, 128) and torch.equal(a, b)
    assert hard_kernel.LAUNCHES == 0


def _bad(args, **kw):
    sph, pl, counts, cam, lists = args
    out = dict(sph=sph, pl=pl, counts=counts, cam=cam, lists=lists)
    out.update(kw)
    return tuple(out.values())


@pytest.mark.parametrize("which", ["dtype", "shape", "lists", "contiguous", "tile", "device"])
def test_wrapper_rejects_bad_inputs(which):
    _, _, cfg, tscene, tcam = _inputs("default")
    sph, pl, counts = TP.pack_scene(tscene)
    cam = TP.pack_camera(tcam)
    lists = hard_kernel.tile_lists(sph, cam, cfg, 16, 16)
    args = (sph, pl, counts.reshape(1, 2), cam, lists)
    bh = bw = 16
    if which == "dtype":
        args = _bad(args, sph=sph.double())
    elif which == "shape":
        args = _bad(args, cam=cam[:, :12].contiguous())
    elif which == "lists":
        args = _bad(args, lists=hard_kernel.tile_lists(sph, cam, cfg, 8, 8))
    elif which == "contiguous":
        args = _bad(args, pl=torch.cat([pl, pl], 1)[:, ::2])
    elif which == "tile":
        bh = bw = 64
        args = _bad(args, lists=hard_kernel.tile_lists(sph, cam, cfg, 64, 64))
    elif which == "device":
        args = _bad(args, counts=counts.reshape(1, 2).to("meta"))
    with pytest.raises((ValueError, TypeError)):
        hard_kernel.hard_render_packed(*args, config=cfg, bh=bh, bw=bw)


def test_import_needs_no_nvcc_and_find_nvcc_raises(tmp_path):
    """Importing the kernel modules builds nothing and needs no nvcc; a
    build without nvcc raises a clear error (no silent fallback)."""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # no nvcc on it
    env["PYTHONPATH"] = ROOT
    code = (
        "import os, sys\n"
        "from rtwc_tpu_torch.render import _cuda, hard_kernel\n"
        "import rtwc_tpu_torch.engine.run\n"
        "assert hard_kernel.LAUNCHES == 0\n"
        "assert 'jax' not in sys.modules\n"
        "try:\n"
        "    _cuda.find_nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', e)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        assert "RAISED nvcc not found" in proc.stdout
    assert _cuda.library_path("hard_render").endswith(os.path.join("_build", "libhard_render.so"))
