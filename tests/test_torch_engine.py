"""rtwc_tpu_torch engine loop and CLI on the CPU (`device="cpu"`), mirroring
tests/test_engine.py, plus the whole slice against the JAX package: the
port's `_render_step` against JAX's `_render_step` for 5 frames at a fixed
dt in every mode. Tolerance: cells (kind, char, colour) equal on >= 99.5 %
of cells; on cells both packages call a hit, a differing truecolour channel
is off by at most 1 (truncation at a boundary)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.config as JCFG
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.engine.engine import _render_step as j_step
from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
from rtwc_tpu_torch.engine import Engine
from rtwc_tpu_torch.engine.engine import _render_step as t_step
from rtwc_tpu_torch.io import FramebufferSink
from rtwc_tpu_torch.render import hard_kernel

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = [RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
         RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS]


def _engine(mode=RenderMode.RGB_PIXEL, spawn=False, **kw):
    rcfg = RenderConfig(width=40, height=24, mode=mode, max_spheres=16, max_planes=4)
    ecfg = EngineConfig(spawn=spawn, show_fps=False, seed=1)
    sink = FramebufferSink(keep_all=True)
    return Engine(rcfg, ecfg, presenter=sink, interactive=False, device="cpu", **kw), sink


def test_engine_runs_frames_and_publishes():
    engine, sink = _engine()
    engine.run(max_frames=5)
    assert len(sink.frames) == 5
    assert all(f.count(b"\n") == 24 for f in sink.frames)
    assert hard_kernel.LAUNCHES == 0


def test_engine_animates_scene():
    engine, _ = _engine()
    c0 = engine.scene.spheres.center.clone()
    engine.run(max_frames=8)
    c1 = engine.scene.spheres.center
    active = engine.scene.spheres.active > 0.5
    assert (c0[active, 1] != c1[active, 1]).all()
    assert torch.equal(c0[active][:, [0, 2]], c1[active][:, [0, 2]])


def test_engine_spawn_grows_scene():
    engine, _ = _engine(spawn=True)
    engine.telemetry.interval = 0.0
    n0 = engine.scene.n_spheres
    engine.run(max_frames=3)
    assert engine.scene.n_spheres > n0


def test_engine_autogrows_capacity_when_full():
    rcfg = RenderConfig(width=40, height=24, max_spheres=6, max_planes=2)
    ecfg = EngineConfig(spawn=True, show_fps=False, seed=1, max_grow_spheres=24)
    sink = FramebufferSink(keep_all=True)
    engine = Engine(rcfg, ecfg, presenter=sink, interactive=False, device="cpu")
    engine.telemetry.interval = 0.0
    assert engine.scene.spheres.capacity == 6
    engine.run(max_frames=10)
    assert engine.scene.spheres.capacity == 24
    assert engine.scene.n_spheres == 15
    assert len(sink.frames) == 10


def test_engine_autogrow_respects_cap():
    rcfg = RenderConfig(width=40, height=24, max_spheres=6, max_planes=2)
    ecfg = EngineConfig(spawn=True, show_fps=False, seed=1, max_grow_spheres=6)
    engine = Engine(rcfg, ecfg, presenter=FramebufferSink(keep_all=True), interactive=False,
                    device="cpu")
    engine.telemetry.interval = 0.0
    engine.run(max_frames=6)
    assert engine.scene.spheres.capacity == 6
    assert engine.scene.n_spheres == 6


def test_engine_stops_when_presenter_dies():
    engine, sink = _engine()
    engine.start()
    assert engine.run_frame()
    sink.cleanup()
    assert not engine.run_frame()
    engine.cleanup()


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_engine_all_modes(mode):
    engine, sink = _engine(mode=mode)
    engine.run(max_frames=2)
    assert sink.last.count(b"\n") == 24
    assert (b";2;" in sink.last) == mode.value.startswith("rgb")


def test_cuda_device_without_card_raises(monkeypatch):
    """--device cuda never falls back to the CPU; an unknown renderer raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(RenderConfig(), presenter=FramebufferSink(), interactive=False, device="cuda")
    from rtwc_tpu_torch.engine.run import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--width", "16", "--height", "8", "--frames", "1", "--no-fps"])
    with pytest.raises(ValueError, match="renderer"):
        Engine(RenderConfig(renderer="pallas"), presenter=FramebufferSink(), interactive=False,
               device="cpu")


def test_cli_save_and_resume_scene(tmp_path, capsys):
    from rtwc_tpu_torch.engine.run import main

    path = str(tmp_path / "ckpt.npz")
    base = ["--width", "32", "--height", "16", "--frames", "2", "--no-fps", "--no-spawn",
            "--n-spheres", "3", "--device", "cpu"]
    assert main(base + ["--save-scene", path]) == 0
    scene, cam = TS.load_scene(path)
    assert scene.n_spheres == 3 and cam is not None
    assert main(base + ["--scene", path, "--renderer", "reference"]) == 0
    assert "\x1b[" in capsys.readouterr().out


def test_cli_runs_without_jax(tmp_path):
    """The root conftest imports JAX into this process, so the check that
    the port never imports it runs in a subprocess."""
    code = (
        "import sys\n"
        "from rtwc_tpu_torch.engine.run import main\n"
        "rc = main(['--width', '32', '--height', '12', '--frames', '2', '--no-fps',\n"
        "           '--mode', 'rgb_ascii', '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NO_JAX_OK', file=sys.stderr)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                          capture_output=True, timeout=180)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"NO_JAX_OK" in proc.stderr
    assert proc.stdout.count(b"\n") >= 12 and b";2;" in proc.stdout


def _jax_cfg(cfg):
    """The JAX package's RenderConfig with the same fields as the port's."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return JCFG.RenderConfig(**{**kw, "mode": JCFG.RenderMode(cfg.mode.value)})


def _cells_agree(jc, tc):
    jk, jcol, jch = (np.asarray(x) for x in jc)
    tk, tcol, tch = (x.numpy() for x in tc)
    same = (jk == tk) & (jch == tch)
    same &= (jcol == tcol).all(-1) if jcol.ndim == 3 else (jcol == tcol)
    assert same.mean() >= 0.995, f"cells agree on {same.mean():.4f}"
    if jcol.ndim == 3:  # truecolour: cells both show in colour (a hit or AA coverage)
        shown = (jcol.sum(-1) > 0) & (tcol.sum(-1) > 0)
        assert np.abs(jcol.astype(int) - tcol.astype(int))[shown].max(initial=0) <= 1


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_render_step_matches_jax(mode):
    cfg = RenderConfig(width=120, height=48, mode=mode, max_spheres=16, max_planes=4,
                       shadows=mode == RenderMode.RGB_ASCII,
                       supersample=2 if mode == RenderMode.BIT_ASCII else 1)
    js = JS.random_scene(8, 1, max_spheres=16, max_planes=4, seed=6)
    ts = TS.scene_from_numpy(js)
    jcam = JC.Camera(pos=np.array([0.0, 4.0, -6.0], np.float32),
                     rot=np.array([0.15, 3.0, 0.0], np.float32))
    tcam = TC.camera_from_numpy(jcam)
    for _ in range(5):
        js, jc = j_step(js, jcam, np.float32(0.05), _jax_cfg(cfg))
        ts, tc = t_step(ts, tcam, 0.05, cfg)
        _cells_agree(jc, tc)
    np.testing.assert_array_equal(ts.spheres.center.numpy(), np.asarray(js.spheres.center))
