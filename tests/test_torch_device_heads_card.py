"""The heads kernel (csrc/cell_heads.cu) on the card, against its plain
version (heads/device_heads.py, the engine's chain of torch ops) on the
same planes of a real K7 frame; the display graph's replays against the
eager engine, through a mode switch; the kernel's launches a frame.

These tests need a CUDA card: they carry the `card` marker and skip
where torch finds none. On a machine with one card:

    python -m pytest tests/test_torch_device_heads_card.py -q -m card -s --confcutdir=tests

(`-s` shows each case's count of cells whose colour differs). This file
imports nothing of JAX."""
import pytest
import torch

from rtwc_tpu_torch.camera import default_camera
from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
from rtwc_tpu_torch.engine import Engine
from rtwc_tpu_torch.heads import device_heads as DH
from rtwc_tpu_torch.io import FramebufferSink
from rtwc_tpu_torch.render import hard_kernel as HK
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render.reference import supersampled_config
from rtwc_tpu_torch.scene import random_scene
from rtwc_tpu_torch.utils import telemetry as T

MODES = [RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
         RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS]
# (cells wide, high, supersample): the console's 1920x500 at 2x, the native
# 400x150 at 1x, and 3x and 4x on the kernel's general path
SIZES = {"1920x500 ss2": (1920, 500, 2), "400x150 ss1": (400, 150, 1),
         "401x151 ss3": (401, 151, 3), "320x100 ss4": (320, 100, 4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch finds none")
    return torch.device("cuda", 0)


def _planes(dev, cfg: RenderConfig) -> torch.Tensor:
    """K7's planes of the supersampled frame: random_scene(100), shadows."""
    scene = random_scene(100, seed=0, device=dev)
    cam = P.pack_camera(default_camera(), dev)
    return HK.render_planes_packed(scene, cam, supersampled_config(cfg))


def color_diffs(got, want) -> int:
    """Cells whose colour differs between two (kind, color, char)."""
    diff = got[1] != want[1]
    return int((diff.any(-1) if diff.dim() == 3 else diff).sum())


@pytest.mark.card
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_the_kernel_equals_the_plain_chain_on_a_k7_frame(card, mode, size):
    """kind, colour and char exact: the kernel sums as torch's CUDA mean
    does. The cells whose colour differs are counted and printed."""
    w, h, ss = SIZES[size]
    cfg = RenderConfig(width=w, height=h, mode=mode, supersample=ss, shadows=True)
    planes = _planes(card, cfg)
    got = DH.cells_from_planes(planes, cfg)
    want = DH.cells_from_planes_plain(planes, cfg)
    torch.cuda.synchronize()
    n = color_diffs(got, want)
    print(f"{mode.value} {size}: {n} of {w * h} cells differ in colour")
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and g.shape == p.shape and g.device == planes.device
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]) and n == 0


@pytest.mark.card
def test_the_graph_replays_equal_the_eager_engine_through_a_mode_switch(card):
    """Two engines at 1920x500 x2 with shadows, graph and eager: the same
    cells and published bytes frame by frame, bit for bit, across a
    switch from bit_pixel to rgb_ascii and back; every frame's cells from
    the kernel (`heads.device`), which a replay launches once."""
    cfg = RenderConfig(width=1920, height=500, mode=RenderMode.BIT_PIXEL, supersample=2,
                       shadows=True)
    ecfg = EngineConfig(spawn=False, show_fps=False, seed=1)
    sinks = [FramebufferSink(keep_all=True) for _ in range(2)]
    engines = [Engine(cfg, ecfg, scene=random_scene(100, seed=0), presenter=sink,
                      interactive=False, device=card, graph=graph)
               for sink, graph in zip(sinks, (True, False))]
    before = T.counters().get("heads.device", 0)
    n_frames, switches = 12, {4: RenderMode.RGB_ASCII, 8: RenderMode.BIT_PIXEL}
    for i in range(n_frames):
        for e in engines:
            if i in switches:
                e.rcfg = e.rcfg.replace(mode=switches[i])
        frames = [e.device_frame(0.016) for e in engines]
        torch.cuda.synchronize()
        assert all(f.heads_device for f in frames)
        for a, b in zip(*(f.cells for f in frames)):
            assert torch.equal(a, b), f"frame {i}: the graph's cells differ from the eager ones"
        for e, f in zip(engines, frames):
            e._publish(e._start_download(f))
        assert sinks[0].frames[-1] == sinks[1].frames[-1], f"frame {i}: bytes differ"
    assert T.counters().get("heads.device", 0) - before == 2 * n_frames
    disp = engines[0].display
    assert disp.captures == 1 + len(switches) and disp.replay_launches.get("cell_heads") == 1


@pytest.mark.card
def test_one_launch_a_frame(card):
    """An eager engine launches the kernel once a frame; a graph engine
    twice a capture (its eager first frame and the capture) and none a
    replay."""
    cfg = RenderConfig(width=400, height=150, mode=RenderMode.BIT_ASCII, supersample=2)
    ecfg = EngineConfig(spawn=False, show_fps=False, seed=1)
    for graph, want in ((False, 7), (True, 2)):
        eng = Engine(cfg, ecfg, presenter=FramebufferSink(), interactive=False, device=card,
                     graph=graph)
        before = DH.LAUNCHES
        eng.run(max_frames=7)
        torch.cuda.synchronize()
        assert DH.LAUNCHES - before == want
