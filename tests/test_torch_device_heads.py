"""The heads kernel's wrapper (heads/device_heads.py) on the CPU: its plain
version against the engine's chain of torch ops on seeded planes in all
five modes, the constants csrc/cell_heads.cu mirrors, what the wrapper
refuses, and the engine's display step, which keeps the torch heads on
the CPU and counts `heads.device` for frames whose cells the kernel made.
The kernel itself is held to the plain version on the card
(tests/test_torch_device_heads_card.py, chip_smoke.py's phase 3h)."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from rtwc_tpu_torch.camera import default_camera
from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
from rtwc_tpu_torch.engine import Engine
from rtwc_tpu_torch.engine import engine as E
from rtwc_tpu_torch.heads import device_heads as DH
from rtwc_tpu_torch.heads import ansi256 as A
from rtwc_tpu_torch.heads.ascii import ASCII_RAMP
from rtwc_tpu_torch.heads.modes import framebuffer_to_cells
from rtwc_tpu_torch.io import FramebufferSink
from rtwc_tpu_torch.render import hard_kernel as HK
from rtwc_tpu_torch.render import pack as P
from rtwc_tpu_torch.render.reference import (MISS_DISTANCE, downsample_framebuffer,
                                             supersampled_config)
from rtwc_tpu_torch.scene import default_scene
from rtwc_tpu_torch.utils import telemetry as T

torch.set_num_threads(2)

MODES = [RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
         RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS]
SRC = os.path.join(os.path.dirname(HK.__file__), "..", "csrc", "cell_heads.cu")


def _planes(cfg: RenderConfig, seed: int) -> torch.Tensor:
    """Seeded [8, Hp, Wp] planes for cfg's cells at its supersample, padded
    past the frame: hits, misses, depth beyond far and at it, every
    coverage of a cell, grey subpixels, channels at 0, 255 and above,
    shading on the ramp's steps, and normals of every sign."""
    ss = cfg.supersample
    H, W = cfg.height * ss, cfg.width * ss
    rng = np.random.default_rng(seed)
    out = np.zeros((HK.N_OUT, H + 5, W + 16), np.float32)
    # a hit share a cell, then each subpixel: a hit (at far one in ten), a
    # miss or a hit beyond far
    share = rng.choice([0.0, 0.3, 0.7, 1.0], size=(cfg.height, cfg.width))
    hit = rng.random((H, W)) < np.kron(share, np.ones((ss, ss)))
    depth = np.where(rng.random((H, W)) < 0.1, cfg.far, rng.uniform(1.0, cfg.far, size=(H, W)))
    beyond = np.where(rng.random((H, W)) < 0.5, MISS_DISTANCE,
                      rng.uniform(cfg.far, 3 * cfg.far, size=(H, W)))
    depth = np.where(hit, depth, beyond)
    rgb = rng.choice([0.0, 0.5, 254.99, 255.0, 255.5, 300.0], size=(3, H, W))
    rgb = np.where(rng.random((3, H, W)) < 0.6, rng.uniform(0, 280, size=(3, H, W)), rgb)
    grey = rng.random((H, W)) < 0.25
    rgb[1:] = np.where(grey, rgb[0], rgb[1:])
    out[HK.O_R:HK.O_B + 1, :H, :W] = rgb
    out[HK.O_DEPTH, :H, :W] = depth
    out[HK.O_NX:HK.O_NZ + 1, :H, :W] = rng.uniform(-1, 1, size=(3, H, W))
    shading = rng.uniform(-0.2, 1.1, size=(H, W))
    steps = rng.random((H, W)) < 0.2
    out[HK.O_SHADING, :H, :W] = np.where(steps, rng.integers(-1, 69, size=(H, W)) / 67, shading)
    out[:, H:, :] = rng.uniform(-5, 5, size=out[:, H:, :].shape)  # padding: never read
    out[:, :, W:] = rng.uniform(-5, 5, size=out[:, :, W:].shape)
    return torch.from_numpy(out)


def _chain(out: torch.Tensor, cfg: RenderConfig):
    """The engine's torch heads before the kernel: the framebuffer of the
    supersampled render, the downsample, the mode's head."""
    ss_cfg = supersampled_config(cfg)
    fb = HK.planes_to_framebuffer(out, ss_cfg, ss_cfg.height)
    return framebuffer_to_cells(downsample_framebuffer(fb, cfg.supersample), cfg)


@pytest.mark.parametrize("ss", [1, 2, 3])
@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_plain_version_is_the_chain(mode, ss):
    cfg = RenderConfig(width=37, height=11, mode=mode, supersample=ss)
    out = _planes(cfg, seed=11 * ss + MODES.index(mode))
    got = DH.cells_from_planes(out, cfg)
    want = _chain(out, cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    kind, color, char = got
    assert color.shape == ((11, 37, 3) if mode in DH.TRUECOLOR else (11, 37))
    if ss > 1:  # the planes reach every coverage of a cell
        hits = (out[HK.O_DEPTH, :11 * ss, :37 * ss] <= cfg.far).float()
        per_cell = hits.reshape(11, ss, 37, ss).sum((1, 3))
        assert set(per_cell.unique().int().tolist()) >= {0, 1, ss * ss // 2, ss * ss - 1, ss * ss}
    if mode in (RenderMode.BIT_ASCII, RenderMode.RGB_ASCII):
        assert kind.any() and (~kind.bool()).any() and (char != 32).any()
    assert DH.LAUNCHES == 0  # the plain version launches nothing


def test_planes_hold_every_case():
    """The seeded planes have grey subpixels, channels at 0, 255 and past
    it, depth at far and beyond it, and misses."""
    cfg = RenderConfig(width=37, height=11, supersample=2)
    out = _planes(cfg, seed=1)
    rgb, depth = out[:3, :22, :74], out[HK.O_DEPTH, :22, :74]
    assert ((rgb[0] == rgb[1]) & (rgb[1] == rgb[2])).float().mean() > 0.2
    for v in (0.0, 255.0):
        assert (rgb == v).any()
    assert (rgb > 255).any() and (depth == cfg.far).any() and (depth == MISS_DISTANCE).any()
    assert ((depth > cfg.far) & (depth < MISS_DISTANCE)).any()


def _c_array(src: str, name: str) -> list:
    body = re.search(name + r"\[[^\]]*\](?:\[[^\]]*\])? = \{(.*?)\};", src, re.S).group(1)
    return [int(v, 0) for v in re.findall(r"0x[0-9A-Fa-f]+|\d+", body)]


def test_the_kernel_mirrors_the_tables_and_constants():
    with open(SRC) as f:
        src = f.read()
    pal = [(int(r) << 16) | (int(g) << 8) | int(b) for r, g, b in A.ANSI_PALETTE]
    assert _c_array(src, "PALETTE") == pal
    assert _c_array(src, "GREY_LUT") == [int(v) for v in A.GREY_LUT]
    assert _c_array(src, "CUBE_LEVELS") == [int(v) for v in A._CUBE_LEVELS]
    assert _c_array(src, "THRESH") == [int(v) for t in (A._THRESH_R, A._THRESH_G, A._THRESH_B)
                                       for v in t]
    ramp = re.search(r'RAMP\[NUM_ASCII \+ 1\] =\s*"(.*)";', src).group(1)
    assert ramp.replace('\\"', '"') == ASCII_RAMP
    assert re.search(r"constexpr int NUM_ASCII = (\d+);", src).group(1) == str(len(ASCII_RAMP))
    assert re.search(r"constexpr int MAX_SS = (\d+);", src).group(1) == str(DH.MAX_SS)
    assert float(re.search(r"constexpr float MISS = ([\d.]+)f;", src).group(1)) == MISS_DISTANCE
    planes = dict(re.findall(r"(O_[A-Z]+) = (\d+)", src))
    assert {k: int(v) for k, v in planes.items()} == {
        k: getattr(HK, k) for k in ("O_R", "O_G", "O_B", "O_DEPTH", "O_NX", "O_NY", "O_NZ",
                                    "O_SHADING")}
    modes = re.search(r"constexpr int (BIT_ASCII = .*?);", src).group(1)
    assert {RenderMode[k]: int(v) for k, v in re.findall(r"(\w+) = (\d+)", modes)} == DH.MODES
    struct = re.search(r"struct HeadsParams \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(int|float) ([\w, ]+);", struct)
    names = [(t, n.strip()) for t, group in fields for n in group.split(",")]
    want = [("int" if ct is ctypes.c_int else "float", n)
            for n, ct in DH.HeadsParams._fields_]
    assert names == want
    # the luminance sum of ansi256_from_rgb fits the kernel's unsigned 32 bits
    assert (3567664 + 11998547 + 1211005) * 255 + (1 << 23) < 1 << 32


@pytest.mark.parametrize("ss", [1, 2, 3, 8])
def test_mean_factor_is_torchs_float_scale(ss):
    for cells in (1, 960000, 3 * 960000, 12345):
        want = np.float32(cells) / np.float32(cells * ss * ss)
        assert DH.mean_factor(cells, ss) == float(want)
    assert DH.mean_factor(960000, 2) == 0.25


def _bad(case):
    cfg = RenderConfig(width=6, height=3, supersample=2, mode=RenderMode.BIT_PIXEL)
    out = _planes(cfg, seed=2)
    return {
        "meta device": (out.to("meta"), cfg),
        "float64": (out.double(), cfg),
        "seven planes": (out[:7], cfg),
        "too few rows": (out[:, :5], cfg),
        "too few columns": (out[:, :, :11], cfg),
        "not contiguous": (out.transpose(1, 2).contiguous().transpose(1, 2), cfg),
        "two dims": (out[0], cfg),
        "headless": (out, cfg.replace(mode=RenderMode.HEADLESS)),
        "ss 0": (out, cfg.replace(supersample=0)),
        "ss past MAX_SS": (out, cfg.replace(supersample=DH.MAX_SS + 1)),
    }[case]


@pytest.mark.parametrize("case", ["meta device", "float64", "seven planes", "too few rows",
                                  "too few columns", "not contiguous", "two dims", "headless",
                                  "ss 0", "ss past MAX_SS"])
def test_the_wrapper_refuses_what_it_does_not_take(case):
    with pytest.raises(ValueError):
        DH.cells_from_planes(*_bad(case))


def test_render_frame_packed_is_the_planes_then_the_framebuffer():
    cfg = RenderConfig(width=48, height=16, shadows=True, max_spheres=16, max_planes=4)
    scene = default_scene(cfg)
    cam = P.pack_camera(default_camera(), scene.device)
    planes = HK.render_planes_packed(scene, cam, cfg)
    fb = HK.render_frame_packed(scene, cam, cfg)
    assert planes.shape == (HK.N_OUT, 16, 48)
    want = HK.planes_to_framebuffer(planes, cfg, 16)
    for name in ("rgb", "normal", "depth", "shading", "hit", "coverage", "alpha"):
        assert torch.equal(getattr(fb, name), getattr(want, name))


@pytest.mark.parametrize("mode", [RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII],
                         ids=["bit_pixel", "rgb_ascii"])
def test_the_cpu_step_keeps_the_torch_heads(monkeypatch, mode):
    """On the CPU `_device_step` calls the engine module's
    `downsample_framebuffer` and `framebuffer_to_cells` (a planted fault
    patches the latter), and its Frame is not the kernel's."""
    calls = []

    def heads(fb, config):
        calls.append("heads")
        return framebuffer_to_cells(fb, config)

    def down(fb, ss):
        calls.append("down")
        return downsample_framebuffer(fb, ss)
    monkeypatch.setattr(E, "framebuffer_to_cells", heads)
    monkeypatch.setattr(E, "downsample_framebuffer", down)
    cfg = RenderConfig(width=24, height=8, mode=mode, supersample=2, shadows=True,
                       max_spheres=16, max_planes=4)
    scene = default_scene(cfg)
    cam = P.pack_camera(default_camera(), scene.device)
    dt = torch.full((1,), 0.05)
    _, frame = E._device_step(scene, cam, dt, cfg)
    assert calls == ["down", "heads"] and frame.heads_device is False
    # the cells are the heads of the same planes
    _, want = E._device_step(scene, cam, dt, cfg)
    planes = HK.render_planes_packed(E.update_scene(scene, dt, cfg.bob_min_y, cfg.bob_max_y),
                                     cam, supersampled_config(cfg))
    for a, b, c in zip(frame.cells, want.cells, DH.cells_from_planes(planes, cfg)):
        assert torch.equal(a, b) and torch.equal(a, c)


def _engine():
    cfg = RenderConfig(width=24, height=8, mode=RenderMode.BIT_PIXEL, max_spheres=16,
                       max_planes=4)
    sink = FramebufferSink(keep_all=True)
    return Engine(cfg, EngineConfig(spawn=False, show_fps=False, seed=1), presenter=sink,
                  interactive=False, device="cpu"), sink


@pytest.mark.parametrize("on_device", [True, False], ids=["kernel", "torch"])
def test_publish_counts_frames_whose_cells_the_kernel_made(on_device):
    """`heads.device` adds one at publication for a Download whose Frame
    the heads kernel made, none otherwise; the bytes are the cells'."""
    eng, sink = _engine()
    frame = eng.device_frame(0.05)
    assert frame.heads_device is False  # host cells: the torch heads
    down = eng._start_download(frame._replace(heads_device=on_device))
    assert down.heads_device is on_device
    before = T.counters().get("heads.device", 0)
    eng._publish(down)
    assert T.counters().get("heads.device", 0) - before == int(on_device)
    assert len(sink.frames) == 1 and sink.frames[0].count(b"\n") == 8
