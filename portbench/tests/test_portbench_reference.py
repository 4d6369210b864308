"""The frozen reference held to the port's plain paths on the CPU at small
sizes, and the imports of the benchmark."""
from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from portbench.reference import camera as rcam
from portbench.reference import encode, hard, heads, scenes, soft
from portbench.reference.config import Render

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("bit_ascii", "bit_pixel", "rgb_ascii", "rgb_pixel", "rgb_normals")


def _cfgs(width=48, height=20, **kw):
    from rtwc_tpu_torch.config import RenderConfig, RenderMode

    port = RenderConfig(width=width, height=height, **kw)
    d = {f: getattr(port, f) for f in port.__dataclass_fields__}
    d["mode"] = port.mode.value
    return port.replace(**{}), Render.from_dict(d), RenderMode


def _port_scene(s):
    from portbench.drivers.common import port_scene

    return port_scene(s, "cpu")


def _port_camera(pos, rot):
    from rtwc_tpu_torch.camera import Camera

    return Camera(pos=torch.from_numpy(pos.copy()), rot=torch.from_numpy(rot.copy()))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(root):
    for d, _, files in os.walk(root):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_reference_imports_nothing_of_the_port():
    for path in _py_files(os.path.join(HERE, "reference")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"rtwc_tpu_torch", "rtwc_tpu", "jax", "jaxlib", "flax"}, path


def test_nothing_in_portbench_imports_jax():
    for path in _py_files(HERE):
        if os.sep + "tests" + os.sep in path:
            continue
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"rtwc_tpu", "jax", "jaxlib", "flax"}, path


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_scenes_match_the_port(seed):
    from rtwc_tpu_torch.scene import default_scene, random_scene, spawn_random_sphere, update_scene

    port_cfg, _, _ = _cfgs()
    for mine, theirs in (
            (scenes.random_scene(20, 1, 20, 4, seed), random_scene(20, max_spheres=20, max_planes=4,
                                                                     seed=seed)),
            (scenes.default_scene(256, 16, seed), default_scene(port_cfg.replace(max_spheres=256),
                                                                 seed=seed))):
        for g in ("spheres", "planes"):
            for k, v in mine[g].items():
                assert np.array_equal(v, getattr(getattr(theirs, g), k).numpy()), (g, k)
    # physics ticks and spawns
    s, p = scenes.default_scene(16, 4, seed), default_scene(port_cfg.replace(max_spheres=16),
                                                            seed=seed)
    r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in range(40):
        dt = np.float32(0.013 + 0.001 * (i % 7))
        scenes.update_scene(s, dt, -10.0, 10.0)
        p = update_scene(p, float(dt), -10.0, 10.0)
        if i % 10 == 3:
            scenes.spawn_random_sphere(s, r1)
            p = spawn_random_sphere(p, r2)
    for k, v in s["spheres"].items():
        assert np.array_equal(v, getattr(p.spheres, k).numpy()), k


def test_camera_controller_matches_the_port():
    from rtwc_tpu_torch.camera import Keys, add_rot, move

    pos, rot = rcam.default_pose()
    cam = _port_camera(pos, rot)
    for i, key in enumerate("wdsawwdd"):
        dt = 0.004 + 0.001 * i
        rot = rcam.add_rot(rot, 0.0, (-1) ** i * 3.0, 0.002)
        pos = rcam.move(pos, rot, {key: 1}, dt, 10.0)
        cam = add_rot(cam, 0.0, (-1) ** i * 3.0, 0.0, 0.002)
        cam = move(cam, Keys(**{key: 1}), dt, 10.0)
    assert np.array_equal(pos, cam.pos.numpy()) and np.array_equal(rot, cam.rot.numpy())


@pytest.mark.parametrize("shadows", [False, True])
def test_hard_frame_matches_the_port(shadows):
    from rtwc_tpu_torch.render.reference import render_frame

    port_cfg, cfg, _ = _cfgs(shadows=shadows, max_spheres=24)
    s = scenes.random_scene(12, 1, 24, 4, 3)
    pos, rot = rcam.default_pose()
    rot = rcam.add_rot(rot, 40.0, 25.0, 0.002)
    mine = hard.render(s, pos, rot, cfg, "cpu")
    theirs = render_frame(_port_scene(s), _port_camera(pos, rot), port_cfg)
    assert torch.equal(mine["hit"], theirs.hit)
    torch.testing.assert_close(mine["rgb"], theirs.rgb, atol=2e-3, rtol=1e-4)
    torch.testing.assert_close(mine["depth"], theirs.depth, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_heads_and_bytes_match_the_port(mode):
    from rtwc_tpu_torch.heads import encode_frame_numpy, framebuffer_to_cells
    from rtwc_tpu_torch.render.reference import (Framebuffer, downsample_framebuffer,
                                                 render_frame, supersampled_config)

    port_cfg, cfg, RenderMode = _cfgs(shadows=True, supersample=2, max_spheres=24)
    port_cfg, cfg = port_cfg.replace(mode=RenderMode(mode)), cfg.replace(mode=mode)
    s = scenes.random_scene(12, 1, 24, 4, 5)
    pos, rot = rcam.default_pose()
    fb = render_frame(_port_scene(s), _port_camera(pos, rot), supersampled_config(port_cfg))
    theirs = framebuffer_to_cells(downsample_framebuffer(fb, 2), port_cfg)
    mine = heads.cells(hard.downsample({"rgb": fb.rgb, "normal": fb.normal, "depth": fb.depth,
                                        "shading": fb.shading, "hit": fb.hit}, 2), mode, cfg.far)
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
    cells = [x.numpy() for x in mine]
    data = encode.encode(*cells)
    assert data == encode_frame_numpy(*cells)
    got = encode.decode(data, cfg.height, cfg.width)
    assert all(np.array_equal(a, b) for a, b in zip(got, cells))
    assert Framebuffer is not None


def test_decode_refuses_a_broken_stream():
    cells = (np.zeros((4, 6), np.int32), np.arange(72, dtype=np.int32).reshape(4, 6, 3),
             np.full((4, 6), 32, np.int32))
    data = encode.encode(*cells)
    assert encode.decode(data, 4, 6) is not None
    assert encode.decode(data[:-1], 4, 6) is None
    assert encode.decode(data, 4, 5) is None
    assert encode.decode(data.replace(b";", b":", 1), 4, 6) is None


@pytest.mark.parametrize("shadows", [False, True])
def test_soft_loss_and_gradients_match_the_port(shadows):
    from rtwc_tpu_torch.render.softmin import render_frame_soft
    from rtwc_tpu_torch.scene import Planes, Scene, Spheres
    from rtwc_tpu_torch.camera import Camera

    port_cfg, cfg, _ = _cfgs(width=40, height=24, shadows=shadows, max_spheres=8, max_planes=2,
                             soft_miss_penalty=300.0, soft_mask_k=10.0)
    true = scenes.random_scene(6, 1, 8, 2, 11, spread=12.0)
    start = scenes.perturb_centres(scenes.copy(true), 0.7, np.random.default_rng(1))
    pos, rot = rcam.default_pose()
    tlv = soft.leaves(true, pos, rot, "cpu", torch.float32, ())
    target, target_a = soft.render(tlv, cfg, 0.5, shadows)
    names = ["spheres.center", "spheres.radius", "spheres.color", "planes.center",
             "planes.normal", "camera.pos", "camera.rot"]
    lv = soft.leaves(start, pos, rot, "cpu", torch.float32, names)
    loss, grads = soft.loss_and_grads(lv, names, cfg, 0.5, shadows, target, target_a, 1.0)

    leaves = {k: v.detach().clone().requires_grad_(k in names) for k, v in lv.items()}
    sc = Scene(spheres=Spheres(**{f: leaves[f"spheres.{f}"] for f in start["spheres"]}),
               planes=Planes(**{f: leaves[f"planes.{f}"] for f in start["planes"]}))
    fb = render_frame_soft(sc, Camera(pos=leaves["camera.pos"], rot=leaves["camera.rot"]),
                           port_cfg, tau=0.5)
    from portbench.drivers.fit_step import loss_of

    ref = loss_of(fb, target, target_a, 1.0)
    ref.backward()
    assert abs(loss - float(ref.detach())) <= 1e-5 * abs(float(ref.detach()))
    for k in names:
        torch.testing.assert_close(grads[k], leaves[k].grad, atol=1e-5, rtol=2e-3)


def test_the_reference_leaves_its_inputs_unchanged():
    """The reference's Adam steps its own copies: on the CPU too, where a
    tensor made from a float32 array could share its memory; following
    the program, it copies the program's leaves."""
    from portbench.drivers.fit_step import FitCell
    from portbench import harness

    config, traffic = harness.cell_files("fit_1080p_s20.shadowed_mse")
    config = harness.merged(config, {"render": {"width": 32, "height": 16}})
    cell = FitCell(config, traffic, 1, "cpu")
    cell.target, cell.target_a = soft.render(
        soft.leaves(cell.true, cell.pos, cell.rot, "cpu", torch.float32, ()), cell.cfg, cell.tau,
        cell.cfg.shadows)
    before = scenes.copy(cell.start), cell.pos.copy(), cell.rot.copy()
    first = cell.trajectory(torch.float32)
    assert all(np.array_equal(a, b) for g in ("spheres", "planes")
               for a, b in zip(before[0][g].values(), cell.start[g].values()))
    assert np.array_equal(before[1], cell.pos) and np.array_equal(before[2], cell.rot)
    assert cell.trajectory(torch.float32)["loss"] == first["loss"]
    points = [{k: v.clone() for k, v in pt.items()} for pt in first["points"]]
    ref = cell.reference_at(first["points"])
    assert all(torch.equal(a[k], b[k]) for a, b in zip(points, first["points"]) for k in a)
    assert ref["loss"] == first["loss"]
