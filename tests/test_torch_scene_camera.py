"""rtwc_tpu_torch scene / camera / controller / checkpoint parity with the
JAX package, on the same numpy-seeded inputs (CPU).

Tolerances: scenes, update_scene and .npz round trips are bit-equal (the
same NumPy generators and the same f32 operations); camera basis and rays
match to atol 1e-6 because sin / cos come from different libraries."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rtwc_tpu.camera as JC
import rtwc_tpu.scene as JS
import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu.config import RenderConfig

torch.set_num_threads(2)

CFG = RenderConfig(width=120, height=48, max_spheres=16, max_planes=4)
SPHERE_FIELDS = ("center", "radius", "color", "speed", "mover", "active")
PLANE_FIELDS = ("center", "normal", "color", "width", "height", "active")


def assert_scene_equal(jscene, tscene):
    for node, fields in (("spheres", SPHERE_FIELDS), ("planes", PLANE_FIELDS)):
        for f in fields:
            a = np.asarray(getattr(getattr(jscene, node), f))
            b = getattr(getattr(tscene, node), f).numpy()
            assert a.dtype == b.dtype == np.float32, (node, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{node}.{f}")


BUILDERS = {
    "default": (lambda m: m.default_scene(CFG, seed=4)),
    "random10_seed3": (lambda m: m.random_scene(10, 1, max_spheres=16, max_planes=4, seed=3)),
    "random20_seed7": (lambda m: m.random_scene(20, 2, seed=7, spread=25.0)),
    "empty": (lambda m: m.empty_scene(8, 2)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_scene_builders_bit_equal(name):
    assert_scene_equal(BUILDERS[name](JS), BUILDERS[name](TS))


def test_bridge_equals_native_builder():
    assert_scene_equal(JS.default_scene(CFG), TS.scene_from_numpy(JS.default_scene(CFG)))


def test_spawn_grow_and_full_pool_bit_equal():
    js, ts = JS.default_scene(CFG.replace(max_spheres=6)), TS.default_scene(CFG.replace(max_spheres=6))
    jr, tr = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):  # one spawn fills the pool, the rest are refused
        js, ts = JS.spawn_random_sphere(js, jr), TS.spawn_random_sphere(ts, tr)
    assert ts.n_spheres == 6
    assert_scene_equal(js, ts)
    js, ts = JS.grow_scene(js, max_spheres=12, max_planes=6), TS.grow_scene(ts, 12, 6)
    js, ts = JS.spawn_random_sphere(js, jr), TS.spawn_random_sphere(ts, tr)
    assert_scene_equal(js, ts)
    with pytest.raises(ValueError):
        TS.grow_scene(ts, max_spheres=4)


@pytest.mark.parametrize("dt", [0.016, 0.1, 0.75, 3.0])
def test_update_scene_bit_equal(dt):
    js = JS.random_scene(12, 1, max_spheres=16, seed=5)
    ts = TS.scene_from_numpy(js)
    for _ in range(5):
        js = JS.update_scene(js, np.float32(dt), -10.0, 10.0)
        ts = TS.update_scene(ts, dt, -10.0, 10.0)
    assert_scene_equal(js, ts)


@pytest.mark.parametrize("dt", [0.016, 0.1, 0.75, 3.0])
def test_update_scene_with_a_tensor_dt_bit_equal(dt):
    """The display graph's time step: an f32 tensor on the scene's device."""
    js = JS.random_scene(12, 1, max_spheres=16, seed=5)
    ts = TS.scene_from_numpy(js)
    for _ in range(5):
        js = JS.update_scene(js, np.float32(dt), -10.0, 10.0)
        ts = TS.update_scene(ts, torch.full((1,), np.float32(dt)), -10.0, 10.0)
    assert_scene_equal(js, ts)


ROTS = [(0.0, math.pi, 0.0), (0.25, 2.8, 0.0), (-1.2, -0.4, 0.3)]


@pytest.mark.parametrize("rot", ROTS)
def test_basis_matches(rot):
    r = np.array(rot, np.float32)
    for a, b in zip(JC.basis(jnp.asarray(r)), TC.basis(torch.from_numpy(r))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    for a, b in zip(JC.static_basis(jnp.asarray(r)), TC.static_basis(torch.from_numpy(r))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


@pytest.mark.parametrize("rot", ROTS)
def test_camera_rays_match(rot):
    pos = np.array([3.0, 2.0, -5.0], np.float32)
    jcam = JC.Camera(pos=pos, rot=np.array(rot, np.float32))
    tcam = TC.camera_from_numpy(jcam)
    assert JC.projection_elements(CFG) == TC.projection_elements(CFG)
    e1, e2 = TC.projection_elements(CFG)
    for row_start, n_rows in ((0, None), (17, 9)):
        jo, jd = JC.camera_rays(jcam, CFG.width, CFG.height, e1, e2, row_start, n_rows)
        to, td = TC.camera_rays(tcam, CFG.width, CFG.height, e1, e2, row_start, n_rows)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


def test_move_and_add_rot_match():
    jcam, tcam = JC.default_camera(), TC.default_camera()
    steps = [(JC.Keys(w=1), TC.Keys(w=1)), (JC.Keys(a=1, space=1), TC.Keys(a=1, space=1)),
             (JC.Keys(s=1, d=1, shift=1), TC.Keys(s=1, d=1, shift=1))]
    for i, (jk, tk) in enumerate(steps):
        jcam = JC.add_rot(JC.move(jcam, jk, 0.05 * (i + 1)), 30.0 * i, -45.0, 2.0)
        tcam = TC.add_rot(TC.move(tcam, tk, 0.05 * (i + 1)), 30.0 * i, -45.0, 2.0)
        np.testing.assert_array_equal(tcam.pos.numpy(), np.asarray(jcam.pos))
        np.testing.assert_array_equal(tcam.rot.numpy(), np.asarray(jcam.rot))
    jcam = JC.add_rot(jcam, 5000.0, 0.0)  # pitch clamps inside +-pi/2
    tcam = TC.add_rot(tcam, 5000.0, 0.0)
    np.testing.assert_array_equal(tcam.rot.numpy(), np.asarray(jcam.rot))


def test_npz_jax_to_port(tmp_path):
    path = str(tmp_path / "j.npz")
    js = JS.random_scene(7, seed=2)
    jcam = JC.Camera(pos=np.array([1.0, 2.0, 3.0], np.float32),
                     rot=np.array([0.1, 0.2, 0.3], np.float32))
    JS.save_scene(path, js, jcam)
    ts, tcam = TS.load_scene(path)
    assert_scene_equal(js, ts)
    np.testing.assert_array_equal(tcam.pos.numpy(), jcam.pos)
    np.testing.assert_array_equal(tcam.rot.numpy(), jcam.rot)


def test_npz_port_to_jax(tmp_path):
    path = str(tmp_path / "t.npz")
    ts = TS.random_scene(7, seed=2)
    TS.save_scene(path, ts, TC.default_camera())
    js, jcam = JS.load_scene(path)
    assert_scene_equal(js, ts)
    np.testing.assert_array_equal(np.asarray(jcam.rot), TC.default_camera().rot.numpy())
    ts2, cam2 = TS.load_scene(str(tmp_path / "t.npz"))
    assert_scene_equal(js, ts2)
    TS.save_scene(str(tmp_path / "nocam.npz"), ts)
    assert TS.load_scene(str(tmp_path / "nocam.npz"))[1] is None
