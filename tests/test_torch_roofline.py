"""The port's roofline model (rtwc_tpu_torch/utils/roofline.py): the cases of
tests/test_roofline.py for `count_ops` and the port's models, and the
component costs of the list-aware floor held to rtwc_tpu.utils.roofline's.

The op accounting must be exact on known expressions (pytest.approx's
default 1e-6 relative), and the models structurally sane. Against JAX, both
counters are given unit weights, so that what is compared is the count of
operations each model charges: the forward components agree within a factor
1.5 and the adjoint replays within a factor 2 (the port's adjoints are
written by hand, JAX's come from jax.vjp)."""
import jax.numpy as jnp
import pytest
import torch

from rtwc_tpu.config import RenderConfig as JaxConfig
from rtwc_tpu.utils import roofline as JR
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import soft_objects as O
from rtwc_tpu_torch.utils import roofline as R

SOFT = dict(soft_miss_penalty=300.0, soft_mask_k=10.0)
FWD_FACTOR, VJP_FACTOR = 1.5, 2.0


def _x(v=3.0):
    return torch.tensor(v, dtype=torch.float32)


def test_count_known_expressions():
    w = R._WEIGHTS
    # x * a + b: one mul and one add at their measured costs
    assert R.count_ops(lambda x: x * 2.0 + 1.0, _x()) == pytest.approx(w["mul"] + w["add"])
    assert R.count_ops(torch.exp, _x(1.0)) == pytest.approx(w["exp"])
    # the kernels' correctly rounded 1 / sqrtf is one measured body
    assert R.count_ops(O.rsqrt, _x(1.0)) == pytest.approx(w["rsqrt"])
    # shape ops are free
    assert R.count_ops(lambda x: x.reshape(4, 1), torch.ones(2, 2)) == 0.0


def test_count_scales_with_elements():
    assert R.count_ops(lambda x: x * 2.0, torch.ones(8, 128)) == pytest.approx(
        R._WEIGHTS["mul"] * 8 * 128)


def test_count_sees_through_helpers():
    """The counterpart of JAX's jit recursion: ops inside the plain helpers
    count; constants they build with _t (soft_objects.py:94) are free; a
    softplus is priced as the kernels' sequence."""
    c = O.SoftConsts.make(RenderConfig(width=64, height=32, **SOFT), 0.5)
    w = R._WEIGHTS
    softplus = sum(w[p] for p in R._COMPOSITE["logaddexp"])
    assert R.count_ops(lambda x: O.pen(c, x), _x(0.2)) == pytest.approx(
        w["mul"] + softplus + w["div"])


def test_count_cse_dedupes_repeats():
    # (x * 2 + 1) twice is one mul and one add, then the add of the two
    w = R._WEIGHTS
    assert R.count_ops(lambda x: (x * 2.0 + 1.0) + (x * 2.0 + 1.0), _x()) == pytest.approx(
        w["mul"] + 2 * w["add"])


def test_integer_pow_counts_its_multiplies():
    # pow_int multiplies step by step: x**32 is 5 squarings, x**7 two
    # squarings and two products
    assert R.count_ops(lambda x: O.pow_int(x, 32), _x(2.0)) == pytest.approx(5 * R._WEIGHTS["mul"])
    assert R.count_ops(lambda x: O.pow_int(x, 7), _x(2.0)) == pytest.approx(4 * R._WEIGHTS["mul"])


def test_reduce_counts_input_elements():
    assert R.count_ops(torch.amax, torch.ones(4, 8)) == pytest.approx(32.0 * R._CHEAP)


@pytest.mark.parametrize("shadows", [False, True])
def test_soft_step_model_structure(shadows):
    cfg = RenderConfig(width=256, height=64, max_spheres=8, max_planes=2, shadows=shadows, **SOFT)
    m = R.soft_step_model(cfg, 0.5, 8, 2)
    assert m["fwd_ops_per_ray"] > 0 and m["bwd_ops_per_ray"] > m["fwd_ops_per_ray"]
    assert m["ops_per_frame"] > m["fwd_ops_per_frame"] > 0
    assert m["t_compute_bound_s"] > 0 and m["t_hbm_bound_s"] > 0
    u = R.utilization(m, measured_s=1.0)
    assert set(u) == {"vpu_util", "hbm_util", "bound"}
    assert u["bound"] in ("compute", "hbm")


def test_shadowed_model_costs_more():
    cfg = RenderConfig(width=256, height=64, max_spheres=8, max_planes=2, **SOFT)
    m_no = R.soft_step_model(cfg, 0.5, 8, 2)
    m_sh = R.soft_step_model(cfg.replace(shadows=True), 0.5, 8, 2)
    assert m_sh["fwd_ops_per_ray"] > m_no["fwd_ops_per_ray"]
    assert m_sh["bwd_ops_per_ray"] > m_no["bwd_ops_per_ray"]
    # the shadowed stack saves 14 planes against 10
    assert m_sh["hbm_bytes_per_frame"] == pytest.approx(m_no["hbm_bytes_per_frame"] * 14 / 10)


def test_model_scales_with_objects():
    cfg = RenderConfig(width=256, height=64, max_spheres=64, max_planes=2, **SOFT)
    small = R.soft_step_model(cfg, 0.5, 8, 2)
    big = R.soft_step_model(cfg, 0.5, 64, 2)
    assert 4.0 < big["fwd_ops_per_ray"] / small["fwd_ops_per_ray"] < 9.0  # raygen amortises


@pytest.fixture
def unit_weights(monkeypatch):
    monkeypatch.setattr(JR, "_WEIGHTS", {k: 1.0 for k in JR._WEIGHTS})
    monkeypatch.setattr(JR, "_CHEAP", 1.0)
    monkeypatch.setattr(R, "_WEIGHTS", {k: 1.0 for k in R._WEIGHTS})
    monkeypatch.setattr(R, "_CHEAP", 1.0)
    for fn in (JR.culled_component_costs, R.culled_component_costs):
        fn.cache_clear()
    yield
    for fn in (JR.culled_component_costs, R.culled_component_costs):
        fn.cache_clear()


def _jax_sh_trans_distinct(cfg, tau):
    """JAX's sh_trans with four distinct factors. JAX's own component passes
    one constant four times, and its CSE folds the four factors into one;
    the kernels' factors differ."""
    from rtwc_tpu.render.pallas_soft import _make_object_fns

    fns = _make_object_fns(cfg, tau)

    def f(vis, *args):
        v = vis * fns.shadow_transmittance(args)
        return v, jnp.maximum(v, jnp.float32(1e-6))

    return JR.count_vpu_ops(f, *(jnp.float32(v) for v in (0.7, 0.5, 0.6, 0.7, 0.8)))


def test_component_costs_agree_with_jax(unit_weights):
    kw = dict(width=256, height=64, max_spheres=8, max_planes=2, shadows=True, **SOFT)
    ref = JR.culled_component_costs(JaxConfig(**kw), 0.5)
    got = R.culled_component_costs(RenderConfig(**kw), 0.5)
    ref = {**ref, "sh_trans": _jax_sh_trans_distinct(JaxConfig(**kw), 0.5)}
    for key in ("lb_s", "heavy_s", "lightray", "sh_preA_s", "sh_preB_s", "sh_trans"):
        assert 1.0 / FWD_FACTOR <= got[key] / ref[key] <= FWD_FACTOR, (key, got[key], ref[key])
    for key in ("vjp_sh_s", "vjp_main_s", "raygen_vjp"):
        assert 1.0 / VJP_FACTOR <= got[key] / ref[key] <= VJP_FACTOR, (key, got[key], ref[key])


def test_culled_step_model_prices_the_work_profile():
    """A tile with no listed objects costs the per-ray constants alone; each
    listed and applied object adds its components."""
    import numpy as np

    cfg = RenderConfig(width=32, height=16, max_spheres=4, max_planes=1, shadows=True, **SOFT)
    zero = np.zeros(2)
    diag = dict(list_len=zero, main_applied=zero, shadow_list_len=zero, shadow_applied=zero,
                bh=16, bw=16, n_planes=0)
    empty = R.culled_step_model(cfg, 0.5, diag, fused=True)
    assert empty["t_floor_s"] == pytest.approx(empty["t_fixed_s"])
    one = R.culled_step_model(cfg, 0.5, {**diag, "list_len": np.ones(2),
                                         "main_applied": np.ones(2)}, fused=True)
    cc = one["components"]
    per_tile = cc["lb_s"] + cc["heavy_s"] + cc["corr_slot"] + cc["vjp_main_s"]
    assert one["ops_per_frame"] - empty["ops_per_frame"] == pytest.approx(
        2 * 256 * per_tile, rel=1e-3)  # components are rounded to 0.1
    assert one["t_fwd_floor_s"] + one["t_bwd_floor_s"] < one["t_floor_s"]


def test_culled_step_model_takes_a_run_calibration():
    """A calibration passed in prices the floor in place of the pinned
    constants: the pinned values give the pinned floor, twice the FMA rate
    halves it, and doubled slot weights double every component (each
    rounded to 0.1)."""
    import numpy as np

    cfg = RenderConfig(width=32, height=16, max_spheres=4, max_planes=1, shadows=True, **SOFT)
    one = np.ones(2)
    diag = dict(list_len=one, main_applied=one, shadow_list_len=one, shadow_applied=one,
                bh=16, bw=16, n_planes=1)
    pinned = R.culled_step_model(cfg, 0.5, diag)
    cal = {"fma_ops_per_s": R.FMA_PER_S, "slots": dict(R.SLOTS)}
    assert R.culled_step_model(cfg, 0.5, diag, calibration=cal)["t_floor_s"] == pytest.approx(
        pinned["t_floor_s"])
    fast = R.culled_step_model(cfg, 0.5, diag, calibration={**cal, "fma_ops_per_s": 2 * R.FMA_PER_S})
    assert fast["t_floor_s"] == pytest.approx(pinned["t_floor_s"] / 2)
    heavy = R.culled_step_model(
        cfg, 0.5, diag, calibration={**cal, "slots": {k: 2 * v for k, v in R.SLOTS.items()}})
    for k, v in pinned["components"].items():
        assert heavy["components"][k] == pytest.approx(2 * v, abs=0.2), k
