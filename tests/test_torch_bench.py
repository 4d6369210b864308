"""The port's bench (rtwc_tpu_torch/bench.py) run end to end on the CPU at a
small size: its JSON line has bench.py's keys (bench.py:461-502) with the
two renames the port makes, plus the device, and every number is finite."""
import json
import math

import pytest

from rtwc_tpu_torch import bench

# bench.py:461-502, as the JAX bench prints them
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "shadowed", "generic_shadowed",
    "single_dispatch_ms", "single_dispatch_generic_ms", "single_dispatch_breakdown",
    "unshadowed", "fwd_hard_display", "jnp_fwd_bwd", "r4k_200sph_shadowed", "r4k_200sph_nocull",
    "cull_speedup_fwd", "model_gops_per_frame", "vpu_sol_multiple", "sol_pct_nocull_fwd",
    "sol_pct_nocull_bwd", "sol_pct_nocull_fwd_4k", "sol_pct_nocull_bwd_4k",
    "sol_pct_culled_floor", "sol_pct_culled_floor_4k", "empty_scene_fixed_ms",
    "sol_pct_marginal_objects", "culled_floor_ms", "tile_work_profile", "cache_slots",
    "cache_demand_max", "cache_fallback_tiles_pct", "grad_cam_rot_rel", "hbm_util", "bound",
}
JAX_BREAKDOWN = {"tunnel_floor_ms", "fused_amortized_ms", "fused_single_ms",
                 "fused_unexplained_ms", "generic_amortized_ms", "generic_single_ms",
                 "generic_unexplained_ms", "lists_pack_ms"}
PROFILE = {"mean_list_len", "mean_applied", "mean_shadow_list_len", "mean_shadow_applied"}


def _numbers(v):
    if isinstance(v, dict):
        for x in v.values():
            yield from _numbers(x)
    elif isinstance(v, (int, float)) and not isinstance(v, bool):
        yield v


@pytest.fixture
def small_bench(monkeypatch):
    for name, value in dict(DEVICE="cpu", WIDTH=64, HEIGHT=32, WIDTH_4K=96, HEIGHT_4K=64,
                            SPHERES_4K=24, GRAD_WIDTH=64, GRAD_HEIGHT=32, LOOP_K=2).items():
        monkeypatch.setattr(bench, name, value)


def test_bench_json_line_on_the_cpu(small_bench, capsys):
    assert bench.main() == 0
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1
    res = json.loads(lines[0])
    want = (JAX_KEYS - {"jnp_fwd_bwd"}) | {"torch_soft_fwd_bwd", "device"}
    assert set(res) == want
    assert set(res["single_dispatch_breakdown"]) == (JAX_BREAKDOWN - {"tunnel_floor_ms"}) | {
        "dispatch_floor_ms"}
    for key in ("culled_floor_ms", "cache_slots", "cache_demand_max", "cache_fallback_tiles_pct"):
        assert set(res[key]) == {"r1080", "r4k"}, key
    assert set(res["tile_work_profile"]["r1080"]) == PROFILE
    assert res["device"] == {"name": "cpu", "power_limit_w": None}
    # the marginal efficiency is null only where the empty scene is no faster
    nums = list(_numbers({k: v for k, v in res.items() if k != "device"}))
    assert nums and all(math.isfinite(v) for v in nums)
    assert res["sol_pct_marginal_objects"] is None or math.isfinite(res["sol_pct_marginal_objects"])
    assert res["value"] > 0 and res["bound"] in ("compute", "hbm")
    assert "# HEADLINE" in err and "# spread" in err and "# kernel launches" in err
