"""The sharded fit cell (traffic kind `sharded_fit`) on the CPU: four gloo
ranks at a small size through the harness's own path come out `correct`,
each planted fault of sharded_faults.py does not, no rank process
outlives a run, a wait past its limit ends the run; the new readers'
arithmetic; the animated reference against the NumPy physics."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, sharded_faults
from portbench.drivers import sharded_fit
from portbench.readers import band_spread, counter_kib
from portbench.reference import animated, scenes
from portbench.tests import test_portbench_harness as H

CELL = "fit_1080p_s100.sharded4"
SMALL = {"render": {"width": 64, "height": 32, "max_spheres": 6}, "scene": {"n_spheres": 6}}
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The harness's tests shrink every cell by its traffic kind; this kind's size.
H.SMALL.setdefault("sharded_fit", SMALL)


def _small_cell(seed, **traffic):
    config, base = harness.cell_files(CELL)
    return sharded_fit.make(harness.merged(config, SMALL), {**base, **traffic}, seed, "cpu")


def test_the_cells_files():
    config, traffic = harness.cell_files(CELL)
    r = config["render"]
    assert (r["width"], r["height"], r["max_spheres"], r["max_planes"]) == (1920, 1080, 100, 4)
    assert config["scene"] == {"kind": "random", "n_spheres": 100, "n_planes": 1, "spread": 40.0}
    assert config["reduced"] == [] and len(config["source"]) <= 200
    assert traffic["ranks"] == 4 and traffic["dist_backend"] == "nccl"
    assert r["height"] % traffic["ranks"] == 0 and traffic["limits"]["replica_gap"] == 0.0
    spec = harness.cell_spec(harness.benchmark(), CELL)
    assert spec["chips"] == traffic["ranks"]


def test_a_small_run_is_correct_and_leaves_no_rank_behind():
    c = _small_cell(2**31 + 7)
    c.setup()
    procs = list(c.procs)
    assert len(procs) == 3 and all(p.poll() is None for p in procs)
    raw = c.window(seconds=0.3, spans=harness.Spans(False))
    assert raw["units"] % sharded_fit.SYNC_EVERY == 0 and raw["failed"] == 0
    c.release()
    assert all(p.returncode is not None for p in procs)
    compared = c.check()
    assert [n for n, _, _ in compared] == ["loss_gap", "grad_gap", "move_gap", "replica_gap"]
    assert all(v <= lim for _, v, lim in compared), compared
    assert dict((n, v) for n, v, _ in compared)["replica_gap"] == 0.0
    assert c.end_to_end(raw)["train_rays_per_s"] == 64 * 32 * raw["units"] / raw["seconds"]


def test_a_traced_run_reads_the_span_and_the_counter(tmp_path):
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, d), here / d)
    traffic = harness.load_json(harness.HERE, "traffic", f"{CELL}.json")
    (here / "traffic" / f"{CELL}.json").write_text(json.dumps({**traffic, "trace_units": 32}))
    out = harness.run(CELL, 11, 0.3, True, "cpu", here=str(here), overrides=SMALL)
    res = out["result"]
    assert res["correct"], out["compared"]
    # no device trace on the CPU: the program's span and counter alone
    assert set(res["metrics"]) == {"host_step_ms.sharded", "allreduce_kib.sharded"}
    n_leaves = 6 * (3 + 1 + 3 + 1 + 1 + 1) + 4 * (3 + 3 + 3 + 1 + 1 + 1) + 3 + 3
    assert res["metrics"]["allreduce_kib.sharded"]["value"] == 4 * (n_leaves + 1) / 1024


@pytest.mark.parametrize("fault", sharded_faults.FAULTS)
def test_a_planted_fault_is_not_correct(fault):
    undo = sharded_faults.plant(fault)
    try:
        out = harness.run(CELL, 5, 0.3, False, "cpu", overrides=SMALL)
    finally:
        undo()
    assert out["result"]["correct"] is False, out["compared"]


def test_a_wait_past_its_limit_ends_the_process():
    code = ("import time; from portbench.drivers.sharded_fit import Watchdog\n"
            "d = Watchdog(lambda: print('ENDING', flush=True)); d.arm('a test phase', 0.5)\n"
            "time.sleep(30); print('NOT ENDED')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=25)
    assert proc.returncode == 1 and "ENDING" in proc.stdout and "NOT ENDED" not in proc.stdout
    assert "a test phase outlasted its limit" in proc.stderr


def test_band_spread_and_kib_readers():
    ms = 1_000_000
    trace = {"device": [("void soft_sh_mse_kernel<2>(P)", "kernel", 0, 4 * ms),
                        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(A)", "kernel", 5 * ms, ms)],
             "spans": [("window", 0, 10 * ms)]}
    ctx = {"units": 2, "raw": {"band_k6_ms": [2.5, 3.0, 2.0]}}
    assert band_spread.read(trace, ctx, {"include": ["soft_sh_mse*"]}) == pytest.approx(50.0)
    assert band_spread.read(trace, {"units": 2, "raw": {}}, {"include": ["soft_sh_mse*"]}) is None
    assert band_spread.read(trace, {"units": 2, "raw": {"band_k6_ms": [None, 1.0, 1.0]}},
                            {"include": ["soft_sh_mse*"]}) is None
    from portbench.readers import kernel_ms
    assert kernel_ms.read(trace, ctx, {"include": ["nccl*"]}) == 0.5
    # a counter the program does not count reads as nothing, not as zero
    assert counter_kib.read(trace, ctx, {"counter": "no.such.counter"}) is None


def test_the_tick_is_the_numpy_physics_and_carries_gradients():
    s = scenes.random_scene(5, 1, 6, 4, seed=1, spread=12.0)
    s["spheres"]["center"][:, 1] = 0.0              # inside [-10, 10]: the tick moves them freely
    s["spheres"]["center"][0, 1] = 9.995            # but the first, which hits the top
    s["spheres"]["mover"][0] = 1.0
    dt = np.float32(1.0 / 60.0)
    lv = {f"spheres.{k}": torch.from_numpy(v.copy()).requires_grad_(k != "active")
          for k, v in s["spheres"].items()}
    t = animated.tick(lv, dt, -10.0, 10.0)
    ref = scenes.update_scene(scenes.copy(s), dt, -10.0, 10.0)["spheres"]
    assert np.array_equal(t["spheres.center"].detach().numpy(), ref["center"])
    assert np.array_equal(t["spheres.mover"].detach().numpy(), ref["mover"])
    t["spheres.center"][:, 1].sum().backward()
    live = s["spheres"]["active"] > 0.5
    g_speed = lv["spheres.speed"].grad.numpy()
    assert g_speed[0] == 0.0                       # clamped at the top: no gradient
    np.testing.assert_allclose(g_speed[1:][live[1:]], (s["spheres"]["mover"] * dt)[1:][live[1:]])
    assert np.all(g_speed[~live] == 0.0)           # dead slots do not move


H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("ids, count", [("0123", 4), ("0000", 1), ("0112", 3)])
def test_the_result_counts_the_cards_the_ranks_ran_on(ids, count):
    base = {"platform": "gpu", "kind": H100, "count": 1, "memory_peak_bytes": 7}
    cards = [{"id": f"GPU-{i}", "kind": H100, "peak": 100 + r} for r, i in enumerate(ids)]
    info = sharded_fit.cards_info(base, cards)
    assert info == {"platform": "gpu", "kind": H100, "count": count, "memory_peak_bytes": 103}


def test_a_cpu_run_leaves_the_harness_device_reading_alone():
    own = harness.device_info
    c = _small_cell(13)
    c.setup()
    assert harness.device_info is own
    c.window(seconds=0.1, spans=harness.Spans(False))
    assert harness.device_info("cpu")["count"] == 1
    c.release()
    assert harness.device_info is own


def test_the_spec_handed_to_the_ranks_is_json():
    c = _small_cell(3)
    spec = {"config": c.config, "traffic": c.traffic, "seed": c.seed}
    assert json.loads(json.dumps(spec)) == spec
