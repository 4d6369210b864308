"""The harness on the CPU: its files, names and units, a cell added from
files alone, the arithmetic of the metrics on synthetic timestamps and
traces, the refusal without a card, and `correct` coming out false under
the control and under planted faults."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import faults, harness
from portbench.drivers import common
from portbench.readers import idle, interval_p95, kernel_ms, roofline, span_ms, timeline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"fit_step": {"render": {"width": 64, "height": 32}},
         "console_frame": {"render": {"width": 48, "height": 16}}}


def _small(cell):
    return SMALL[harness.cell_files(cell)[1]["kind"]]


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        config, traffic = harness.cell_files(w["name"])
        assert traffic["config"] == w["config"] == config["name"]
        assert os.path.exists(os.path.join(HERE, "drivers", f"{traffic['kind']}.py"))
        assert w["traffic"] == w["name"].split(".", 1)[1]
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for m in BENCH["per_layer"]:
        spec = harness.load_json(HERE, "metrics", f"{m['name']}.json")
        assert os.path.exists(os.path.join(HERE, "readers", f"{spec['reader']}.py"))


def test_names_units_and_keys():
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        cell_e2e = {m["name"] for m in harness.end_to_end_for(BENCH, w["name"])}
        assert "setup_s" in cell_e2e and len(cell_e2e) >= 2
        assert harness.per_layer_for(BENCH, w["name"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_contract_limits():
    """Paths, command, chips and the window fit the benchmark's contract."""
    path = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
    assert 1 <= len(BENCH["paths"]) <= 16 and all(path.match(p) for p in BENCH["paths"])
    assert all(not p.endswith("_torch") and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs, 180 s of compiling a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4} and sum(c == 4 for c in chips) <= max(1, len(chips) // 4)
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/") and len(c["reduced"]) <= 16


def test_the_console_mode_is_the_traffics():
    config, traffic = harness.cell_files("console_hires.bit_pixel")
    assert "mode" not in config["render"] and traffic["render"]["mode"] == "bit_pixel"


def test_a_cell_and_a_metric_from_files_alone(tmp_path):
    """A throwaway cell and a throwaway per-layer metric need files and
    BENCHMARK.json entries only."""
    here = tmp_path / "portbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(HERE, d), here / d)
    bench = json.loads(json.dumps(BENCH))
    cell = "fit_1080p_s20.throwaway"
    bench["workloads"].append({"name": cell, "config": "fit_1080p_s20",
                               "traffic": "throwaway", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fit_1080p_s20.shadowed_mse" in m.get("workloads", []):
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "read_ms.throwaway", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "fit loop and graph replay",
                               "moves": "train_rays_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "metrics" / "read_ms.throwaway.json").write_text(
        json.dumps({"reader": "span_ms", "params": {"span": "read"}}))
    traffic = harness.load_json(HERE, "traffic", "fit_1080p_s20.shadowed_mse.json")
    traffic.update(trace_units=32)
    (here / "traffic" / f"{cell}.json").write_text(json.dumps(traffic))
    kw = dict(root=str(tmp_path), here=str(here), overrides=SMALL["fit_step"])
    res = harness.run(cell, 3, 0.2, False, "cpu", **kw)["result"]
    assert set(res["metrics"]) == {"train_rays_per_s", "setup_s"} and res["correct"]
    assert res["attempted"] % 16 == 0 and list(res)[-1] == "compared"
    res = harness.run(cell, 3, 0.2, True, "cpu", **kw)["result"]
    assert res["attempted"] == 32 and res["correct"]
    # the CPU run has no device trace: only the span readers find something
    assert set(res["metrics"]) == {"host_step_ms.train", "read_ms.throwaway"}


def test_rate_and_tail_on_synthetic_timestamps():
    from portbench.drivers.console_frame import ConsoleCell
    from portbench.drivers.fit_step import FitCell

    fit = object.__new__(FitCell)
    fit.cfg = type("C", (), {"width": 1920, "height": 1080})()
    assert fit.end_to_end({"units": 3200, "seconds": 2.0})["train_rays_per_s"] == \
        1920 * 1080 * 1600
    con = object.__new__(ConsoleCell)
    gaps = [0.005] * 95 + [0.02] * 4 + [0.1]        # 100 intervals
    times = [10.0]
    for g in gaps:
        times.append(times[-1] + g)
    assert con.end_to_end({"units": 101, "seconds": 0.7}) == {"frames_per_s": 101 / 0.7}
    raw = {"times": [9.999] + times}
    # the 95th of 100 intervals, interpolated; the start's interval left out
    assert abs(interval_p95.read({}, {"raw": raw}, {}) - 5.75) < 1e-9
    assert interval_p95.read({}, {"raw": {"times": times[:2]}}, {}) is None


def test_the_fed_loop_counts_every_queued_step_over_the_whole_wait():
    """On a fake clock: each step costs 1 ms of host time, the close's wait
    5 s. Every queued step counts, over the time up to the wait's end; a
    batch whose late-read loss is not finite counts as failed."""
    from portbench.drivers.fit_step import fed_loop

    now = [100.0]
    calls = [0]

    def step():
        calls[0] += 1
        now[0] += 1e-3
        return torch.tensor(float("nan") if calls[0] == 8 else 1.0)

    def wait():
        now[0] += 5.0

    raw = fed_loop(step, 4, 16, "cpu", seconds=0.05, clock=lambda: now[0], wait=wait)
    assert raw["units"] == calls[0] == 52          # 13 batches: the 13th passes 50 ms
    assert abs(raw["seconds"] - (0.052 + 5.0)) < 1e-9
    assert raw["failed"] == 4
    raw = fed_loop(step, 4, 0, "cpu", units=12, clock=lambda: now[0], wait=wait)
    assert raw["units"] == 12 and raw["failed"] == 0


def _trace():
    ms = 1_000_000
    dev = [("void soft_sh_mse_kernel<2>(SoftParams, float const*)", "kernel", 10 * ms, 3 * ms),
           ("tile_lists_kernel(ListParams, float const*)", "kernel", 14 * ms, 1 * ms),
           ("void at::native::elementwise_kernel<128, 2>(int)", "kernel", 14 * ms + ms // 2, ms),
           ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 30 * ms, 2 * ms),
           ("void soft_sh_mse_kernel<2>(SoftParams, float const*)", "kernel", 50 * ms, 5 * ms),
           ("outside", "kernel", 200 * ms, ms)]
    spans = [("window", 0, 100 * ms), ("step", 0, 40 * ms), ("step", 45 * ms, 60 * ms),
             ("read", 60 * ms, 100 * ms), ("inner", 50 * ms, 52 * ms)]
    return {"device": dev, "spans": spans}


def test_idle_share_and_readers_on_a_synthetic_trace():
    tr = _trace()
    busy, window = timeline.busy_and_window(tr)
    assert window == 0.1 and abs(busy - 0.0115) < 1e-12     # 10-13, 14-15.5, 30-32, 50-55 ms
    assert abs(idle.read(tr, {}, {}) - 88.5) < 1e-9
    ctx = {"units": 2, "work": {"k6": (0.0, 67e12 * 2e-3)}}  # a 2 ms bound a unit
    assert kernel_ms.read(tr, ctx, {"include": ["soft_sh_mse_kernel"]}) == 4.0
    assert kernel_ms.read(tr, ctx, {"exclude": ["soft_sh_mse_kernel", "tile_lists_kernel"]}) \
        == 0.5
    assert kernel_ms.read(tr, ctx, {"include": ["nothing_here"]}) is None
    assert span_ms.read(tr, ctx, {"span": "step", "minus": ["inner"]}) == (55 - 2) / 2
    assert span_ms.read(tr, ctx, {"span": "absent"}) is None
    # 2 ms of work a unit over 4 ms of the kernel's device time a unit
    assert abs(roofline.read(tr, ctx, {"include": ["soft_sh_mse*"], "work": "k6"}) - 50.0) \
        < 1e-9
    assert roofline.read(tr, ctx, {"include": ["soft_sh_mse*"], "work": "none"}) is None
    b = timeline.breakdown(tr)
    assert b["device_ops"][0][0] == "soft_sh_mse_kernel"
    assert abs(b["device_ops"][0][1] - 0.008) < 1e-12
    assert [g[0] for g in b["idle_gaps"][:3]] == ["read", "outside spans", "step"]
    assert [round(g[1], 9) for g in b["idle_gaps"][:3]] == [0.045, 0.018, 0.0145]


def _cli(cwd):
    env = {**os.environ, "PYTHONPATH": ""}
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _cli(ROOT)
    assert proc.returncode != 0 and "{" not in proc.stdout


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _cli(tmp_path)
    assert proc.returncode != 0 and "{" not in proc.stdout


@pytest.mark.parametrize("cell,fault", [
    ("fit_1080p_s20.shadowed_mse", "state_unchanged"),
    ("fit_1080p_s20.shadowed_mse", "half_batch_fused"),
    ("fit_1080p_s20.shadowed_mse", "answer_altered_fused"),
    ("fit_1080p_s20.unshadowed_sil", "state_unchanged"),
    ("fit_1080p_s20.unshadowed_sil", "half_batch_frame"),
    ("fit_1080p_s20.unshadowed_sil", "answer_altered_frame"),
    ("console_hires.bit_pixel", "frame_unchanged"),
    ("console_hires.bit_pixel", "half_frame"),
    ("console_hires.bit_pixel", "bytes_altered"),
])
def test_a_planted_fault_is_not_correct(cell, fault):
    """The run's own path (set-up, window, check), the harness's look for
    a card skipped, with the timed path broken underneath."""
    undo = faults.plant(fault)
    try:
        out = harness.run(cell, 5, 0.5, False, "cpu", overrides=_small(cell))
    finally:
        undo()
    assert out["result"]["correct"] is False, out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fit_1080p_s20.shadowed_mse", "fit_1080p_s20.unshadowed_sil"])
def test_a_replay_only_fault_is_not_correct_on_the_card(card, cell):
    """A fault that only a replay of the captured graph has: the run's own
    path at the cell's size, with the graph's backward left out."""
    undo = faults.plant("replay_skips_backward")
    try:
        out = harness.run(cell, 5, 0.5, False, "cuda")
    finally:
        undo()
    assert out["result"]["correct"] is False, out["compared"]


@pytest.mark.parametrize("cell", ["fit_1080p_s20.shadowed_mse", "fit_1080p_s20.unshadowed_sil"])
def test_the_compared_steps_start_again_from_the_start(cell):
    """Set-up's first call (on a card an eager step, then the capture) is
    undone before the compared steps: on the CPU, where every call is
    eager, the first compared step repeats the first call exactly, and
    the optimiser holds one step's first gradient, not two steps'."""
    from portbench.drivers import fit_step

    config, traffic = harness.cell_files(cell)
    c = fit_step.make(harness.merged(config, SMALL["fit_step"]), traffic, 3, "cpu")
    calls, build = [], c._build

    def spy():
        build()
        inner = c.step

        def step():
            loss = inner()
            calls.append(float(loss))
            return loss
        c.step = step
    c._build = spy
    c.setup()
    assert calls[1] == calls[0] == c.readings["loss"][0] and calls[2] != calls[0]
    ref = c.reference_at(c.readings["points"])
    assert common.norm_gaps(c.readings["grads"][0], ref["grads"][0],
                            common.kept_leaves(ref["grads"][0])) < 1e-3


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_sound_program_is_correct_and_the_control_is_not(cell):
    from portbench import control

    out = control.readings(cell, [9], [9], 0.3, "cpu", _small(cell))
    _, traffic = harness.cell_files(cell)
    lim = traffic["limits"]
    assert all(out["program"][0][k] <= lim[k] for k in lim)
    assert any(out["control"][0][k] > lim[k] for k in lim)


def test_a_run_loads_nothing_of_jax():
    """A run's process, set-up, window and check included, loads no module
    whose top-level name is jax, jaxlib, flax or rtwc_tpu (compared whole)."""
    code = ("import sys, json; from portbench import harness; "
            "harness.run('fit_1080p_s20.unshadowed_sil', 3, 0.2, False, 'cpu', guard=True, "
            "overrides=json.loads(sys.argv[1])); harness.assert_no_forbidden('after'); "
            "print(json.dumps(harness.forbidden_modules()), "
            "'rtwc_tpu_torch' in sys.modules)")
    env = {**os.environ, "PYTHONPATH": ""}
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(SMALL["fit_step"])],
                          cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["[]", "True"]


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    for w in BENCH["workloads"]:
        res = harness.run(w["name"], 21, 1.0, False, "cuda")["result"]
        assert res["correct"] and res["device"]["platform"] == "gpu", res["compared"]
        assert all(m["value"] > 0 for m in res["metrics"].values())
