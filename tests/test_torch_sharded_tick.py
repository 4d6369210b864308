"""The animated sharded train step (BASELINE config 4's step) against the
benchmark's plain reference (portbench/reference/animated.py: the physics
tick in plain torch, the whole frame's loss and gradients through it), in
one process on four bands and on four gloo ranks; the bounded join of
rtwc_tpu_torch.dist.initialize_multihost; the sharded step's spans and
counters.

Tolerances, and why:
- the loss: 1e-6 relative (float32 sums of 6144 terms in another order;
  the kernels' plain versions and the reference read 1.6e-7 apart);
- the gradients: each leaf within 1e-5 of its largest reference magnitude,
  plus the SGD read-out's rounding: the step takes SGD at lr 2^16 and the
  gradient is (old - new) / lr, which rounds to the leaf's float32 ulp over
  lr (tests/test_torch_dist.py's method); the plain kernels and the
  reference read at most 8.6e-6 of a leaf's norm apart, all of it that
  rounding;
- the tick against the port's update_scene and the NumPy one: equal (the
  same float32 operations in the same order);
- ranks against each other: equal, bit for bit (one all-reduce, the same
  update on every rank).
"""
import dataclasses
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench.reference import animated, scenes
from portbench.reference.config import Render
from rtwc_tpu_torch.dist import initialize_multihost, make_mesh, make_sharded_train_step
from rtwc_tpu_torch.dist import multihost
from rtwc_tpu_torch.dist.mesh import _leaves
from rtwc_tpu_torch.scene import update_scene
from rtwc_tpu_torch.utils import telemetry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_dist_worker import DT, LR, tick_case  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ref_config(cfg) -> Render:
    d = dataclasses.asdict(cfg)
    d["mode"] = getattr(d["mode"], "value", d["mode"])
    return Render.from_dict(d)


def _ref_leaves(scene, cam) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in _leaves((scene, cam)).items()}


def _reference(cfg, scene, cam, target):
    lv = _ref_leaves(scene, cam)
    loss, grads = animated.loss_and_grads(lv, list(lv), _ref_config(cfg), 0.5, True, target,
                                          np.float32(DT))
    return loss, {k: (np.zeros(lv[k].shape, np.float32) if g is None else g.numpy())
                  for k, g in grads.items()}, {k: v.detach().numpy() for k, v in lv.items()}


def _assert_matches_reference(loss, grads, cfg, scene, cam, target):
    ref_loss, ref, start = _reference(cfg, scene, cam, target)
    assert abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss), (loss, ref_loss)
    live = 0
    for k, g in ref.items():
        ulp = np.spacing(np.float32(np.abs(start[k]).max(initial=1.0)))
        tol = GRAD_RTOL * np.abs(g).max(initial=0.0) + ulp / LR
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=tol, err_msg=k)
        live += bool(np.abs(g).max(initial=0.0) > 10 * ulp / LR)
    assert live >= 8      # the centres, radii, speeds, directions, planes and camera move


def test_tick_equals_the_ports_and_the_numpy_physics():
    """Spheres that cross both bounds, one dead slot: the reference's torch
    tick equals the port's update_scene and the NumPy update_scene."""
    s = scenes.random_scene(6, 1, 8, 4, seed=3, spread=12.0)
    sp = s["spheres"]
    sp["center"][:3, 1] = [9.99, -9.99, 0.0]
    sp["mover"][:3] = [1.0, -1.0, 1.0]
    sp["speed"][:3] = [3.0, 2.0, 1.5]
    dt = np.float32(0.25)
    from rtwc_tpu_torch.scene import Planes, Scene, Spheres

    port = Scene(spheres=Spheres(**{k: torch.from_numpy(v.copy()) for k, v in sp.items()}),
                 planes=Planes(**{k: torch.from_numpy(v.copy())
                                  for k, v in s["planes"].items()}))
    ticked_port = update_scene(port, float(dt), -10.0, 10.0).spheres
    lv = {f"spheres.{k}": torch.from_numpy(v.copy()) for k, v in sp.items()}
    ticked_ref = animated.tick(lv, dt, -10.0, 10.0)
    ticked_np = scenes.update_scene(scenes.copy(s), dt, -10.0, 10.0)["spheres"]
    for f in ("center", "mover"):
        assert torch.equal(ticked_ref[f"spheres.{f}"], getattr(ticked_port, f)), f
        assert np.array_equal(ticked_ref[f"spheres.{f}"].numpy(), ticked_np[f]), f
    assert ticked_np["mover"][0] == -1.0 and ticked_np["center"][0, 1] == 10.0


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_four_band_step_matches_the_reference(backend):
    """One process, a mesh of four bands of 8 rows: the animated shadowed
    step's loss and gradients against the reference's whole frame through
    the tick."""
    cfg, scene, cam, target = tick_case()
    step = make_sharded_train_step(
        cfg, make_mesh(4), tau=0.5, backend=backend, animate=True,
        optimizer=lambda leaves: torch.optim.SGD(list(leaves.values()), lr=LR))
    params = (scene, cam)
    new, _, loss = step(params, step.init(params), target, DT)
    old_l, new_l = _leaves(params), _leaves(new)
    grads = {k: ((old_l[k] - new_l[k]) / LR).numpy() for k in old_l}
    _assert_matches_reference(float(loss), grads, cfg, scene, cam, target)


def test_four_gloo_ranks_match_the_reference_and_count_their_all_reduce(tmp_path):
    """Four processes, one band each, over gloo: every rank's loss and
    parameters are bit-equal, and match the reference; each rank's step
    opened the spans dist.step and dist.allreduce (gloo's eager
    all-reduce) and counted one all-reduce of the flat buffer's bytes."""
    world = 4
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, coordinator, str(world), str(r), outs[r],
                               "pallas", "1", "tick"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
             for r in range(world)]
    try:
        res = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, res):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    ranks = [dict(np.load(o)) for o in outs]
    cfg, scene, cam, target = tick_case()
    assert np.array_equal(ranks[0]["target"], target.numpy())
    n_leaves = sum(v.numel() for v in _leaves((scene, cam)).values())
    for r in ranks:
        assert r["loss"].tobytes() == ranks[0]["loss"].tobytes()
        for k in r:
            if k.startswith("param."):
                assert np.array_equal(r[k], ranks[0][k]), k
        assert {"dist.step", "dist.allreduce"} <= set(r["spans"].tolist())
        assert int(r["count.dist.allreduces"]) == 1
        assert int(r["count.dist.allreduce_bytes"]) == 4 * (n_leaves + 1)
    grads = {k[5:]: v for k, v in ranks[0].items() if k.startswith("grad.")}
    _assert_matches_reference(float(ranks[0]["loss"]), grads, cfg, scene, cam, target)


def test_one_process_step_opens_its_span_and_counts_no_all_reduce():
    """Without a process group the step still opens dist.step under a
    profiler, and counts no all-reduce; with no profiler it opens none."""
    cfg, scene, cam, target = tick_case()
    step = make_sharded_train_step(cfg, make_mesh(2), tau=0.5, backend="jnp", animate=True)
    params = (scene, cam)
    state = step.init(params)
    before, n_spans = telemetry.counters(), len(telemetry.recorded()["spans"])
    params, state, _ = step(params, state, target, DT)
    assert len(telemetry.recorded()["spans"]) == n_spans
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(params, state, target, DT)
    names = [n for n, _, _ in telemetry.recorded()["spans"][n_spans:]]
    assert names.count("dist.step") == 1 and "dist.allreduce" not in names
    after = telemetry.counters()
    assert after.get("dist.allreduces", 0) == before.get("dist.allreduces", 0)


@pytest.mark.parametrize("rank", [0, 1])
def test_a_missing_rank_fails_the_join_within_its_timeout(rank):
    """A group of two that only this rank joins: initialize_multihost
    raises after its timeout, whether this rank hosts the store (rank 0)
    or waits for it (rank 1), and leaves no group behind."""
    code = ("import sys, time; from rtwc_tpu_torch.dist import initialize_multihost\n"
            "t = time.monotonic()\n"
            "try:\n"
            "    initialize_multihost(sys.argv[1], 2, int(sys.argv[2]), 'gloo', timeout=3)\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__, round(time.monotonic() - t, 3))\n"
            "import torch.distributed as d; print('GROUP', d.is_initialized())\n")
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", code, f"127.0.0.1:{_free_port()}", str(rank)],
                          capture_output=True, text=True, timeout=90, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if " " in line)
    assert "RAISED" in lines, proc.stdout + proc.stderr
    waited = float(lines["RAISED"].split()[-1])
    assert 2.5 <= waited <= 30.0, waited
    assert lines["GROUP"] == "False"
    assert time.monotonic() - t0 < 90


def test_the_join_without_a_timeout_keeps_torchs_default(monkeypatch):
    """timeout=None passes nothing more to init_process_group; a timeout
    passes a timedelta of it."""
    calls = []
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *a, **kw: calls.append(kw))
    monkeypatch.setattr(multihost.dist, "get_rank", lambda: 0)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(multihost.dist, "get_backend", lambda: "gloo")
    assert initialize_multihost("127.0.0.1:1", 1, 0, "gloo")
    assert initialize_multihost("127.0.0.1:1", 1, 0, "gloo", timeout=7.5)
    assert set(calls[0]) == {"init_method", "world_size", "rank"}
    assert calls[1]["timeout"].total_seconds() == 7.5


def test_the_scaling_rank_frees_its_graphs_before_it_leaves_the_group():
    """A rank of the scaling entry point leaves its group (shutdown_multihost)
    only once no CapturedCall of its step is alive: under NCCL a live graph
    that captured the all-reduce can hold the group's shutdown, and the
    step's calls sit in reference cycles until a collection."""
    code = ("import gc, sys, torch.distributed as d\n"
            "from rtwc_tpu_torch.benchmarks import scaling\n"
            "from rtwc_tpu_torch.render.step_graph import CapturedCall\n"
            "leave = d.destroy_process_group\n"
            "def counted(*a, **k):\n"
            "    live = sum(isinstance(o, CapturedCall) for o in gc.get_objects())\n"
            "    print('LIVE', live, flush=True)\n"
            "    leave(*a, **k)\n"
            "d.destroy_process_group = counted\n"
            "sys.exit(scaling.main(sys.argv[1:]))\n")
    args = ["--rank", "0", "--world", "1", "--coordinator", f"127.0.0.1:{_free_port()}",
            "--device", "cpu", "--width", "64", "--height", "32", "--spheres", "4",
            "--iters", "1", "--dist-backend", "gloo"]
    proc = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert [ln for ln in proc.stdout.splitlines() if ln.startswith("LIVE")] == ["LIVE 0"]
