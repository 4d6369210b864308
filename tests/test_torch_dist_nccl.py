"""The layout of the sharded step and frame by backend (rtwc_tpu_torch.dist),
on the CPU, which has no NCCL.

Under NCCL on a CUDA device the train step is one phase (one CUDA graph,
the all-reduce inside) and the frame gathers inside its graph; under gloo,
and anywhere on the CPU, the step is two phases around an eager
all-reduce and the frame gathers after its graph. These tests hold the
rule (`_collective_in_graph`, with `dist.get_backend` monkeypatched: no
NCCL group is made here) and the arithmetic of the one-phase form: forced
through the rule on gloo ranks, with its collective run eagerly, it is
bit-equal to the split form (losses and every parameter, 2 SGD and 2 Adam
steps, one all-reduce of every leaf and the loss a step), and the frame
gathered inside the frame graph's function equals the single render on
every rank. The CUDA graphs themselves, with NCCL's collectives inside,
run on the card: chip_smoke.py phase 9.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rtwc_tpu_torch.camera as TC
import rtwc_tpu_torch.scene as TS
from rtwc_tpu_torch.benchmarks import scaling
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.dist import make_sharded_train_step
from rtwc_tpu_torch.dist import mesh as M
from rtwc_tpu_torch.dist import multihost
from rtwc_tpu_torch.dist.mesh import _leaves
from rtwc_tpu_torch.render import render_frame_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")
CFG = RenderConfig(width=64, height=32, max_spheres=16, max_planes=4,
                   soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=True)
GROUP = object()  # stands for a process group: get_backend is monkeypatched


@pytest.mark.parametrize("backend,device,one", [
    ("nccl", "cuda", True), ("gloo", "cuda", False), ("nccl", "cpu", False),
    ("gloo", "cpu", False)])
def test_collective_in_graph_only_for_nccl_on_a_card(monkeypatch, backend, device, one):
    """The rule: NCCL on a CUDA device puts the collective inside the graph;
    gloo (through the host) and NCCL on the CPU do not; no group has no
    collective. The frame graph takes the rule's answer (`gathers`)."""
    seen = []
    monkeypatch.setattr(M.dist, "get_backend", lambda group=None: seen.append(group) or backend)
    dev = torch.device(device)
    assert M._collective_in_graph(GROUP, dev) is one
    assert M._collective_in_graph(None, dev) is False
    assert all(g is GROUP for g in seen)
    asked = []
    monkeypatch.setattr(M, "_collective_in_graph",
                        lambda group, device: asked.append((group, device)) or one)
    assert M._FrameGraph(CFG, 2, range(2), torch.device("cpu"), GROUP,
                         graph=False).gathers is one
    assert asked == [(GROUP, torch.device("cpu"))]


@pytest.mark.parametrize("group,one,phases", [(None, False, 1), (GROUP, True, 1),
                                              (GROUP, False, 2)],
                         ids=["no-group", "collective-in-graph", "gloo"])
def test_step_phases_follow_the_rule(monkeypatch, group, one, phases):
    """step.init makes one phase without a group and where the rule puts
    the all-reduce inside the graph, two (the bands, then the update)
    where it does not; it asks the rule with the group and the leaves'
    device."""
    asked = []

    def rule(g, device):
        asked.append((g, device))
        return one

    monkeypatch.setattr(M, "_collective_in_graph", rule)
    step = make_sharded_train_step(CFG, M.Mesh(2, group=group), tau=0.5, backend="pallas")
    state = step.init((TS.default_scene(CFG), TC.default_camera()))
    assert len(state.phases) == phases
    assert asked == ([] if group is None else [(GROUP, torch.device("cpu"))])


def test_frame_graph_cache_keys_on_the_group(monkeypatch):
    """A group-less frame and a group's frame never share a frame graph:
    the cache makes one for each and hands each back again."""
    monkeypatch.setattr(M, "_FrameGraph", lambda *args: args)
    M._frame_graph.cache_clear()
    try:
        dev = torch.device("cpu")
        made = [M._frame_graph(CFG, 2, range(2), dev, g) for g in (None, GROUP, None, GROUP)]
    finally:
        M._frame_graph.cache_clear()
    assert made[0][4] is None and made[1][4] is GROUP
    assert made[0] is made[2] and made[1] is made[3] and made[0] is not made[1]


def _run_ranks(world: int, layout: str, tmp_path) -> list:
    coordinator = f"127.0.0.1:{scaling._free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = [str(tmp_path / f"{layout}{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, coordinator, str(world), str(r), outs[r],
                               "pallas", "1", layout], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
             for r in range(world)]
    try:
        res = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, res):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    return [dict(np.load(o)) for o in outs]


@pytest.mark.parametrize("world", [2, 4])
def test_one_phase_equals_split_on_gloo_ranks(world, tmp_path):
    """world gloo processes, one band each, the shadowed kernel path: the
    one-phase step (forced through the rule, its all-reduce eager) and the
    split step give bit-equal losses and parameters after each of 2 SGD
    and 2 Adam steps on every rank, each step with exactly one all-reduce
    of every leaf's elements and the loss; the frame gathered inside the
    frame graph's function, like the split form's gathered after it,
    equals render_frame_kernel on every rank."""
    one, split = _run_ranks(world, "one", tmp_path), _run_ranks(world, "split", tmp_path)
    scene, cam = TS.default_scene(CFG), TC.default_camera()
    n_flat = sum(v.numel() for v in _leaves((scene, cam)).values()) + 1
    single = render_frame_kernel(scene, cam, CFG)
    for o, s in zip(one, split):
        assert int(o["phases.sgd"]) == int(o["phases.adam"]) == 1
        assert int(s["phases.sgd"]) == int(s["phases.adam"]) == 2
        keys = [k for k in s if k.startswith(("loss.", "param."))]
        assert sorted(keys) == sorted(k for k in o if k.startswith(("loss.", "param.")))
        assert len([k for k in keys if k.startswith("loss.")]) == 4
        for k in keys:
            assert o[k].tobytes() == s[k].tobytes(), k
            assert o[k].tobytes() == one[0][k].tobytes(), k  # ranks agree
        for r in (o, s):
            for k in r:
                if k.startswith("sizes."):
                    assert list(r[k]) == [n_flat], (k, r[k])
            for f in ("rgb", "depth", "normal", "hit"):
                assert np.array_equal(r[f"fb.{f}"], getattr(single, f).numpy()), f
    assert float(one[0]["loss.sgd.1"]) != float(one[0]["loss.sgd.0"])


def test_check_card_a_rank(monkeypatch):
    """NCCL takes one card a rank: more local ranks than cards is refused
    with the message initialize_multihost gives."""
    monkeypatch.setattr(multihost.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(multihost.torch.cuda, "device_count", lambda: 1)
    assert multihost.check_card_a_rank(1) == 1
    with pytest.raises(ValueError, match="nccl needs a card a rank: 2 ranks on this host, 1"):
        multihost.check_card_a_rank(2)


def test_scaling_refuses_nccl_ranks_past_the_cards(monkeypatch, capsys):
    """`--ranks 2 --dist-backend nccl` on one card exits with
    initialize_multihost's message before it starts a rank (no rank's
    traceback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(scaling, "_spawn", lambda *a: pytest.fail("a rank was started"))
    with pytest.raises(SystemExit) as e:
        scaling.main(["--ranks", "2", "--dist-backend", "nccl"])
    assert str(e.value) == ("nccl needs a card a rank: 2 ranks on this host, 1 cards (ranks "
                            "that share a card take backend='gloo')")
    assert capsys.readouterr().out == ""


def test_no_garbage_collection_during_a_capture(monkeypatch):
    """warm_and_capture keeps Python's cyclic collector off while it
    captures (a dead step's graph collected there invalidates the capture,
    as phase 7 of chip_smoke.py once found on the card), and turns it back
    on after the capture, also when the capture raises. The CUDA calls are
    stand-ins: the CPU has none."""
    import contextlib
    import gc

    from rtwc_tpu_torch.render import step_graph as G

    class Stream:
        def wait_stream(self, other):
            pass

    seen = []
    monkeypatch.setattr(G.torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(G.torch.cuda, "Stream", lambda device=None: Stream())
    monkeypatch.setattr(G.torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(G.torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(G.torch.cuda, "graph", lambda g: contextlib.nullcontext())
    assert gc.isenabled()
    out = G.warm_and_capture(lambda: seen.append(("warm", gc.isenabled())) or 1,
                             lambda: seen.append(("capture", gc.isenabled())) or 2, "cuda")
    assert out[0] == 1 and out[2] == 2 and out[3] == {}
    assert seen == [("warm", True), ("capture", False)] and gc.isenabled()

    def fails():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        G.warm_and_capture(lambda: None, fails, "cuda")
    assert gc.isenabled()
