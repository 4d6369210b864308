"""Step times of the row-band sharded train step (dist/mesh.py) with and
without a process group, for one checkout.

    python rtwc_tpu_torch/utils/dist_times.py [--root DIR] [--iters N]

DIR is the root of the checkout whose `rtwc_tpu_torch` is timed (default:
the checkout that holds this file), for example an older commit unpacked
by `git archive` into the git-ignored `chip_work/`. Run it for each
checkout in turns, in one call, to compare two commits on one card.

The step is the scaling entry point's at its defaults: 1920x1080,
`random_scene(100)`, shadows, animated, fused K6, Adam on every leaf, a
zero target. In this process, on cuda:0: the step on 1 and 2 bands with no
process group and on a one-rank NCCL group over a TCP store (make_mesh(1)
and make_mesh(2)), each replayed as the checkout's step runs it, and the
replayed sharded frame (1920x1080, `random_scene(20)`, shadows) on 2 and
4 bands with no group and on 2 bands of the NCCL group: host ms a step or
frame (`chip_smoke._step_ms`, N calls, three runs in turns); for the
steps also their CUDA graphs a step, a digest of the parameters after 3
(N + 2) steps (to compare the forms and the checkouts bit for bit), and a
profile of N replayed steps of each (`chip_smoke._profile_steps`: device
records and ms a step, and from the host a step: graph launches, kernel
launches and collective calls). Then the checkout's scaling entry point in subprocesses: one
spawned NCCL rank (`--ranks 1 --dist-backend nccl`), one NCCL rank under
`torch.distributed.run`, and `--ranks 2` (1 process, then 2 gloo processes
sharing the card). Needs one CUDA card (exit 2 without one); prints the
card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))


def _in_process(dev, iters: int, step_ms, profile_steps) -> dict:
    import torch
    import torch.distributed as dist

    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.dist import (initialize_multihost, make_mesh, make_sharded_train_step,
                                     render_frame_sharded)
    from rtwc_tpu_torch.dist import mesh as M
    from rtwc_tpu_torch.scene import random_scene

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not initialize_multihost(f"127.0.0.1:{port}", 1, 0, "nccl"):
        raise RuntimeError("initialize_multihost declined")
    cfg = RenderConfig(width=1920, height=1080, max_spheres=100, max_planes=4,
                       soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=True)
    scene = random_scene(100, max_spheres=100, max_planes=4, seed=0, device=dev)
    cam = default_camera().to(dev)
    target = torch.zeros((cfg.height, cfg.width, 3), device=dev)
    tick = 1.0 / 60.0
    runs = {}
    for bands in (1, 2):
        for which, mesh in (("none", M.Mesh(bands)), ("nccl", make_mesh(bands))):
            step = make_sharded_train_step(cfg, mesh, tau=0.5, backend="pallas", animate=True)
            box = [(scene, cam), None]
            box[1] = step.init(box[0])

            def one(box=box, step=step):
                box[0], box[1], _ = step(box[0], box[1], target, tick)
            runs[f"{which} {bands}"] = (one, box)
    frame_cfg = RenderConfig(width=1920, height=1080, shadows=True)
    frame_scene = random_scene(20, seed=0, device=dev)
    frames = {}
    frame_cam = default_camera()
    for which, mesh in (("none 2", M.Mesh(2)), ("nccl 2", make_mesh(2)), ("none 4", M.Mesh(4))):
        frames[f"frame {which}"] = lambda mesh=mesh: render_frame_sharded(
            frame_scene, frame_cam, frame_cfg, mesh, backend="pallas")
    ms = {k: [] for k in list(runs) + list(frames)}
    for turn in range(3):  # each form in turn, the order reversed every other turn
        for key in (list(ms) if turn % 2 == 0 else list(ms)[::-1]):
            ms[key].append(step_ms(runs[key][0] if key in runs else frames[key], iters))
    out = {k: {"ms_per_frame": ms[k]} for k in frames}
    for key, (one, box) in runs.items():
        state = box[1]
        digest = hashlib.sha256()
        for v in state.leaves.values():
            digest.update(v.detach().cpu().numpy().tobytes())
        dev_ms, host = profile_steps(one, f"dist_times_{key.replace(' ', '_')}",
                                     f"sharded step, {key}", "", reps=iters, phase="dist")
        calls = {k: v for k, v in host.items()
                 if any(w in k.lower() for w in ("allreduce", "all_reduce", "nccl"))}
        out[key] = {"ms_per_step": ms[key], "phases": len(state.phases),
                    "params_sha256": digest.hexdigest()[:16],
                    "device_ms_per_step": sum(dev_ms.values()) / 1e3,
                    "nccl_device_records": {k: v for k, v in dev_ms.items()
                                            if "nccl" in k.lower()},
                    "graph_launches": host.get("cudaGraphLaunch", 0.0),
                    "kernel_launches": host.get("cudaLaunchKernel", 0.0),
                    "collective_calls": calls}
    runs.clear()
    frames.clear()
    M._frame_graph.cache_clear()  # no graph of the group outlives it
    gc.collect()
    torch.cuda.synchronize()
    dist.destroy_process_group()
    return out


def _scaling(root: str, iters: int) -> dict:
    """The checkout's scaling entry point in subprocesses: {label: (exit
    code, its rows or its stderr's end)}."""
    cmds = {"nccl spawned": ["-m", "rtwc_tpu_torch.benchmarks.scaling", "--ranks", "1",
                             "--dist-backend", "nccl"],
            "nccl torchrun": ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
                              "1", "-m", "rtwc_tpu_torch.benchmarks.scaling",
                              "--dist-backend", "nccl"],
            "gloo --ranks 2": ["-m", "rtwc_tpu_torch.benchmarks.scaling", "--ranks", "2"]}
    out = {}
    for label, argv in cmds.items():
        p = subprocess.run([sys.executable] + argv + ["--iters", str(iters)], cwd=root,
                           capture_output=True, text=True, timeout=600,
                           env=dict(os.environ, PYTHONPATH=root))
        if p.returncode != 0:
            out[label] = {"exit": p.returncode, "stderr": p.stderr[-1500:]}
            continue
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        out[label] = {"exit": 0, "rows": [
            {k: r.get(k) for k in ("mesh", "ms_per_step", "graph", "phases", "losses_bit_equal",
                                   "params_bit_equal", "simulated")}
            for r in rec["results"]]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]  # run by path
    sys.path.insert(0, CHECKOUT)
    from chip_smoke import OUT_DIR, _card_line, _profile_steps, _step_ms  # nothing of the port
    import torch

    if not torch.cuda.is_available():
        print("dist_times: no CUDA device; the step times need a card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rtwc_tpu_torch.dist import mesh as M

    if os.path.commonpath([os.path.abspath(M.__file__), root]) != root:
        raise RuntimeError(f"imported {M.__file__}, not the checkout at {root}")
    card = _card_line()
    print(card)
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    steps = _in_process(torch.device("cuda", 0), args.iters, _step_ms, _profile_steps)
    print(json.dumps({"root": root, "card": card, "in_process": steps,
                      "scaling": _scaling(root, args.iters)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
