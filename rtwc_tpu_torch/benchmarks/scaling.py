"""Scaling of the row-band sharded train step over ranks.

Counterpart: benchmarks/scaling.py and benchmarks/multiproc_scaling.py.
Times the sharded train step (rtwc_tpu_torch/dist) at mesh sizes 1..N on
the same whole image and prints one JSON record on stdout: per mesh size
the ms a step (the slowest rank's), rays/s, every step's loss, whether
every rank's losses and parameters agreed bit for bit, whether the step
ran as CUDA graphs (`graph`: on a card it does, the scene and the camera
on the rank's device), each rank's CUDA graphs a step (`phases`), each
rank's launches of one replayed step, counted at its capture
(`replay_launches`), and the launches counted a timed step
(`launches_per_step`: none when replayed); a human summary goes to
stderr. One process, and NCCL ranks, run the step as one graph, the
all-reduce inside under NCCL; gloo ranks run a graph up to the
all-reduce, the all-reduce, and a graph of the update (dist/mesh.py).

    python -m rtwc_tpu_torch.benchmarks.scaling                 # one process, the card
    python -m rtwc_tpu_torch.benchmarks.scaling --ranks 2       # 1 and 2 gloo processes on the card
    python -m rtwc_tpu_torch.benchmarks.scaling --ranks 1 --dist-backend nccl   # one NCCL rank
    python -m rtwc_tpu_torch.benchmarks.scaling --simulate 4    # 1, 2 and 4 gloo ranks on the CPU
    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m rtwc_tpu_torch.benchmarks.scaling [--dist-backend nccl]

Each mesh size n of --ranks / --simulate runs n processes, rank r on card
r % (cards) or on the CPU, joined through initialize_multihost with
--dist-backend (gloo by default). NCCL takes one card a rank: a mesh
larger than the cards exits with initialize_multihost's message before
any rank starts. Rows whose ranks share a card or run on the CPU are
tagged "simulated": they prove the collective and the replicas'
agreement, never scaling, and carry no efficiency. An `efficiency` needs
one card a rank and a smaller mesh of the same run to compare with.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

RANK_TIMEOUT_S = 600


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m rtwc_tpu_torch.benchmarks.scaling")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spheres", type=int, default=100)
    p.add_argument("--tau", type=float, default=0.5)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--backend", choices=["jnp", "pallas"], default="pallas")
    p.add_argument("--simulate", type=int, default=0,
                   help="mesh sizes up to N, each as that many gloo ranks on the CPU")
    p.add_argument("--ranks", type=int, default=0,
                   help="mesh sizes up to N, each as that many processes on the card(s)")
    p.add_argument("--sizes", type=str, default="",
                   help="comma-separated mesh sizes (default: 1, 2, 4, ... up to N)")
    p.add_argument("--shadows", action=argparse.BooleanOptionalAction, default=True,
                   help="differentiable soft shadows in the train step (K4-K6)")
    p.add_argument("--animate", action=argparse.BooleanOptionalAction, default=True,
                   help="tick the sphere physics (update_scene) inside every step")
    p.add_argument("--dist-backend", choices=["gloo", "nccl"], default="gloo")
    p.add_argument("--out", type=str, default="",
                   help="also append the record to this JSON-lines file")
    p.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", type=str, default="", help=argparse.SUPPRESS)
    p.add_argument("--device", type=str, default="", help=argparse.SUPPRESS)
    return p


def run_rank(args, device: str, graph: bool | None = None) -> dict:
    """Build the step on a mesh of one band a rank (of the initialised
    group, or this process alone), with the scene and the camera on
    `device`, run 2 warm-up steps and --iters timed ones; returns this
    rank's timing, losses, a digest of its params and its launches. graph:
    make_sharded_train_step's (None: CUDA graphs on the card, the first
    warm-up step captures them). `phases` is the number of CUDA graphs (or
    eager calls) a step; `replay_launches` are one replayed step's
    launches, counted at its capture (None when eager); `launches` those
    counted a timed step, which are none on the graph path (a replay counts
    nothing)."""
    import torch

    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.dist import make_mesh, make_sharded_train_step
    from rtwc_tpu_torch.render.step_graph import launch_counts, launch_delta
    from rtwc_tpu_torch.scene import random_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = RenderConfig(width=args.width, height=args.height, max_spheres=args.spheres,
                       max_planes=4, soft_miss_penalty=300.0, soft_mask_k=10.0,
                       shadows=args.shadows)
    scene = random_scene(args.spheres, max_spheres=args.spheres, max_planes=4, seed=0,
                         device=device)
    cam = default_camera().to(device)
    target = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=device)
    step = make_sharded_train_step(cfg, make_mesh(), tau=args.tau, backend=args.backend,
                                   animate=args.animate, graph=graph)
    params = (scene, cam)
    state = step.init(params)
    tick = 1.0 / 60.0
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, target, tick)
        losses.append(float(loss))
    if device.startswith("cuda"):
        torch.cuda.synchronize(device)
    before = launch_counts()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        params, state, loss = step(params, state, target, tick)
    losses.append(float(loss))
    launches = {k: v / args.iters for k, v in launch_delta(before).items()}
    if device.startswith("cuda"):
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / args.iters * 1e3
    digest = hashlib.sha256()
    for v in state.leaves.values():
        digest.update(v.detach().cpu().numpy().tobytes())
    in_graph = state.phases[0].graph
    return {"ms_per_step": ms, "losses": [x.hex() for x in losses], "graph": in_graph,
            "phases": len(state.phases),
            "replay_launches": state.replay_launches if in_graph else None,
            "launches": launches, "params_sha256": digest.hexdigest(), "device": device}


def _worker(args) -> int:
    """One rank of a spawned mesh: prints LOSS and a RANK record."""
    import torch

    from rtwc_tpu_torch.dist import initialize_multihost
    from rtwc_tpu_torch.dist.multihost import shutdown_multihost

    if args.device == "cpu":
        torch.set_num_threads(1)
    if not initialize_multihost(args.coordinator, args.world, args.rank, args.dist_backend):
        raise RuntimeError("initialize_multihost declined to initialise")
    res = run_rank(args, args.device)
    print(f"LOSS {res['losses'][-1]}", flush=True)
    print("RANK " + json.dumps(dict(res, rank=args.rank)), flush=True)
    shutdown_multihost()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(args, n: int, on_cpu: bool, cards: int) -> list:
    """n ranks in subprocesses, each under RANK_TIMEOUT_S; their RANK
    records, in rank order."""
    coordinator = f"127.0.0.1:{_free_port()}"
    base = [sys.executable, "-m", "rtwc_tpu_torch.benchmarks.scaling",
            "--width", str(args.width), "--height", str(args.height),
            "--spheres", str(args.spheres), "--tau", str(args.tau), "--iters", str(args.iters),
            "--backend", args.backend, "--dist-backend", args.dist_backend,
            "--shadows" if args.shadows else "--no-shadows",
            "--animate" if args.animate else "--no-animate",
            "--world", str(n), "--coordinator", coordinator]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(base + ["--rank", str(r), "--device",
                                      "cpu" if on_cpu else f"cuda:{r % cards}"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=root, env=env)
             for r in range(n)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=RANK_TIMEOUT_S))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    recs = []
    for r, (pr, (out, err)) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("LOSS "):
                print(f"rank {r}/{n}: {line}", file=sys.stderr)
        found = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if pr.returncode != 0 or len(found) != 1:
            raise RuntimeError(f"rank {r} of {n} exited {pr.returncode}:\n{out}\n{err}")
        recs.append(json.loads(found[0][5:]))
    return recs


def _row(n: int, recs: list, rays: int) -> dict:
    ms = max(r["ms_per_step"] for r in recs)
    return {"mesh": n, "ms_per_step": round(ms, 3), "rays_per_s": round(rays / ms * 1e3, 1),
            "losses": [float.fromhex(x) for x in recs[0]["losses"]],
            "rank_losses": [r["losses"][-1] for r in recs],
            "graph": all(r["graph"] for r in recs),
            "phases": [r["phases"] for r in recs],
            "replay_launches": [r["replay_launches"] for r in recs],
            "launches_per_step": [r["launches"] for r in recs],
            "losses_bit_equal": all(r["losses"] == recs[0]["losses"] for r in recs),
            "params_bit_equal": all(r["params_sha256"] == recs[0]["params_sha256"]
                                    for r in recs)}


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.rank >= 0:
        return _worker(args)

    import torch
    import torch.distributed as dist

    from rtwc_tpu_torch.dist import initialize_multihost
    from rtwc_tpu_torch.dist.multihost import check_card_a_rank, shutdown_multihost

    rays = args.width * args.height
    try:
        torchrun = initialize_multihost(backend=args.dist_backend)
    except ValueError as e:  # NCCL ranks sharing a card
        raise SystemExit(str(e)) from None
    if torchrun:  # this process is one rank of torchrun's mesh
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % max(1, torch.cuda.device_count())}"
        world, rank = dist.get_world_size(), dist.get_rank()
        recs = [None] * world
        dist.all_gather_object(recs, run_rank(args, device))
        shutdown_multihost()
        if rank != 0:
            return 0
        rows = [_row(world, recs, rays)]
        n_cards, platform = torch.cuda.device_count(), "gpu"
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", world)) > n_cards
    else:
        on_cpu = bool(args.simulate)
        if not on_cpu and not torch.cuda.is_available():
            raise SystemExit("no CUDA card: pass --simulate N to run gloo ranks on the CPU")
        n_max = args.simulate or args.ranks or 1
        sizes = ([int(s) for s in args.sizes.split(",") if s]
                 or [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= n_max])
        n_cards = 0 if on_cpu else torch.cuda.device_count()
        platform = "cpu" if on_cpu else "gpu"
        if args.ranks and args.dist_backend == "nccl":
            try:
                check_card_a_rank(max(sizes))
            except ValueError as e:
                raise SystemExit(str(e)) from None
        rows = []
        for n in sizes:
            if args.height % n:
                print(f"# skip n={n}: height {args.height} not divisible", file=sys.stderr)
                continue
            if args.simulate or args.ranks:
                recs = _spawn(args, n, on_cpu, n_cards)
            elif n == 1:
                recs = [run_rank(args, "cuda")]
            else:
                raise SystemExit(f"mesh {n} needs --ranks or --simulate")
            rows.append(_row(n, recs, rays))
        shared = None

    base = None
    for row in rows:
        n = row["mesh"]
        simulated = platform == "cpu" or (shared if shared is not None else n > n_cards)
        eff_txt = ""
        if simulated:
            row["simulated"] = True
        elif base is None:
            base = (n, row["rays_per_s"])
        else:
            row["efficiency"] = round(row["rays_per_s"] * base[0] / (base[1] * n), 4)
            eff_txt = f"  eff={row['efficiency'] * 100:5.1f}% (vs mesh={base[0]})"
        print(f"mesh={n:3d}  {row['ms_per_step']:8.2f} ms/step  {row['rays_per_s'] / 1e6:8.1f} "
              f"Mrays/s  {'replayed' if row['graph'] else 'eager'} "
              f"({max(row['phases'])} phase{'s' if max(row['phases']) > 1 else ''} a step), "
              f"losses bit-equal {row['losses_bit_equal']}, params "
              f"{row['params_bit_equal']}"
              + (eff_txt or ("  [simulated: topology only]" if simulated else "")),
              file=sys.stderr)

    record = {
        "config": {"width": args.width, "height": args.height, "spheres": args.spheres,
                   "tau": args.tau, "backend": args.backend, "animate": args.animate,
                   "shadows": args.shadows, "simulate": args.simulate, "ranks": args.ranks,
                   "dist_backend": args.dist_backend},
        "platform": platform,
        "device": "cpu" if platform == "cpu" else torch.cuda.get_device_name(0),
        "n_devices": n_cards,
        "results": rows,
    }
    print(json.dumps(record))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(record) + "\n")
    agree = all(r["losses_bit_equal"] and r["params_bit_equal"] for r in rows)
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
