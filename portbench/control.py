"""The readings that the limits of `correct` are set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... [--control-seeds 1,2,3]
        [--faults half_batch_fused,answer_altered_fused --fault-seeds 1,2,3]
        [--seconds 2] [--vary-problem]

For each seed one process builds the cell as a run does, warms it, runs a
window of --seconds at the cell's own load, frees the port's state and
prints the numbers its check compares (the program's readings). For each
control seed it prints the same numbers for the control: the reference,
computed in bfloat16 (the nearest precision below the configuration's
float32), put in the program's place. For each fault (faults.py) and
fault seed, the program's readings with that fault planted. The
benchmark's runs never run the control or a fault. Prints one JSON line a
reading and a summary line: the largest program reading and the smallest
control and fault readings of each number.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def readings(cell: str, seeds, control_seeds, seconds: float, device: str = "cuda",
             overrides: dict | None = None, vary: bool = False, fault_list=(),
             fault_seeds=()) -> dict:
    """vary: draw the fit's scene and start from each seed too (the fit
    cells fix them), so the readings cover other problems than the cell's."""
    from portbench import faults, harness

    config, traffic = harness.cell_files(cell)
    if vary:
        traffic = {k: v for k, v in traffic.items() if k not in ("scene_seed", "perturb_seed")}
    config = harness.merged(config, overrides)
    mod = harness.driver(traffic["kind"])
    out = {"program": [], "control": [], **{f"fault:{f}": [] for f in fault_list}}

    def emit(side, seed, rows):
        row = {n: v for n, v, _ in rows}
        out[side].append({"seed": seed, **row})
        print(json.dumps({"cell": cell, "side": side, "seed": seed, **row}), flush=True)

    def one(seed, fault=None):
        undo = faults.plant(fault) if fault else None
        try:
            c = mod.make(config, traffic, seed, device)
            c.setup()
            c.window(seconds=seconds, spans=harness.Spans(False))
            c.release()
        finally:
            if undo:
                undo()
        return c

    for seed in sorted(set(seeds) | set(control_seeds)):
        c = one(seed)
        if seed in seeds:
            emit("program", seed, c.check())
        if seed in control_seeds:
            emit("control", seed, c.control())
        del c
    for fault in fault_list:
        for seed in fault_seeds:
            emit(f"fault:{fault}", seed, one(seed, fault).check())
    names = [k for k in (out["program"] or out["control"])[0] if k != "seed"]
    out["summary"] = {n: {"program_max": max((r[n] for r in out["program"]), default=None),
                          **{f"{side}_min": min((r[n] for r in rows if n in r), default=None)
                             for side, rows in out.items() if side != "program"}}
                      for n in names}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--vary-problem", action="store_true",
                   help="draw the fit's scene and start from each seed")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control runs on a CUDA card; torch finds none", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = readings(args.workload, ints(args.seeds), ints(args.control_seeds), args.seconds,
                   vary=args.vary_problem, fault_list=[f for f in args.faults.split(",") if f],
                   fault_seeds=ints(args.fault_seeds))
    print(json.dumps({"cell": args.workload, "summary": out["summary"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
