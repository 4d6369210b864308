"""Faults planted in the sharded fit's ranks (traffic kind `sharded_fit`):
the readings that its limits of `correct` must tell from a sound program.

    undo = plant("rank_skips_allreduce")     # in rank 0's process, before make()
    ...
    undo()

plant() names the fault for the next cell that rank 0 sets up, which hands
the name to every rank it starts; each rank then applies it to its own
process as it builds the step (apply). The faults:
- `rank_skips_allreduce`: the last rank all-reduces a copy of its buffer
  and steps on its own band's numbers alone, while its peers' all-reduce
  still pairs with it;
- `band_renders_other_rows`: every band renders the next band's rows (the
  last band the first's) against its own rows of the target;
- `tick_skipped`: the step renders the scene without the physics tick.

    python3 -m portbench.sharded_faults --workload <cell> --faults a,b --seeds 1,2,3

prints each fault's readings a seed, one JSON line each, and the smallest
reading of each number.
"""
from __future__ import annotations

import argparse
import json
import sys

FAULTS = ("rank_skips_allreduce", "band_renders_other_rows", "tick_skipped")
PLANTED: str | None = None


def plant(fault: str):
    """Name `fault` for the next sharded cell; returns the function that
    takes it out again."""
    global PLANTED
    if fault not in FAULTS:
        raise ValueError(f"no sharded fault {fault!r}")
    PLANTED = fault

    def take_out():
        global PLANTED
        PLANTED = None
    return take_out


def _set(obj, name, value, undo):
    old = getattr(obj, name)
    setattr(obj, name, value)
    undo.append(lambda: setattr(obj, name, old))


def apply(fault: str | None, rank: int, world: int):
    """Apply `fault` to this rank's process; returns the undo (None for no
    fault)."""
    if fault is None:
        return None
    import torch.distributed as dist

    import rtwc_tpu_torch.dist.mesh as M

    undo = []
    if fault == "rank_skips_allreduce":
        if rank == world - 1:
            all_reduce = dist.all_reduce
            _set(dist, "all_reduce", lambda t, *a, **kw: all_reduce(t.clone(), *a, **kw), undo)
    elif fault == "band_renders_other_rows":
        full = M.soft_band_mse_loss

        def shifted(sph, pl, cam, row0, tgt, **kw):
            return full(sph, pl, cam, (row0 + kw["band_h"]) % kw["config"].height, tgt, **kw)
        _set(M, "soft_band_mse_loss", shifted, undo)
    elif fault == "tick_skipped":
        _set(M, "update_scene", lambda scene, *a, **kw: scene, undo)
    else:
        raise ValueError(f"no sharded fault {fault!r}")

    def take_out():
        while undo:
            undo.pop()()
    return take_out


def main(argv=None) -> int:
    from portbench import harness

    p = argparse.ArgumentParser(prog="portbench.sharded_faults")
    p.add_argument("--workload", required=True)
    p.add_argument("--faults", default=",".join(FAULTS))
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = harness.cell_files(args.workload)
    mod = harness.driver(traffic["kind"])
    low: dict = {}
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in [int(s) for s in args.seeds.split(",") if s]:
            undo = plant(fault)
            try:
                c = mod.make(config, traffic, seed, args.device)
                c.setup()
                c.window(seconds=args.seconds, spans=harness.Spans(False))
                c.release()
            finally:
                undo()
            row = {n: v for n, v, _ in c.check()}
            print(json.dumps({"cell": args.workload, "side": f"fault:{fault}", "seed": seed,
                              **row}), flush=True)
            for n, v in row.items():
                low.setdefault(fault, {})[n] = min(v, low.get(fault, {}).get(n, v))
            del c
    print(json.dumps({"cell": args.workload, "fault_min": low}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
