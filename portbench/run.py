"""Run one cell of the benchmark once on one CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic, builds and warms the system
under test (set-up, timed as setup_s from this process's start, less the
seconds the reference spent making the cell's inputs), measures
for --seconds (--trace 0: the cell's end-to-end metrics) or runs the
traffic's traced window under torch.profiler (--trace 1: the per-layer
metrics, busy_s, window_s and the breakdown), frees the port's state,
compares what the timed path produced with the plain reference, and prints
the card's name and power limit, the compared numbers with their limits
on stderr and, as the last line of stdout, one JSON object. Without a CUDA
card it exits 3 and prints no result; so it does, with 4, where a module
of JAX or of the JAX package was loaded after set-up or after the window.
"""
import os
import sys
import time

T_START = time.perf_counter()
# Python's bytecode cache, the port's and torch's included, in a fixed
# directory of the checkout (git-ignored): only a checkout's first run
# compiles them.
sys.pycache_prefix = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    bench = harness.benchmark()
    chips = harness.cell_spec(bench, args.workload)["chips"]
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch finds {found}",
              file=sys.stderr)
        return 3
    print(f"card {harness.card_line()}", file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                          t_start=T_START, guard=True)
        harness.assert_no_forbidden("after the window")
    except harness.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 4
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in out["setup_split"].items()),
          file=sys.stderr)
    for name, value, limit in out["compared"]:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
