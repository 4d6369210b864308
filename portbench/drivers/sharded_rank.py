"""One of ranks 1 .. N-1 of a `sharded_fit` cell (drivers/sharded_fit.py),
started by rank 0, the harness's process:

    python3 -m portbench.drivers.sharded_rank --store HOST:PORT --rank R --parent PID

Reads the cell from rank 0's store, builds it as rank 0 does and follows
rank 0's batches. It ends with rank 0: the kernel sends it SIGKILL when its
parent exits, and every wait it makes is bounded."""
from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import os
import signal
import sys

PR_SET_PDEATHSIG = 1


def _die_with(parent: int) -> None:
    """SIGKILL to this process when its parent ends (Linux), and an end now
    if the parent is already gone."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        sys.exit(1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.drivers.sharded_rank")
    p.add_argument("--store", required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--parent", type=int, required=True)
    args = p.parse_args(argv)
    _die_with(args.parent)
    import torch

    from portbench.drivers import sharded_fit as SF

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host, port = args.store.rsplit(":", 1)
    store = torch.distributed.TCPStore(host, int(port), None, False,
                                       datetime.timedelta(seconds=SF.STORE_S))
    spec = json.loads(store.get("spec"))
    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    cell = SF.ShardedFitCell(spec["config"], spec["traffic"], spec["seed"], spec["device"],
                             rank=args.rank)
    cell.follow(store, spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
