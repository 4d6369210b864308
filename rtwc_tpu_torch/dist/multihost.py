"""Multi-process runtime bootstrap.

Counterpart: rtwc_tpu/dist/multihost.py. Every process calls
initialize_multihost() first; make_mesh() then spans every process of the
default group, and the train step's one all-reduce crosses the process
boundary. The rendezvous is a TCP store at the coordinator's address,
given explicitly or by torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
RANK.
"""
from __future__ import annotations

import datetime
import gc
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("rtwc_tpu_torch")


def check_card_a_rank(local_ranks: int) -> int:
    """This host's card count, when it has a card for each of its
    `local_ranks` NCCL ranks; else a ValueError (NCCL refuses two ranks on
    one device)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_ranks > cards:
        raise ValueError(f"nccl needs a card a rank: {local_ranks} ranks on this host, {cards} "
                         f"cards (ranks that share a card take backend='gloo')")
    return cards


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout: float | None = None,
) -> bool:
    """Initialise torch.distributed's default group when this process is
    one of several. Returns False, doing nothing, when no coordinator is
    given and torchrun's variables are not set, so a single process never
    pays for it; True once the group is up (or already was).

    coordinator_address: "host:port" of rank 0's store (else MASTER_ADDR /
    MASTER_PORT); num_processes and process_id else WORLD_SIZE and RANK.
    backend: "gloo" (None) or "nccl". NCCL takes one card a rank: it is
    refused, with a ValueError, when this host's ranks (LOCAL_WORLD_SIZE,
    else all of them) outnumber its cards; ranks sharing a card use gloo,
    whose collectives take CUDA tensors through the host.

    timeout: seconds that the join, and later every collective outside a
    CUDA graph, may wait for the other ranks before it raises (None:
    torch.distributed's default). With NCCL the rank's card is made the
    current device before the group is made, so the communicator is
    bound to it.
    """
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" not in env:
        return False
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", "1"))
    rank = int(process_id if process_id is not None else env.get("RANK", "0"))
    backend = backend or "gloo"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown torch.distributed backend {backend!r}")
    if backend == "nccl":
        cards = check_card_a_rank(int(env.get("LOCAL_WORLD_SIZE", world)))
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank % cards)))
    # env:// joins the store torchrun's agent may already host at MASTER_PORT
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=float(timeout))}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank, **kw)
    log.info("multihost: rank %d/%d, backend %s", dist.get_rank(), dist.get_world_size(),
             dist.get_backend())
    return True


def shutdown_multihost() -> None:
    """Leave torch.distributed's default group, after the CUDA graphs that
    captured its collectives are gone. A step or frame that is no longer
    referenced sits in a reference cycle with its graph until the cyclic
    collector runs, and under NCCL a live graph that captured a collective
    can keep the group's shutdown waiting. So: render_frame_sharded's
    cached frame graphs dropped, a collection, the device waited for, then
    destroy_process_group. Every rank calls it at about the same time
    (NCCL pairs the ranks' shutdowns). Does nothing without a group."""
    if not dist.is_initialized():
        return
    from rtwc_tpu_torch.dist import mesh

    mesh._frame_graph.cache_clear()
    gc.collect()
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dist.destroy_process_group()
