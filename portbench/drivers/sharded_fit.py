"""Traffic kind `sharded_fit`: the row-band sharded inverse-rendering fit,
one process a rank, as a user runs it on one host's cards.

The harness's process is rank 0; at the top of set-up it starts ranks 1
.. N-1 (`python3 -m portbench.drivers.sharded_rank`), each on a card of
its own under NCCL (or sharing the card, or on the CPU, under gloo), so
that their imports overlap its own. Every rank builds the same cell from
the configuration, the traffic and the seed that rank 0 puts in a TCP
store on a free local port, joins the group through the port's
`initialize_multihost`, and takes the port's `make_sharded_train_step` on
a mesh of one band a rank: each rank renders its band of rows of the
ticked scene (the physics tick of dt inside every step), takes the
band's loss and gradients, and one all-reduce a step (under NCCL inside
the rank's one CUDA graph) averages them before every rank takes the same
optimiser step. Rank 0's reference renders the target (the true scene,
ticked) and hands each rank its band's rows through the store.

Set-up takes fit_step's path on every rank: an eager step and the
capture, the start put back, three compared steps, the warm steps. The
window is fit_step's fed loop on rank 0; the ranks agree on the steps
through the store in batches of SYNC_EVERY (rank 0 posts "go" before
each batch and "stop" at the close), so no device queue drains between
steps, and rank 0's close waits for its card, whose last all-reduce waits
for every rank. A step is W x H rays, the whole frame. After the window,
in release() and so outside the window's span, each rank hands rank 0 its
leaves; in a traced window each rank profiles its own steps and hands
over its K6 device ms a step.

The harness reports one card, the one its own process holds
(harness.device_info). On a card the cell patches that reading, from
set-up to release(), to the cards its ranks ran on: each rank hands rank 0
its card's identity, name and peak after the window, and the result line
counts the distinct cards, so a rank that ran on another rank's card
shows as a card fewer.

Every wait is bounded. The store's waits raise after STORE_S; the join
has JOIN_S where the port's initialize_multihost takes a timeout; and a
watchdog thread on every rank ends the process (and on rank 0 the ranks
it started) when set-up, the window or the release outlasts its limit,
which also covers a card waiting on a collective whose peer is gone.
release() and the process's exit end the ranks; a rank ends when rank 0
does.

Compared (rank 0, after fit_step's method, the reference following the
program through the tick, reference/animated.py): loss_gap, grad_gap,
move_gap; and replica_gap, the largest difference of any rank's leaves
from rank 0's after the window (0: every rank takes the same update on the
same all-reduced numbers).

Traffic keys: fit_step's (loss "mse_fused", optimizer {kind
"step_default": make_sharded_train_step's own, Adam at lr on every leaf,
capturable in the graph on a card}), ranks, dist_backend ("nccl" or
"gloo"; the CPU takes gloo), dt, limits with replica_gap.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import faulthandler
import inspect
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from portbench.drivers import common, fit_step
from portbench.reference import animated, broad, soft
from portbench.reference import camera as rcam
from portbench.reference import scenes
from portbench.reference import work as W

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SYNC_EVERY = fit_step.SYNC_EVERY
HOST = "127.0.0.1"
JOIN_S = 120.0       # the group's join
STORE_S = 300.0      # any one wait on the store
SETUP_S = 420.0      # a rank's set-up, the kernels' first build included
TAIL_S = 120.0       # the window's close and the hand-over, past its own time
RELEASE_S = 60.0     # the ranks' exit after release
K6 = ["soft_sh_mse*"]


def make(config: dict, traffic: dict, seed: int, device):
    return ShardedFitCell(config, traffic, seed, device)


class Watchdog:
    """Ends this process when the armed phase outlasts its limit, after
    printing every thread's stack and calling `on_expire` (rank 0 ends
    the ranks it started)."""

    def __init__(self, on_expire=lambda: None):
        self.on_expire, self.phase, self.deadline = on_expire, "", None
        self._closed = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()

    def arm(self, phase: str, seconds: float) -> None:
        self.phase, self.deadline = phase, time.monotonic() + seconds

    def disarm(self) -> None:
        self.deadline = None

    def close(self) -> None:
        self._closed.set()

    def _run(self) -> None:
        while not self._closed.wait(0.5):
            if self.deadline is not None and time.monotonic() > self.deadline:
                print(f"sharded_fit: {self.phase} outlasted its limit; ending the run",
                      file=sys.stderr, flush=True)
                faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
                self.on_expire()
                os._exit(1)


def device_of(traffic: dict, rank: int, device) -> torch.device:
    """A rank's device: a card a rank under NCCL, the cards in turn under
    gloo, the CPU for a CPU run."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if traffic["dist_backend"] == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


def card_of(device: torch.device) -> dict:
    """A card's identity (its UUID where torch reads one), its name and
    this process's peak of allocated bytes on it."""
    props = torch.cuda.get_device_properties(device)
    return {"id": str(getattr(props, "uuid", device.index)), "kind": props.name,
            "peak": int(torch.cuda.max_memory_allocated(device))}


def cards_info(base: dict, cards: list) -> dict:
    """The harness's device figures (base) for the cards the ranks ran on:
    the count of distinct cards, their kind (the kinds joined by "+" where
    they differ) and the largest rank's peak of allocated bytes."""
    kinds = sorted({c["kind"] for c in cards})
    return {**base, "count": len({c["id"] for c in cards}), "kind": "+".join(kinds),
            "memory_peak_bytes": max(c["peak"] for c in cards)}


class ShardedFitCell(fit_step.FitCell):
    def __init__(self, config: dict, traffic: dict, seed: int, device, rank: int = 0):
        if traffic["loss"] != "mse_fused" or traffic["optimizer"]["kind"] != "step_default":
            raise ValueError("sharded_fit takes the fused MSE and the step's own optimiser")
        super().__init__(config, traffic, seed, device_of(traffic, rank, device))
        self.seed, self.rank, self.world = seed, rank, int(traffic["ranks"])
        self.backend = traffic["dist_backend"] if self.device.type == "cuda" else "gloo"
        self.dt = float(np.float32(traffic["dt"]))
        self.rows = self.cfg.height // self.world
        self.procs, self.store, self.undo_fault = [], None, None
        self.harness_device_info = None
        self.replica_gap = float("inf")

    # -- the ranks -------------------------------------------------------------

    def _start_ranks(self) -> None:
        self.store = torch.distributed.TCPStore(
            HOST, 0, None, True, datetime.timedelta(seconds=STORE_S), wait_for_workers=False)
        self.group = f"{HOST}:{_free_port()}"
        self.store.set("spec", json.dumps({
            "config": self.config, "traffic": self.traffic, "seed": self.seed,
            "device": self.device.type, "group": self.group, "fault": self.fault}))
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.drivers.sharded_rank", "--store",
                 f"{HOST}:{self.store.port}", "--rank", str(r), "--parent", str(os.getpid())],
                cwd=ROOT, stdin=subprocess.DEVNULL, stdout=2, stderr=2))
        atexit.register(self._end_ranks)
        self.dog = Watchdog(self._end_ranks)

    def _end_ranks(self, grace: float = 0.0) -> None:
        deadline = time.monotonic() + grace
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            if p.poll() is None:
                p.kill()
                p.wait()

    def _join(self) -> None:
        from rtwc_tpu_torch.dist import initialize_multihost

        kw = ({"timeout": JOIN_S}
              if "timeout" in inspect.signature(initialize_multihost).parameters else {})
        if not initialize_multihost(self.group, self.world, self.rank, self.backend, **kw):
            raise RuntimeError("initialize_multihost declined to join the group")

    def _build(self) -> None:
        from portbench import sharded_faults
        from rtwc_tpu_torch.camera import Camera
        from rtwc_tpu_torch.dist import make_mesh, make_sharded_train_step

        self.undo_fault = sharded_faults.apply(self.fault, self.rank, self.world)
        dev = self.device
        pcfg = common.port_config(self.config, self.traffic)
        scene = common.port_scene(self.start, dev)
        cam = Camera(pos=torch.from_numpy(self.pos.copy()).to(dev),
                     rot=torch.from_numpy(self.rot.copy()).to(dev))
        fn = make_sharded_train_step(pcfg, make_mesh(self.world), tau=self.tau,
                                     backend="pallas", animate=True)
        st = fn.init((scene, cam))
        self.state, self.leaves, self.opt = st, st.leaves, st.optimizer
        self.params = (scene, cam)
        target, dt = self.band_target, self.dt

        def step():
            self.params, _, loss = fn(self.params, st, target, dt)
            return loss
        self.step = step

    def _first_steps(self) -> None:
        """fit_step's set-up from the built step on: the eager step and the
        capture, the start put back, the compared steps, the warm steps."""
        p0 = {k: v.detach().clone() for k, v in self.leaves.items()}
        float(self.step())
        self.t_first = time.perf_counter()
        self._restart(p0)
        self.readings = self._read_steps()
        loss = None
        for _ in range(int(self.traffic["warm_steps"])):
            loss = self.step()
        if loss is not None:
            float(loss)

    def _leaf_bytes(self) -> bytes:
        return b"".join(v.detach().float().cpu().numpy().tobytes() for v in self.leaves.values())

    def _wait_card(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the system under test (rank 0) -----------------------------------------

    def setup(self) -> None:
        from portbench import sharded_faults

        self.fault = sharded_faults.PLANTED
        self._start_ranks()
        self.dog.arm("set-up", SETUP_S)
        cuda = self.device.type == "cuda"
        if cuda:
            from portbench import harness

            self.harness_device_info, harness.device_info = harness.device_info, self.device_info
            torch.cuda.set_device(self.device)
            torch.zeros(1, device=self.device)
            torch.cuda.synchronize()
        t = [time.perf_counter()]
        lv = soft.leaves(self.true, self.pos, self.rot, self.device, torch.float32, ())
        self.target, _ = animated.render(lv, self.cfg, self.tau, self.cfg.shadows, self.dt)
        self.target_a = None
        del lv
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t.append(time.perf_counter())
        self.reference_s = t[1] - t[0]
        host = self.target.cpu().numpy()
        for r in range(1, self.world):
            self.store.set(f"target{r}", host[r * self.rows:(r + 1) * self.rows].tobytes())
        self.band_target = self.target.clone()
        self._join()
        self._build()
        self._first_steps()
        t += [self.t_first, time.perf_counter()]
        self.setup_split = {"reference_s": self.reference_s, "first_call_s": t[2] - t[1],
                            "steps_s": t[3] - t[2]}
        self.dog.disarm()

    def window(self, seconds: float | None = None, units: int | None = None, spans=None) -> dict:
        traced = bool(getattr(spans, "on", False))
        self.dog.arm("the window", (seconds or 0.0) + TAIL_S + 0.1 * (units or 0))
        self.store.set("window", json.dumps({"trace": traced, "seconds": seconds,
                                             "units": units}))
        at = {"calls": 0, "batches": 0}

        def step():
            if at["calls"] % SYNC_EVERY == 0:
                self.store.set(f"batch{at['batches']}", "go")
                at["batches"] += 1
            at["calls"] += 1
            return self.step()

        def wait():
            self.store.set(f"batch{at['batches']}", "stop")
            self._wait_card()

        raw = fit_step.fed_loop(step, SYNC_EVERY, fit_step.AHEAD_STEPS, self.device, seconds,
                                units, spans, wait=wait)
        self.window_raw, self.traced = raw, traced
        self.dog.disarm()
        return raw

    def device_info(self, device) -> dict:
        """harness.device_info while the cell is set up: its reading of card
        0 widened to every rank's card, which each rank hands over after
        the window."""
        info = self.harness_device_info(device)
        if torch.device(device).type != "cuda":
            return info
        self.dog.arm("the cards' hand-over", STORE_S + 30.0)
        cards = [card_of(self.device)] + [json.loads(self.store.get(f"card{r}"))
                                          for r in range(1, self.world)]
        self.dog.disarm()
        return cards_info(info, cards)

    def _restore_device_info(self) -> None:
        if self.harness_device_info is not None:
            from portbench import harness

            harness.device_info, self.harness_device_info = self.harness_device_info, None

    def _hand_over(self) -> None:
        """After the window, outside its span: every rank's leaves against
        rank 0's (replica_gap) and, after a traced window, each rank's K6
        ms a step into the window's raw figures, where band_spread reads
        them."""
        mine = np.frombuffer(self._leaf_bytes(), np.float32)
        gaps, k6 = [0.0], []
        for r in range(1, self.world):
            theirs = np.frombuffer(self.store.get(f"leaves{r}"), np.float32)
            gaps.append(float(np.max(np.abs(theirs - mine))) if theirs.shape == mine.shape
                        else float("inf"))
            if self.traced:
                k6.append(json.loads(self.store.get(f"k6_{r}")))
        self.replica_gap = max(gaps)
        if self.traced:
            self.window_raw["band_k6_ms"] = k6

    def _free(self) -> None:
        """The step, its graphs and state freed, then this rank's group:
        every rank leaves the group at once (NCCL's shutdown pairs the
        ranks' calls)."""
        for name in ("state", "params"):
            if hasattr(self, name):
                delattr(self, name)
        super().release()
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    def release(self) -> None:
        self.dog.arm("the release", RELEASE_S + 30.0)
        if hasattr(self, "window_raw"):
            self._hand_over()
        if self.store is not None:
            self.store.set("release", "1")
        self._free()
        self._end_ranks(RELEASE_S)
        self._restore_device_info()
        if self.undo_fault:
            self.undo_fault()
        atexit.unregister(self._end_ranks)
        self.dog.disarm()
        self.dog.close()
        self.store = None

    # -- one of ranks 1 .. N-1 ---------------------------------------------------

    def follow(self, store, spec: dict) -> None:
        """This rank's whole part: set-up, the window's batches as rank 0
        posts them, the hand-over, the release. spec: what rank 0 put in
        the store (the group's address, the planted fault)."""
        self.store, self.group, self.fault = store, spec["group"], spec["fault"]
        dog = Watchdog()
        dog.arm("set-up", SETUP_S)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        band = np.frombuffer(store.get(f"target{self.rank}"), np.float32)
        target = torch.zeros((self.cfg.height, self.cfg.width, 3), dtype=torch.float32)
        r0 = self.rank * self.rows
        target[r0:r0 + self.rows] = torch.from_numpy(band.copy()).view(self.rows, -1, 3)
        self.band_target = target.to(self.device)
        self._join()
        self._build()
        self._first_steps()
        dog.disarm()
        spec = json.loads(store.get("window"))
        dog.arm("the window", (spec["seconds"] or 0.0) + TAIL_S + 0.1 * (spec["units"] or 0))
        prof = contextlib.nullcontext()
        if spec["trace"]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if self.device.type == "cuda" else [])
            prof = profile(activities=acts)
        n = 0
        with prof:
            while store.get(f"batch{n // SYNC_EVERY}") == b"go":
                for _ in range(SYNC_EVERY):
                    self.step()
                n += SYNC_EVERY
            self._wait_card()
        if self.device.type == "cuda":
            store.set(f"card{self.rank}", json.dumps(card_of(self.device)))
        store.set(f"leaves{self.rank}", self._leaf_bytes())
        if spec["trace"]:
            store.set(f"k6_{self.rank}", json.dumps(_k6_ms(prof, n)))
        dog.arm("the release", STORE_S + 30.0)
        store.get("release")
        self._free()
        dog.close()

    # -- the reference -----------------------------------------------------------

    def _loss_and_grads(self, lv: dict, dtype) -> tuple:
        loss, grads = animated.loss_and_grads(lv, self.trained, self.cfg, self.tau,
                                              self.cfg.shadows, self.target.to(dtype), self.dt)
        return loss, {k: (g if g is not None else torch.zeros_like(lv[k])) for k, g in
                      grads.items()}

    def check(self) -> list:
        return self.compare(self.readings) + [
            ("replica_gap", self.replica_gap, self.traffic["limits"]["replica_gap"])]

    def work(self) -> dict:
        """K6's frozen work count for rank 0's band (rows 0 .. H / N - 1) at
        the ticked start, on the band's own tile grid."""
        cfg, dev, rows = self.cfg, self.device, self.rows
        lv = animated.tick(soft.leaves(self.start, self.pos, self.rot, dev, torch.float32, ()),
                           self.dt, cfg.bob_min_y, cfg.bob_max_y)
        right, up, fwd = rcam.basis(torch.from_numpy(self.rot).to(dev))
        cols = tuple(torch.stack([right[i], up[i], fwd[i]]) for i in range(3))
        e1, e2 = rcam.projection_elements(cfg)
        ti, tj = broad.grid(rows, cfg.width)
        T, px = ti * tj, ti * tj * broad.TILE * broad.TILE
        lists = broad.sphere_lists(lv["spheres.center"], lv["spheres.radius"],
                                   lv["spheres.active"], lv["camera.pos"], cols, cfg, e1, e2,
                                   tau=self.tau, hard=False)[:T]
        gates = animated.band_gates(lv, cfg, self.tau, lists, 0, rows)
        ns, n_pl = cfg.max_spheres, cfg.max_planes
        npl = scenes.n_live(self.start["planes"])
        tables = 4 * (8 * ns + 12 * n_pl + 16)
        shl = torch.zeros((T, 1, ns + 1), dtype=torch.int32, device=dev)
        counts = torch.stack([gates[:, 0].sum(1), torch.zeros_like(gates[:, 0, 0])], 1)
        return {"soft_sh_mse": W.k6_work(tables, T, 4 * 3 * px, lists, gates, shl, counts,
                                         ns, npl)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _k6_ms(prof, steps: int):
    """K6's device ms a step in a rank's profile (None without kernels)."""
    from portbench import harness
    from portbench.readers import timeline

    ms = [d for name, kind, _, d in harness.kineto_trace(prof)["device"]
          if kind == "kernel" and timeline.matches(name, K6)]
    return sum(ms) / 1e6 / steps if ms and steps else None
