"""Traffic kind `fit_step`: a closed loop of differentiable-renderer train
steps, as an inverse-rendering user runs them.

The harness draws the true scene and the start (the true scene with its
centres perturbed) from the traffic's scene and perturb seeds, and the
reference renders the target from the true scene on the device (its
seconds are the reference's, left out of setup_s). The step is the port's
`CapturedStep` (a CUDA graph of the loss, its backward and, with a
capturable optimiser, the update; otherwise the optimiser steps eagerly
after each replay), built from the port's public API.

The window keeps the card fed while the host stalls: it queues steps
ahead, copies every SYNC_EVERY-th loss into pinned host memory behind an
event, and reads it once that event is done, waiting only where more than
AHEAD_STEPS steps are queued past the oldest unread loss. When the time
is up it queues nothing more, waits for the device, and reads the clock
after that wait: every queued step counts, over all of that time.

Correctness comes from replays, the path the window times. The step's
first call is an eager step followed by the capture (which runs nothing);
set-up then puts the start back into the leaves, zeroes the optimiser's
state and every .grad (a replay's backward has to write them), and takes
the first three steps through the window's own call: on a card, three
replays. It records the trained leaves before each step and after the
last, each step's loss, and each step's gradient as the optimiser got it
(from Adam's first moment). After the window the reference follows the
program step by step: at the program's leaves before each step it takes
the loss and the gradient (plain torch renderer), and its own plain Adam,
stepped on those gradients, gives the change over the three steps; the
first step starts from the harness's start and is the program's alone.
Compared: the worst step's relative loss gap, the worst step's and kept
leaf's gap of gradient norms, and the worst kept leaf's gap of change
norms. Leaves whose reference gradient at the start is under a
thousandth of the median leaf's are left out. The reference does not
take three steps of its own: Adam's first steps move each element by
about lr whatever its gradient's size, so a trajectory of its own departs
from the program's by rounding, as the float32 reference's does from its
float64 self.

Traffic keys: render (constants replaced), tau, loss ("mse_fused": the
fused MSE kernel; "rgb_iou": the frame kernel, RGB MSE plus w_sil (1 -
IoU) of the alpha), w_sil, optimizer {kind: "card_adam" | "adam", lr,
trained: "all" | [leaf names]}, warm_steps, trace_units, scene_seed and
perturb_seed (a number; absent: the run's seed), limits.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import math
import time

import numpy as np
import torch

from portbench.drivers import common
from portbench.reference import broad, scenes, soft
from portbench.reference import camera as rcam
from portbench.reference import work as W
from portbench.reference.adam import Adam

BETA1 = 0.9
READ_STEPS = 3
SYNC_EVERY = 16       # a loss read late every SYNC_EVERY steps
AHEAD_STEPS = 4096    # the most steps queued past the oldest unread loss


def make(config: dict, traffic: dict, seed: int, device):
    return FitCell(config, traffic, seed, device)


def loss_of(fb, target, target_a, w_sil: float):
    """RGB MSE plus w_sil (1 - IoU) of the soft alpha (the inverse-render
    example's loss, unquantised)."""
    loss = torch.mean(((fb.rgb - target) / 255.0) ** 2)
    if w_sil:
        inter = torch.sum(fb.alpha * target_a)
        union = torch.sum(fb.alpha + target_a - fb.alpha * target_a)
        loss = loss + w_sil * (1.0 - inter / torch.clamp(union, min=1e-6))
    return loss


class LateLosses:
    """Every k-th loss, copied into pinned host memory behind an event and
    read once the event is done: the host never waits on a loss it has
    just queued."""

    def __init__(self, device: torch.device, slots: int):
        cuda = device.type == "cuda"
        self.cuda = cuda
        self.host = torch.empty(slots, dtype=torch.float32, pin_memory=cuda)
        self.pending = collections.deque()      # (event, slot, steps)
        self.steps = 0                          # steps behind the pending losses
        self.next = 0

    def queue(self, loss: torch.Tensor, steps: int) -> None:
        slot = self.next % self.host.shape[0]
        self.next += 1
        self.host[slot].copy_(loss, non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        self.pending.append((event, slot, steps))
        self.steps += steps

    def ready(self) -> bool:
        return bool(self.pending) and (self.pending[0][0] is None or self.pending[0][0].query())

    def pop(self) -> tuple:
        """(the oldest loss, its batch's steps), waiting for it if need be."""
        event, slot, steps = self.pending.popleft()
        self.steps -= steps
        if event is not None:
            event.synchronize()
        return float(self.host[slot]), steps


def fed_loop(step, k: int, ahead: int, device, seconds=None, units=None, spans=None,
             clock=time.perf_counter, wait=None) -> dict:
    """Steps in batches of k until `seconds` have passed or `units` steps
    are queued; the batch's last loss is read late (LateLosses), and the
    host waits only while more than `ahead` steps are queued past the
    oldest unread loss. At the close it waits for the device (`wait`, by
    default a synchronise) and reads the clock after that wait: every
    queued step counts, over all of that time. A batch whose loss is not
    finite counts as failed."""
    device = torch.device(device)
    spans = spans or (lambda name: contextlib.nullcontext())
    if wait is None:
        wait = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    losses = LateLosses(device, ahead // k + 2)
    n = failed = 0

    def read():
        nonlocal failed
        value, steps = losses.pop()
        if not math.isfinite(value):
            failed += steps

    t0 = clock()
    while True:
        for _ in range(k):
            with spans("step"):
                loss = step()
        losses.queue(loss, k)
        n += k
        while losses.ready() or losses.steps > ahead:
            with spans("read"):
                read()
        if (units is not None and n >= units) or (units is None and clock() - t0 >= seconds):
            break
    with spans("wait"):
        wait()
    t = clock()
    while losses.pending:
        read()
    return {"units": n, "seconds": t - t0, "failed": failed}


class FitCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.cfg = common.ref_config(config, traffic)
        self.device = torch.device(device)
        self.tau = float(traffic["tau"])
        self.w_sil = float(traffic.get("w_sil", 0.0)) if traffic["loss"] == "rgb_iou" else 0.0
        sc = config["scene"]
        true = scenes.random_scene(sc["n_spheres"], sc["n_planes"], self.cfg.max_spheres,
                                   self.cfg.max_planes, traffic.get("scene_seed", seed),
                                   sc["spread"])
        start = scenes.perturb_centres(scenes.copy(true), float(config["perturb"]),
                                       np.random.default_rng(traffic.get("perturb_seed", seed)))
        self.true, self.start = true, start
        self.pos, self.rot = rcam.default_pose()
        opt = traffic["optimizer"]
        names = [f"{g}.{f}" for g in ("spheres", "planes") for f in true[g]]
        names += ["camera.pos", "camera.rot"]
        self.trained = names if opt["trained"] == "all" else list(opt["trained"])
        self.lr = float(opt["lr"])

    # -- the system under test -------------------------------------------------

    def setup(self) -> None:
        cuda = self.device.type == "cuda"
        if cuda:                       # the context is the program's set-up
            torch.zeros(1, device=self.device)
            torch.cuda.synchronize()
        t = [time.perf_counter()]
        lv = soft.leaves(self.true, self.pos, self.rot, self.device, torch.float32, ())
        self.target, self.target_a = soft.render(lv, self.cfg, self.tau, self.cfg.shadows)
        del lv
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t.append(time.perf_counter())
        self.reference_s = t[1] - t[0]
        self._build()
        p0 = {k: v.detach().clone() for k, v in self.leaves.items()}
        float(self.step())             # an eager step, then the capture
        t.append(time.perf_counter())
        self._restart(p0)
        self.readings = self._read_steps()
        for _ in range(int(self.traffic["warm_steps"])):
            loss = self.step()
        float(loss)
        t.append(time.perf_counter())
        self.setup_split = {"reference_s": self.reference_s, "first_call_s": t[2] - t[1],
                            "steps_s": t[3] - t[2]}

    def _restart(self, p0: dict) -> None:
        """The start back in the leaves, the optimiser's state as a fresh
        one's (zeros, in place: a capture holds its storage) and every
        .grad zeroed, so the steps that follow read only what they write."""
        with torch.no_grad():
            for k, v in self.leaves.items():
                v.copy_(p0[k])
            for st in self.opt.state.values():
                for v in st.values():
                    v.zero_()
        self.opt.zero_grad(set_to_none=False)

    def _build(self) -> None:
        from rtwc_tpu_torch.camera import Camera
        from rtwc_tpu_torch.render.soft_kernel import (render_frame_soft_kernel,
                                                       render_soft_mse_loss)
        from rtwc_tpu_torch.render.step_graph import CapturedStep, card_adam
        from rtwc_tpu_torch.scene import Planes, Scene, Spheres

        dev = self.device
        pcfg = common.port_config(self.config, self.traffic)
        leaves = {}
        for g in ("spheres", "planes"):
            for f, v in self.start[g].items():
                leaves[f"{g}.{f}"] = torch.from_numpy(np.array(v, np.float32)).to(dev)
        leaves["camera.pos"] = torch.from_numpy(self.pos.copy()).to(dev)
        leaves["camera.rot"] = torch.from_numpy(self.rot.copy()).to(dev)
        for k in self.trained:
            leaves[k].requires_grad_(True)
        self.leaves = leaves
        params = [leaves[k] for k in self.trained]
        kind = self.traffic["optimizer"]["kind"]
        extra = card_adam(params) if kind == "card_adam" else {}
        self.opt = torch.optim.Adam(params, lr=self.lr, **extra)
        target, target_a, tau, w_sil = self.target, self.target_a, self.tau, self.w_sil

        def rebuild():
            sp = Spheres(**{f: leaves[f"spheres.{f}"] for f in self.start["spheres"]})
            pl = Planes(**{f: leaves[f"planes.{f}"] for f in self.start["planes"]})
            return Scene(spheres=sp, planes=pl), Camera(pos=leaves["camera.pos"],
                                                        rot=leaves["camera.rot"])

        if self.traffic["loss"] == "mse_fused":
            def loss_fn():
                return render_soft_mse_loss(*rebuild(), target, pcfg, tau=tau)
        else:
            def loss_fn():
                return loss_of(render_frame_soft_kernel(*rebuild(), pcfg, tau=tau), target,
                               target_a, w_sil)
        self.step = CapturedStep(loss_fn, self.opt)

    def _read_steps(self) -> dict:
        """The first READ_STEPS steps through the window's own call: the
        trained leaves before each step and after the last, each step's
        loss, and each step's gradient as the optimiser got it (from Adam's
        first moment: m_k = beta1 m_(k-1) + (1 - beta1) g_k)."""
        def values():
            return {k: self.leaves[k].detach().clone() for k in self.trained}

        def moments():
            out = {}
            for k in self.trained:
                st = self.opt.state.get(self.leaves[k], {})
                out[k] = st["exp_avg"].detach().clone() if "exp_avg" in st \
                    else torch.zeros_like(self.leaves[k].detach())
            return out

        points, losses, grads = [values()], [], []
        m_prev = {k: torch.zeros_like(v) for k, v in points[0].items()}
        for _ in range(READ_STEPS):
            losses.append(float(self.step()))
            m = moments()
            grads.append({k: (m[k] - BETA1 * m_prev[k]) / (1.0 - BETA1) for k in m})
            m_prev = m
            points.append(values())
        return {"points": points, "loss": losses, "grads": grads}

    def window(self, seconds: float | None = None, units: int | None = None, spans=None) -> dict:
        return fed_loop(self.step, SYNC_EVERY, AHEAD_STEPS, self.device, seconds, units, spans)

    def end_to_end(self, raw: dict) -> dict:
        return {"train_rays_per_s": self.cfg.width * self.cfg.height * raw["units"] / raw["seconds"]}

    def release(self) -> None:
        for name in ("step", "opt", "leaves"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------

    def _loss_and_grads(self, lv: dict, dtype) -> tuple:
        loss, grads = soft.loss_and_grads(lv, self.trained, self.cfg, self.tau, self.cfg.shadows,
                                          self.target.to(dtype), self.target_a.to(dtype),
                                          self.w_sil)
        return loss, {k: (g if g is not None else torch.zeros_like(lv[k])) for k, g in
                      grads.items()}

    def reference_at(self, points: list) -> dict:
        """The float32 reference at the program's leaves before each step:
        the loss, the gradient, and the change that its own Adam, stepped
        on its own gradients, makes over the steps."""
        lv = soft.leaves(self.start, self.pos, self.rot, self.device, torch.float32, ())
        losses, grads = [], []
        for pt in points[:READ_STEPS]:
            for k in self.trained:
                lv[k] = pt[k].detach().to(self.device, torch.float32).clone().requires_grad_(True)
            loss, g = self._loss_and_grads(lv, torch.float32)
            losses.append(loss)
            grads.append(g)
        change = {k: torch.zeros_like(v) for k, v in grads[0].items()}
        adam = Adam(change, self.lr)          # from zeros: it sums the updates
        for g in grads:
            adam.step(g)
        return {"loss": losses, "grads": grads, "change": change}

    def trajectory(self, dtype) -> dict:
        """The reference's own READ_STEPS steps from the start in `dtype`,
        in the form of the program's readings (the control)."""
        lv = soft.leaves(self.start, self.pos, self.rot, self.device, dtype, self.trained)
        adam = Adam({k: lv[k] for k in self.trained}, self.lr)

        def values():
            return {k: lv[k].detach().float().clone() for k in self.trained}
        points, losses, grads = [values()], [], []
        for _ in range(READ_STEPS):
            loss, g = self._loss_and_grads(lv, dtype)
            losses.append(float(loss))
            grads.append({k: v.float() for k, v in g.items()})
            adam.step(g)
            points.append(values())
        return {"points": points, "loss": losses, "grads": grads}

    def compare(self, prog: dict) -> list:
        """Each step's loss and gradient against the reference's at the
        same leaves, and the change over the steps against the reference's
        Adam's: the worst step, the worst kept leaf."""
        ref = self.reference_at(prog["points"])
        keep = common.kept_leaves(ref["grads"][0])
        loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
        grad_gap = max(common.norm_gaps(p, r, keep) for p, r in zip(prog["grads"], ref["grads"]))
        change = {k: prog["points"][-1][k] - prog["points"][0][k] for k in self.trained}
        lim = self.traffic["limits"]
        return [("loss_gap", loss_gap, lim["loss_gap"]),
                ("grad_gap", grad_gap, lim["grad_gap"]),
                ("move_gap", common.norm_gaps(change, ref["change"], keep), lim["move_gap"])]

    def check(self) -> list:
        return self.compare(self.readings)

    def control(self, dtype=torch.bfloat16) -> list:
        """The reference in `dtype` put in the program's place."""
        return self.compare(self.trajectory(dtype))

    def work(self) -> dict:
        """The frozen work count of the cell's fused or backward kernel at the start."""
        cfg, dev = self.cfg, self.device
        lv = soft.leaves(self.start, self.pos, self.rot, dev, torch.float32, ())
        right, up, fwd = rcam.basis(torch.from_numpy(self.rot).to(dev))
        cols = tuple(torch.stack([right[i], up[i], fwd[i]]) for i in range(3))
        e1, e2 = rcam.projection_elements(cfg)
        sp = lv
        lists = broad.sphere_lists(sp["spheres.center"], sp["spheres.radius"],
                                   sp["spheres.active"], sp["camera.pos"], cols, cfg, e1, e2,
                                   tau=self.tau, hard=False)
        gates = soft.needed_gates(lv, cfg, self.tau, lists)
        ns, n_pl = cfg.max_spheres, cfg.max_planes
        npl = scenes.n_live(self.start["planes"])
        ti, tj = broad.grid(cfg.height, cfg.width)
        T, px = ti * tj, ti * tj * broad.TILE * broad.TILE
        tables = 4 * (8 * ns + 12 * n_pl + 16)
        if cfg.shadows:
            shl = torch.zeros((T, 1, ns + 1), dtype=torch.int32, device=dev)
            counts = torch.stack([gates[:, 0].sum(1), torch.zeros_like(gates[:, 0, 0])], 1)
            return {"soft_sh_mse": W.k6_work(tables, T, 4 * 3 * px, lists, gates, shl, counts,
                                             ns, npl)}
        return {"soft_bwd": W.k2_work(tables, T, px, lists, gates, ns, npl)}
