"""Traffic kind `console_frame`: a closed loop of the console engine's frames.

The engine (`Engine.run_frame`: input, camera, physics, render, heads,
the D2H copy, the encode of the previous frame, the 1 Hz spawn) runs on
the harness's scene with the headless sink and a scripted input handler:
a closed path of held keys, one every `switch_s` seconds (where it starts
is drawn from the seed), and a mouse yaw of `yaw_px` a frame whose sign
goes with the key. The harness records, frame by frame, the
time step the engine measured, the keys and mouse deltas it handed the
engine and the frames at which the engine spawned; the sink records when
each frame was published and keeps a sample of the published frames,
drawn from the seed.

Correctness: the reference replays the physics and the spawns from the
same seed and time steps, moves its own camera by the same keys, renders
each sampled frame (supersampled, shadowed), downsamples it, takes the
mode's cells and compares them with the cells decoded from the frame's
published bytes.

Traffic keys: render (constants replaced, and the display mode, which the
configuration leaves to its traffic), engine_seed, input
{switch_s, path, yaw_px}, warm_frames, trace_units, check_frames, limits.
The engine keeps its defaults otherwise (the 1 Hz spawn, a pool of
max_spheres that a window's spawns never fill).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.drivers import common
from portbench.reference import broad, encode, heads, scenes
from portbench.reference import camera as rcam
from portbench.reference import hard
from portbench.reference import work as W


def make(config: dict, traffic: dict, seed: int, device):
    return ConsoleCell(config, traffic, seed, device)


class _Recorder:
    """The frame-by-frame inputs the engine was given."""

    def __init__(self):
        self.dt, self.keys, self.rot, self.spawns = [], [], [], set()


class ScriptedInput:
    """The engine's input handler: held keys along a closed path, one key
    every switch_s seconds from a start the seed picks, and a mouse yaw of
    yaw_px a frame whose sign goes with the key (+ on even steps of the
    path, - on odd ones), so every start covers the same views."""

    def __init__(self, spec: dict, seed: int, recorder: _Recorder):
        self.path = list(spec["path"])
        self.first = int(np.random.default_rng([seed, 7]).integers(len(self.path)))
        self.switch_s, self.yaw = float(spec["switch_s"]), float(spec["yaw_px"])
        self.rec, self.engine, self._t0 = recorder, None, None

    def start(self) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def poll(self):
        from rtwc_tpu_torch.camera import Keys
        from rtwc_tpu_torch.io.input import InputState

        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        step = (self.first + int((now - self._t0) / self.switch_s)) % len(self.path)
        key = self.path[step]
        dy = self.yaw if step % 2 == 0 else -self.yaw
        self.rec.dt.append(self.engine.timer.delta_time)
        self.rec.keys.append(key)
        self.rec.rot.append((0.0, dy))
        return InputState(keys=Keys(**{key: 1}), rot_delta=(0.0, dy), mode=None, quit=False)


class _Sink:
    """The headless sink, timing each publication and keeping a sample."""

    def __new__(cls, keep: int, seed: int):
        from rtwc_tpu_torch.io.sink import FramebufferSink

        class Sink(FramebufferSink):
            def __init__(self):
                super().__init__(keep_all=False)
                self.times, self.kept, self.counting, self.empty = [], {}, False, 0
                self.n = 0
                self._rng = np.random.default_rng([seed, 11])
                self._seen = 0

            def set_data_in_back_buffer(self, frame: bytes) -> None:
                self.times.append(time.perf_counter())
                if self.counting:      # reservoir sample of the window's frames
                    self._seen += 1
                    self.empty += not frame
                    if len(self.kept) < keep:
                        self.kept[self.n] = frame
                    else:
                        j = int(self._rng.integers(self._seen))
                        if j < keep:
                            del self.kept[sorted(self.kept)[j]]
                            self.kept[self.n] = frame
                self.n += 1
                super().set_data_in_back_buffer(frame)

        return Sink()


class ConsoleCell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.cfg = common.ref_config(config, traffic)
        self.device = torch.device(device)
        self.engine_seed = int(traffic.get("engine_seed", seed))
        self.scene0 = scenes.default_scene(self.cfg.max_spheres, self.cfg.max_planes,
                                           self.engine_seed)
        self.rec = _Recorder()

    def setup(self) -> None:
        from rtwc_tpu_torch.camera import Camera
        from rtwc_tpu_torch.config import EngineConfig
        from rtwc_tpu_torch.engine import Engine

        pos, rot = rcam.default_pose()
        ecfg = EngineConfig(seed=self.engine_seed, show_fps=False, mouse=False)
        self.sink = _Sink(int(self.traffic["check_frames"]), self.seed)
        self.input = ScriptedInput(self.traffic["input"], self.seed, self.rec)
        eng = Engine(common.port_config(self.config, self.traffic), ecfg,
                     scene=common.port_scene(self.scene0, "cpu"),
                     camera=Camera(pos=torch.from_numpy(pos), rot=torch.from_numpy(rot)),
                     presenter=self.sink, input_handler=self.input, interactive=False,
                     device=self.device)
        self.input.engine = eng
        spawn, rec = eng._spawn, self.rec

        def recorded_spawn():
            rec.spawns.add(len(rec.dt) - 1)
            spawn()

        eng._spawn = recorded_spawn
        eng.start()
        self.engine = eng
        t0 = time.perf_counter()
        eng.run_frame()
        eng.run_frame()
        t1 = time.perf_counter()
        for _ in range(int(self.traffic["warm_frames"]) - 2):
            eng.run_frame()
        self.setup_split = {"first_frames_s": t1 - t0, "warm_frames_s": time.perf_counter() - t1}

    def window(self, seconds: float | None = None, units: int | None = None, spans=None) -> dict:
        eng, sink = self.engine, self.sink
        if spans is not None and spans.on:
            self._instrument(spans)
        first = sink.n
        sink.counting = True
        t0 = time.perf_counter()
        n = 0
        while True:
            with spans("frame"):
                eng.run_frame()
            n += 1
            t = time.perf_counter()
            if (units is not None and n >= units) or (units is None and t - t0 >= seconds):
                break
        sink.counting = False
        times = [x for x in sink.times[first:] if x <= t]
        return {"units": len(times), "seconds": t - t0, "failed": sink.empty,
                "times": [t0] + times}

    def _instrument(self, spans) -> None:
        """Spans around the engine's publish and its encode (traced runs only)."""
        import rtwc_tpu_torch.engine.engine as E

        eng, publish, enc = self.engine, self.engine._publish, E.encode_frame

        def timed_publish(frame):
            with spans("publish"):
                publish(frame)

        def timed_encode(*a):
            with spans("encode"):
                return enc(*a)

        eng._publish = timed_publish
        E.encode_frame = timed_encode
        self._restore = lambda: setattr(E, "encode_frame", enc)

    def end_to_end(self, raw: dict) -> dict:
        return {"frames_per_s": raw["units"] / raw["seconds"]}

    def release(self) -> None:
        if hasattr(self, "_restore"):
            self._restore()
        self.engine.flush()
        self.engine.cleanup()
        self.kept = dict(self.sink.kept)
        for name in ("engine", "sink", "input"):
            delattr(self, name)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------

    def _states(self, frames):
        """{frame: (scene, pos, rot)} of the given frames, replayed from the
        start: the camera moved by the recorded input, the physics ticked
        by the recorded time steps, the spawns drawn from the engine seed."""
        cfg, rec = self.cfg, self.rec
        scene = scenes.copy(self.scene0)
        pos, rot = rcam.default_pose()
        rng = np.random.default_rng(self.engine_seed)
        want, out = set(frames), {}
        for k in range(max(frames) + 1):
            dt = rec.dt[k]
            dp, dy = rec.rot[k]
            if dp or dy:
                rot = rcam.add_rot(rot, dp, dy, cfg.mouse_sensitivity)
            pos = rcam.move(pos, rot, {rec.keys[k]: 1}, dt, cfg.move_speed)
            scenes.update_scene(scene, np.float32(dt), cfg.bob_min_y, cfg.bob_max_y)
            if k in want:
                out[k] = (scenes.copy(scene), pos.copy(), rot.copy())
            if k in rec.spawns:
                if scenes.n_live(scene["spheres"]) >= scene["spheres"]["active"].shape[0]:
                    raise RuntimeError("the sphere pool filled: the replay does not grow it")
                scenes.spawn_random_sphere(scene, rng)
        return out

    def reference_cells(self, state, dtype=torch.float32):
        scene, pos, rot = state
        ss_cfg = hard.supersampled(self.cfg)
        fb = hard.render(scene, pos, rot, ss_cfg, self.device, dtype)
        fb = hard.downsample(fb, self.cfg.supersample)
        return tuple(x.cpu().numpy() for x in heads.cells(fb, self.cfg.mode, self.cfg.far))

    def _gaps(self, frames: dict, cells_of) -> tuple:
        """(worst frame's % of cells that differ, frames that do not decode)."""
        worst, bad = 0.0, 0
        states = self._states(list(frames))
        for k, got in frames.items():
            ref = cells_of(states[k])
            if got is None:
                bad += 1
                continue
            diff = (got[0] != ref[0]) | (got[2] != ref[2])
            c_got, c_ref = got[1], ref[1]
            diff |= (c_got != c_ref).any(-1) if c_got.ndim == 3 else (c_got != c_ref)
            worst = max(worst, 100.0 * float(diff.mean()))
        return worst, bad

    def check(self) -> list:
        H, W_ = self.cfg.height, self.cfg.width
        frames = {k: encode.decode(b, H, W_) for k, b in self.kept.items()}
        worst, bad = self._gaps(frames, self.reference_cells)
        lim = self.traffic["limits"]
        return [("cells_off_pct", worst, lim["cells_off_pct"]),
                ("bad_frames", float(bad), lim["bad_frames"])]

    def control(self, dtype=torch.bfloat16) -> list:
        """The reference in `dtype` put in the program's place: its cells,
        encoded and decoded, against the reference's."""
        H, W_ = self.cfg.height, self.cfg.width
        states = self._states(list(self.kept))
        frames = {k: encode.decode(encode.encode(*self.reference_cells(states[k], dtype)), H, W_)
                  for k in self.kept}
        worst, bad = self._gaps(frames, self.reference_cells)
        lim = self.traffic["limits"]
        return [("cells_off_pct", worst, lim["cells_off_pct"]),
                ("bad_frames", float(bad), lim["bad_frames"])]

    def work(self) -> dict:
        """The frozen work count of one hard render launch, averaged over the
        sampled frames."""
        cfg = hard.supersampled(self.cfg)
        states = self._states(list(self.kept))
        e1, e2 = rcam.projection_elements(cfg)
        ti, tj = broad.grid(cfg.height, cfg.width)
        tables = 4 * (8 * self.cfg.max_spheres + 12 * self.cfg.max_planes + 2 + 16)
        out_bytes = 4 * 8 * ti * tj * broad.TILE * broad.TILE
        total = [0.0, 0.0]
        for scene, pos, rot in states.values():
            right, up, fwd = rcam.basis(torch.from_numpy(rot))
            cols = tuple(torch.stack([right[i], up[i], fwd[i]]).to(self.device)
                         for i in range(3))
            sp = {k: torch.from_numpy(scene["spheres"][k]).to(self.device)
                  for k in ("center", "radius", "active")}
            lists = broad.sphere_lists(sp["center"], sp["radius"], sp["active"],
                                       torch.from_numpy(pos).to(self.device), cols, cfg, e1, e2)
            lit = hard.render(scene, pos, rot, cfg, self.device, shadows=False)
            shaded = hard.render(scene, pos, rot, cfg, self.device, shadows=True)
            n_sh = int((((shaded["rgb"] != lit["rgb"]).any(-1))
                        & (shaded["depth"] < hard.MISS)).sum())
            nb, ops = W.hard_work(tables, out_bytes, lists, scenes.n_live(scene["planes"]), n_sh)
            total[0] += nb
            total[1] += ops
        n = max(1, len(states))
        return {"hard_render": (total[0] / n, total[1] / n)}

