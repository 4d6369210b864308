#!/usr/bin/env python3
"""Run the PyTorch port's display path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases (each prints its lines; any failure raises and exits non-zero):
  0  card name and power limit (nvidia-smi), torch and CUDA versions
  1  build csrc/hard_render.cu with nvcc for sm_90a, print build time and
     the ptxas register report
  2  the K7 kernel against its plain torch version on the card, on the
     same packed tables and broad-phase lists, in six cases; then one
     frame of the whole step (kernel path) against the plain reference
     renderer, cell by cell
  3  the engine with a FramebufferSink on the card: 400x150 in all five
     modes, a forced spawn with a capacity doubling, 1920x500 with 100
     spheres and 2x supersampling; the kernel's launch count must equal
     the frames rendered
  4  `python -m rtwc_tpu_torch` in a subprocess
  5  timings (CUDA events): kernel vs plain, broad phase, engine frames/s
     and rays/s, and a per-frame host breakdown
Then a JSON line describing the kernel, and as the last line
{"ok": true, "device": {...}}. Imports nothing of JAX. Longer tables go
to chip_smoke_out/.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")
FB_ATOL, FB_RTOL, HIT_FRAC_MAX, CELL_FRAC_MIN = 2e-3, 1e-4, 0.005, 0.995


def _card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def _compare_fb(ref, ker, label):
    """hit masks differ on < 0.5 % of pixels; on pixels both call a hit,
    rgb / depth / normal / shading allclose(atol=2e-3, rtol=1e-4)."""
    import torch

    frac = (ref.hit != ker.hit).float().mean().item()
    both = ref.hit & ker.hit
    max_abs = 0.0
    bad = []
    for name in ("rgb", "depth", "normal", "shading"):
        a = getattr(ref, name)[both]
        b = getattr(ker, name)[both]
        if a.numel():
            max_abs = max(max_abs, (a - b).abs().max().item())
            if not torch.allclose(b, a, atol=FB_ATOL, rtol=FB_RTOL):
                n_bad = (~torch.isclose(b, a, atol=FB_ATOL, rtol=FB_RTOL)).sum().item()
                worst = (a - b).abs().reshape(a.shape[0], -1).amax(-1).topk(min(3, a.shape[0]))
                pix = both.nonzero()[worst.indices].tolist()
                bad.append(f"{name}: {n_bad} values outside tolerance, worst at (row, col) "
                           f"{pix}: plain {a[worst.indices].tolist()} "
                           f"kernel {b[worst.indices].tolist()}")
    print(f"phase 2: {label}: hit-mask mismatch {frac:.6f} (limit {HIT_FRAC_MAX}), "
          f"hits {int(both.sum().item())}, max abs diff on both-hit pixels {max_abs!r}")
    if frac >= HIT_FRAC_MAX or bad:
        raise AssertionError(f"{label}: kernel disagrees with plain version: "
                             f"hit mismatch {frac}, {bad}")
    return max_abs


def _time_ms(fn, reps=20, warm=3):
    """Median ms of fn() between CUDA events, after warm-up calls."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernel_device_ms(fn, reps=20):
    """Mean device time of the hard_render kernel over `reps` calls of fn,
    from the profiler's CUDA kernel records (None if it records none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and e.name.startswith("hard_render_kernel")]
    return sum(us) / len(us) / 1e3 if us else None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(OUT_DIR, exist_ok=True)

    # -- phase 0 ---------------------------------------------------------------
    card = _card_line()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"phase 0: {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from rtwc_tpu_torch.camera import Camera, default_camera
    from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.engine.engine import (
        _render_step, _start_download, resolve_device)
    from rtwc_tpu_torch.heads import encode_frame
    from rtwc_tpu_torch.io import FramebufferSink
    from rtwc_tpu_torch.render import _cuda, hard_kernel
    from rtwc_tpu_torch.render import pack as P
    from rtwc_tpu_torch.scene import default_scene, empty_scene, random_scene

    resolve_device(dev)

    # -- phase 1 ---------------------------------------------------------------
    t0 = time.perf_counter()
    so = _cuda.build("hard_render")
    hard_kernel._kernel_fn()
    print(f"phase 1: built {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds['hard_render']:.2f} s; {' '.join(_cuda.ARCH_FLAGS)})")
    with open(so[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print(f"phase 1: ptxas: {line.strip()}")

    # -- phase 2 ---------------------------------------------------------------
    base = RenderConfig(width=400, height=150)
    posed = Camera(pos=torch.tensor([3.0, 2.0, -5.0]), rot=torch.tensor([0.25, 2.8, 0.0]))
    cases = [
        ("a default 400x150", default_scene(base, device=dev), default_camera(), base),
        ("a default 400x150 shadows", default_scene(base, device=dev), default_camera(),
         base.replace(shadows=True)),
        ("b posed camera 400x150", default_scene(base, device=dev), posed, base),
        ("c random 20 1920x1080 shadows", random_scene(20, seed=0, device=dev),
         default_camera(), RenderConfig(width=1920, height=1080, shadows=True)),
        ("d random 200 3840x2160 shadows", random_scene(200, max_spheres=256, device=dev),
         default_camera(), RenderConfig(width=3840, height=2160, shadows=True)),
        ("e default 401x151 shadows", default_scene(base, device=dev), default_camera(),
         RenderConfig(width=401, height=151, shadows=True)),
        ("f empty 400x150", empty_scene(8, 2, device=dev), default_camera(), base),
    ]
    bh = bw = 16
    max_err = 0.0
    packed = {}
    for label, scene, cam, cfg in cases:
        sph, pl, counts = P.pack_scene(scene)
        camv = P.pack_camera(cam, dev)
        lists = hard_kernel.tile_lists(sph, camv, cfg, bh, bw)
        args = (sph, pl, counts.reshape(1, 2), camv, lists)
        ker = hard_kernel.hard_render_packed(*args, config=cfg, bh=bh, bw=bw)
        plain = hard_kernel.hard_render_plain(*args, config=cfg, bh=bh, bw=bw)
        torch.cuda.synchronize()
        fk = hard_kernel.planes_to_framebuffer(ker, cfg, cfg.height)
        fp = hard_kernel.planes_to_framebuffer(plain, cfg, cfg.height)
        if not (torch.isfinite(ker).all() and ker.shape == plain.shape):
            raise AssertionError(f"{label}: non-finite or misshapen kernel output")
        max_err = max(max_err, _compare_fb(fp, fk, label))
        if label.startswith("f"):
            if fk.hit.any() or (fk.rgb != 0).any():
                raise AssertionError("empty scene must render all background")
            print("phase 2: f empty scene renders all background")
        packed[label] = (args, cfg)

    # the whole step on the card: kernel path vs the plain reference renderer,
    # with and without camera pitch (the broad-phase cones must follow it)
    for cam_label, cam, scene_fn in (
            ("default camera", default_camera(), lambda c: default_scene(c, device=dev)),
            ("posed camera", posed, lambda c: default_scene(c, device=dev)),
            ("posed camera random 20", posed, lambda c: random_scene(20, seed=0, device=dev))):
        for mode in (RenderMode.RGB_ASCII, RenderMode.BIT_ASCII):
            cfg = base.replace(mode=mode, shadows=True)
            scene = scene_fn(cfg)
            _, (k1, c1, ch1) = _render_step(scene, cam, 0.02, cfg.replace(renderer="kernel"))
            _, (k2, c2, ch2) = _render_step(scene, cam, 0.02, cfg.replace(renderer="reference"))
            same = (k1 == k2) & (ch1 == ch2)
            same &= (c1 == c2).all(-1) if c1.dim() == 3 else (c1 == c2)
            frac = same.float().mean().item()
            print(f"phase 2: step {mode.value} 400x150 shadows, {cam_label}: cells equal to the "
                  f"reference renderer's on {frac:.6f} (limit {CELL_FRAC_MIN})")
            if frac < CELL_FRAC_MIN:
                raise AssertionError(f"{mode.value} {cam_label}: cells differ from the "
                                     f"reference renderer")

    # -- phase 3: the main path, counted ----------------------------------------
    hard_kernel.LAUNCHES = 0
    frames = 0

    def run_engine(rcfg, ecfg, n, scene=None, force_spawn=False):
        sink = FramebufferSink(keep_all=True)
        eng = Engine(rcfg, ecfg, scene=scene, presenter=sink, interactive=False, device=dev)
        if force_spawn:
            eng.telemetry.interval = 0.0
        eng.run(max_frames=n)
        if len(sink.frames) != n:
            raise AssertionError(f"{rcfg.width}x{rcfg.height}: {len(sink.frames)} frames of {n}")
        for fr in sink.frames:
            rows = fr.count(b"\n")
            if rows != rcfg.height:
                raise AssertionError(f"frame with {rows} rows, want {rcfg.height}")
            fam = (b";2;",) if rcfg.mode.value.startswith("rgb") else (b"\x1b[38;5;", b"\x1b[48;5;")
            if not any(f in fr for f in fam):
                raise AssertionError(f"{rcfg.mode.value}: no {fam} escape in a frame")
        return eng

    no_spawn = EngineConfig(spawn=False, show_fps=False, seed=1)
    for mode in (RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
                 RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS):
        run_engine(RenderConfig(width=400, height=150, mode=mode), no_spawn, 30)
        frames += 30
        print(f"phase 3: engine 400x150 {mode.value}: 30 frames, rows and escapes right")
    rcfg = RenderConfig(width=400, height=150, max_spheres=8)
    eng = Engine(rcfg, no_spawn, interactive=False, presenter=FramebufferSink(), device=dev)
    n0, cap0 = eng.scene.n_spheres, eng.scene.spheres.capacity
    eng = run_engine(rcfg, EngineConfig(spawn=True, show_fps=False, seed=1), 10,
                     force_spawn=True)
    frames += 10
    n1, cap1 = eng.scene.n_spheres, eng.scene.spheres.capacity
    print(f"phase 3: spawn: spheres {n0} -> {n1}, capacity {cap0} -> {cap1}")
    if not (n1 > n0 and cap1 > cap0):
        raise AssertionError("spawn did not grow the scene and its capacity")
    hi = RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII, supersample=2)
    run_engine(hi, no_spawn, 10, scene=random_scene(100, seed=0))
    frames += 10
    print("phase 3: engine 1920x500 rgb_ascii supersample 2, 100 spheres: 10 frames")
    launches = hard_kernel.LAUNCHES
    print(f"phase 3: K7 launches {launches}, frames rendered {frames}")
    if launches != frames:
        raise AssertionError(f"K7 launched {launches} times for {frames} frames")

    # -- phase 4 -----------------------------------------------------------------
    cmd = [sys.executable, "-m", "rtwc_tpu_torch", "--frames", "8", "--width", "400",
           "--height", "150", "--mode", "rgb_ascii", "--no-spawn", "--no-fps"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, timeout=300)
    print(f"phase 4: {' '.join(cmd[1:])}: exit {proc.returncode}, "
          f"{len(proc.stdout)} bytes of frames")
    if proc.returncode != 0 or b";2;" not in proc.stdout:
        raise AssertionError(f"CLI run failed: {proc.stderr.decode()[-2000:]}")

    # -- phase 5 -----------------------------------------------------------------
    tag = f"[{card}]"
    timing = {}
    for label in ("a default 400x150", "c random 20 1920x1080 shadows",
                  "d random 200 3840x2160 shadows"):
        args, cfg = packed[label]
        k_ms = _time_ms(lambda: hard_kernel.hard_render_packed(*args, config=cfg, bh=bh, bw=bw))
        p_ms = _time_ms(lambda: hard_kernel.hard_render_plain(*args, config=cfg, bh=bh, bw=bw))
        sph, _, _, camv, _ = args
        b_ms = _time_ms(lambda: hard_kernel.tile_lists(sph, camv, cfg, bh, bw))
        dev_ms = _kernel_device_ms(lambda: hard_kernel.hard_render_packed(
            *args, config=cfg, bh=bh, bw=bw))
        timing[label] = (k_ms, p_ms, b_ms, dev_ms)
        print(f"phase 5: {label}: K7 kernel {k_ms!r} ms (device time alone {dev_ms!r} ms), "
              f"plain {p_ms!r} ms, broad phase {b_ms!r} ms {tag}")

    def engine_rate(rcfg, scene, n=60, warm=5):
        eng = Engine(rcfg, no_spawn, scene=scene, presenter=FramebufferSink(),
                     interactive=False, device=dev)
        eng.start()
        for _ in range(warm):
            eng.run_frame()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            eng.run_frame()
        eng.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        eng.cleanup()
        fps = n / dt
        return fps, fps * rcfg.width * rcfg.height * rcfg.supersample ** 2

    rates = {}
    for label, rcfg, scene in (
            ("400x150 default scene rgb_ascii",
             RenderConfig(width=400, height=150, mode=RenderMode.RGB_ASCII), None),
            ("1920x500 100 spheres rgb_ascii",
             RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII),
             random_scene(100, seed=0)),
            ("1920x500 100 spheres rgb_ascii supersample 2", hi, random_scene(100, seed=0))):
        fps, rps = engine_rate(rcfg, scene)
        rates[label] = (fps, rps)
        print(f"phase 5: engine {label}: {fps!r} frames/s, {rps!r} rays/s {tag}")

    # per-frame host breakdown: enqueue of the device step, wait for the
    # frame's cells, encode
    for label, rcfg, scene_fn in (
            ("400x150", RenderConfig(width=400, height=150, mode=RenderMode.RGB_ASCII),
             lambda: default_scene(RenderConfig(), device=dev)),
            ("1920x500", RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII),
             lambda: random_scene(100, seed=0, device=dev))):
        scene, cam = scene_fn(), default_camera()
        parts = {"enqueue": [], "wait": [], "encode": []}
        prev = None
        for i in range(45):
            t0 = time.perf_counter()
            scene, cells = _render_step(scene, cam, 0.016, rcfg)
            cur = _start_download(cells)
            t1 = time.perf_counter()
            if prev is not None:
                prev[1].synchronize()
                t2 = time.perf_counter()
                encode_frame(*(c.numpy() for c in prev[0]))
                t3 = time.perf_counter()
                if i >= 5:
                    parts["enqueue"].append(t1 - t0)
                    parts["wait"].append(t2 - t1)
                    parts["encode"].append(t3 - t2)
            prev = cur
        med = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
        print(f"phase 5: frame breakdown {label}: host enqueue {med['enqueue']!r} ms, "
              f"wait for cells {med['wait']!r} ms, encode {med['encode']!r} ms {tag}")

    # device busy share over a steady window of engine frames
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, rcfg, scene in (("400x150", RenderConfig(width=400, height=150,
                                                          mode=RenderMode.RGB_ASCII), None),
                               ("1920x500", RenderConfig(width=1920, height=500,
                                                         mode=RenderMode.RGB_ASCII),
                                random_scene(100, seed=0))):
        eng = Engine(rcfg, no_spawn, scene=scene, presenter=FramebufferSink(),
                     interactive=False, device=dev)
        eng.start()
        for _ in range(5):
            eng.run_frame()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                eng.run_frame()
            eng.flush()
            torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
        eng.cleanup()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kern)
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)
        with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by="cpu_time_total", row_limit=60))
            f.write("\n".join(f"{us / 20:10.1f} us/frame  {n}" for n, us in top))
        print(f"phase 5: profile {label}, 20 frames: {len(kern)} kernel records, device busy "
              f"{busy_us / wall_us!r} of {wall_us / 20 / 1e3!r} ms per frame "
              f"(profiler on) {tag}")
        print("phase 5: top device time: " + "; ".join(
            f"{n[:48]} {us / 20:.1f} us/frame" for n, us in top[:6]))

    kc, pc, _, kdev = timing["c random 20 1920x1080 shadows"]
    print(json.dumps({"kernels": [{
        "name": "hard_render (K7, hard display forward)",
        "route": "cuda",
        "source": "rtwc_tpu_torch/csrc/hard_render.cu",
        "replaces": "rtwc_tpu/render/pallas_kernel.py:290",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kc,
        "plain_ms": pc,
        "device_ms": kdev,
        "shape": "1920x1080, random_scene(20), shadows, 16x16 tiles",
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
