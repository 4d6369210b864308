"""Device times of the broad phase's two kernels (csrc/broad_phase.cu:
`tile_lists_kernel`, `entry_tables_kernel`) and of what they cost a step,
for one checkout.

    python rtwc_tpu_torch/utils/list_times.py [--root DIR] [--split]

DIR is the root of the checkout whose `rtwc_tpu_torch` is timed (default:
the checkout that holds this file), for example an older commit unpacked
by `git archive` into the git-ignored `chip_work/`. Run it for each
checkout in turns, in one call, to compare two commits on one card.

The shapes are `chip_smoke.py`'s: the bench headline (1920x1080,
`random_scene(20, max_spheres=20, max_planes=4, seed=0)`, shadows, tau
0.5, 16x16 tiles) and 3840x2160 with `random_scene(200)`. At each it
reports the list kernel and the entry tables as the profiler's mean
device time a launch (`chip_smoke._kernel_device_ms`) and as a CUDA graph
of 20 calls of the wrapper (`chip_smoke._graph_ms`); the entry tables'
whole wrapper as a graph, with the allocation of the partial tables the
step hands the gradient kernels (in a checkout that zeroes them in the
entry-table launch: `list_kernel.partial_tables`); the fills of the step's
partial tables as a graph (`shadow_kernel._partials` as the checkout's
step calls it); the shadowed fused train step (`bench.train_step`, Adam
on every leaf, a zero target) replayed as a CUDA graph, host ms a step
(`chip_smoke._step_ms`) and device ms a step (the profiler's kernel
records over 10 replays), with its loss after 10 steps and a digest of
its parameters then; a replayed display frame at 1920x500 supersampled
twice with shadows (`random_scene(100)`); and the one-process sharded
step at the scaling entry point's defaults (`benchmarks.scaling.run_rank`,
20 iterations). Digests (sha256, first 16 hex digits) of the lists (each
row's count and listed entries), the aux planes and the entry tables
below their counts let two checkouts be compared bit for bit. With
--split it times instead the list kernel cut after each of its stages (the
`LIST_CUT` / `LIST_ROWS` defines of csrc/broad_phase.cu, each built by
nvcc into `_build/list_split/`, all at once), at both shapes, with each
variant's registers and spills. Needs one
CUDA card (exit 2 without one); prints the card's name and power limit,
then one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
# (LIST_CUT, LIST_ROWS) of the split: every stage with the rows stored (0:
# the prologue alone), then the stages that store rows without storing them
SPLIT = tuple((k, 1) for k in range(0, 8)) + tuple((k, 0) for k in range(3, 8))


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _listed(table):
    """A list table with -1 in every slot past its row's count: what any
    consumer reads (the card's kernel writes nothing there)."""
    import torch

    slot = torch.arange(table.shape[2], device=table.device)[None, None, :]
    return torch.where(slot <= table[:, :, :1], table, -1)


def _shapes(dev):
    """{label: (config, scene)} of the two shapes, the scenes on dev."""
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.scene import random_scene

    kw = dict(soft_miss_penalty=300.0, soft_mask_k=10.0, max_planes=4, shadows=True)
    return {"headline": (RenderConfig(width=1920, height=1080, max_spheres=20, **kw),
                         random_scene(20, max_spheres=20, max_planes=4, seed=0, device=dev)),
            "4k200": (RenderConfig(width=3840, height=2160, max_spheres=200, **kw),
                      random_scene(200, max_spheres=200, max_planes=4, seed=0, device=dev))}


def _build_split(root: str) -> dict:
    """{(cut, rows): library path}: csrc/broad_phase.cu of the checkout at
    root built once a variant of SPLIT, every nvcc at once."""
    from rtwc_tpu_torch.render import _cuda

    out_dir = os.path.join(root, "rtwc_tpu_torch", "_build", "list_split")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(root, "rtwc_tpu_torch", "csrc", "broad_phase.cu")
    procs = {}
    for cut, rows in SPLIT:
        so = os.path.join(out_dir, f"libbroad_phase_cut{cut}_rows{rows}.so")
        log = open(so[:-3] + ".log", "w")
        procs[(cut, rows)] = (so, log, subprocess.Popen(
            [_cuda.find_nvcc(), *_cuda.ARCH_FLAGS, *_cuda.NVCC_FLAGS, f"-DLIST_CUT={cut}",
             f"-DLIST_ROWS={rows}", "-o", so, src],
            stdout=log, stderr=subprocess.STDOUT))
    built = {}
    for key, (so, log, proc) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(log.name) as f:
                raise RuntimeError(f"nvcc failed for LIST_CUT={key[0]} LIST_ROWS={key[1]}:\n"
                                   f"{f.read()[-3000:]}")
        built[key] = so
    return built


def _same(a, b) -> bool:
    """Two nests of tensors, tuples and None, torch.equal leaf by leaf."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))


def _split(root, dev, card, graph_ms, kernel_ms, ptxas_report) -> dict:
    from rtwc_tpu_torch.render import _cuda
    from rtwc_tpu_torch.render import list_kernel as LK
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.camera import default_camera

    built = _build_split(root)
    calls = {}
    for label, (cfg, scene) in _shapes(dev).items():
        sph, pl, camv = SK._packed(scene, default_camera().to(dev))
        grid = (-(-cfg.height // 16), -(-cfg.width // 16))
        calls[label] = (lambda a=(sph.detach(), pl.detach(), camv.detach(), cfg, grid):
                        LK.tile_lists_with_aux(a[0], a[1], a[2], a[3], 0.5, 16, 16, a[4], True))
    full = {label: fn() for label, fn in calls.items()}
    rows = []
    for (cut, store), so in built.items():
        _cuda._libs["broad_phase"] = ctypes.CDLL(so)
        row = {"cut": cut, "rows_stored": bool(store),
               "ptxas": [list(r) for r in ptxas_report(so[:-3] + ".log")
                         if "tile_lists_kernel" in r[0]]}
        for label, fn in calls.items():
            reps = 20 if label == "headline" else 5
            row[f"{label}_device_ms"] = kernel_ms(fn, reps=reps, name="tile_lists_kernel")
            row[f"{label}_graph_ms"] = graph_ms(fn)[0]
            if (cut, store) == (7, 1):
                row[f"{label}_equals_the_library"] = _same(fn(), full[label])
        rows.append(row)
        print(f"list_times split: LIST_CUT={cut} LIST_ROWS={store}: "
              f"{ {k: v for k, v in row.items() if k.endswith('_ms')} } {card}", file=sys.stderr)
    _cuda._libs.pop("broad_phase", None)
    return {"split": rows}


def _device_ms_a_call(fn, reps: int) -> float:
    """Device ms a call of fn: the profiler's CUDA kernel records (and
    memsets) of `reps` calls, summed, over reps; the device-side markers of
    host ranges (user annotations) left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / reps / 1e3


def _times(dev, card, graph_ms, kernel_ms, step_ms, ptxas_report) -> dict:
    import torch
    from rtwc_tpu_torch import bench as B
    from rtwc_tpu_torch.benchmarks import scaling
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
    from rtwc_tpu_torch.engine import Engine
    from rtwc_tpu_torch.io import FramebufferSink
    from rtwc_tpu_torch.render import _cuda
    from rtwc_tpu_torch.render import list_kernel as LK
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.scene import random_scene

    zeroing = hasattr(LK, "partial_tables")  # the entry-table launch zeroes the partials
    cam = default_camera().to(dev)
    rec = {"zeroing_entry_tables": zeroing}
    for label, (cfg, scene) in _shapes(dev).items():
        reps = 20 if label == "headline" else 5
        spec = SK.SoftSpec(cfg, 0.5)
        sph, pl, camv = (t.detach() for t in SK._packed(scene, cam))
        lists, shl, aux = LK.tile_lists_with_aux(sph, pl, camv, cfg, 0.5, 16, 16, spec.grid, True)
        if zeroing:
            def entries():
                pvals, psh = LK.partial_tables(lists, shl)
                return LK.entry_tables(lists, shl, pvals, psh)

            def fills():
                return SH._partials(spec, sph, pl, lists, shl, *LK.partial_tables(lists, shl))
            tables = LK.partial_tables(lists, shl)

            def entry_kernel():
                return LK.entry_tables(lists, shl, *tables)
        else:
            def entries():
                return LK.entry_tables(lists, shl)
            entry_kernel = entries

            def fills():
                return SH._partials(spec, sph, pl, lists, shl)
        ent = entries()
        n, nsh = (int(x) for x in ent.counts)
        r = rec[label] = {"entries": n, "shadow_entries": nsh}
        r["digest_lists"] = _digest(*(_listed(t) for t in (lists, shl)), *aux)
        r["digest_entries"] = _digest(ent.offsets, ent.pidx[:n], ent.sh_offsets,
                                      ent.pshidx[:nsh], ent.counts)
        lists_fn = (lambda: LK.tile_lists_with_aux(sph, pl, camv, cfg, 0.5, 16, 16, spec.grid,
                                                     True))
        r["tile_lists_device_ms"] = kernel_ms(lists_fn, reps=reps, name="tile_lists_kernel")
        r["tile_lists_graph_ms"] = graph_ms(lists_fn)[0]
        r["entry_tables_device_ms"] = kernel_ms(entry_kernel, reps=reps,
                                                name="entry_tables_kernel")
        r["entry_tables_graph_ms"] = graph_ms(entry_kernel)[0]
        r["entry_wrapper_graph_ms"] = graph_ms(entries)[0]
        r["fills_graph_ms"] = graph_ms(fills)[0]
        step = B.train_step(cfg, scene, cam, torch.zeros((cfg.height, cfg.width, 3), device=dev),
                            graph=True)
        losses = [float(step()) for _ in range(10)]
        r["step_loss_10"] = losses[-1]
        r["step_params_digest_10"] = _digest(*step.opt.param_groups[0]["params"])
        r["step_graph_ms"] = [step_ms(step, reps) for _ in range(2)]
        r["step_device_ms"] = _device_ms_a_call(step, 10)
        print(f"list_times: {label}: {r} {card}", file=sys.stderr)
    hi_sh = RenderConfig(width=1920, height=500, mode=RenderMode.RGB_ASCII, supersample=2,
                         shadows=True)
    eng = Engine(hi_sh, EngineConfig(spawn=False, show_fps=False, seed=1),
                 scene=random_scene(100, seed=0), presenter=FramebufferSink(), interactive=False,
                 device=dev, graph=True)
    frame = (lambda: eng.device_frame(0.016))
    rec["display_frame_ms"] = [step_ms(frame, 20) for _ in range(2)]
    rec["display_frame_device_ms"] = _device_ms_a_call(frame, 10)
    sargs = scaling._parser().parse_args(["--iters", "20"])
    rec["sharded_step_ms"] = [scaling.run_rank(sargs, "cuda", graph=None)["ms_per_step"]
                              for _ in range(2)]
    _cuda.load("broad_phase")
    rec["ptxas"] = [list(r) for r in ptxas_report(_cuda.library_path("broad_phase")[:-3] +
                                                  ".log")]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]  # run by path
    sys.path.insert(0, CHECKOUT)
    from chip_smoke import (_card_line, _graph_ms, _kernel_device_ms, _ptxas_report,
                            _step_ms)  # import nothing of the port
    import torch

    if not torch.cuda.is_available():
        print("list_times: no CUDA device; the device times need a card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rtwc_tpu_torch.render import list_kernel as LK

    if os.path.commonpath([os.path.abspath(LK.__file__), root]) != root:
        raise RuntimeError(f"imported {LK.__file__}, not the checkout at {root}")
    card = _card_line()
    print(card)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    if args.split:
        rec = _split(root, dev, card, _graph_ms, _kernel_device_ms, _ptxas_report)
    else:
        rec = _times(dev, card, _graph_ms, _kernel_device_ms, _step_ms, _ptxas_report)
    print(json.dumps({"root": root, "card": card, **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
