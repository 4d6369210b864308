"""Device times of the port's kernels alone, for one checkout: K7 (the hard
display forward) at five shapes, K1, K2 and K3 at 1080p, the shadowed K4,
K4-stats, K5 and K6 at the bench headline and at 4K/200, and the gradient
reduction's whole function against its library calls at three shapes.

    python rtwc_tpu_torch/utils/shadow_times.py [--root DIR]

DIR is the root of the checkout whose `rtwc_tpu_torch` is timed (default:
the checkout that holds this file), for example an older commit unpacked
by `git archive` into the git-ignored `chip_work/`. Run it for each
checkout in turns, in one call, to compare two commits on one card. The
inputs are those of `chip_smoke.py` phases 5 and 5b: the bench headline
(1920x1080, `random_scene(20, max_spheres=20, max_planes=4, seed=0)`,
shadows, tau 0.5, 16x16 tiles) and 3840x2160 with `random_scene(200)`; at
both shapes K5 runs under the MSE cotangents of a zero target and K6
against that target. K7 runs on `chip_smoke.py` phase 2's packed tables
and 16x16 broad-phase lists: 400x150 `default_scene`, 1920x1080
`random_scene(20)` with shadows, 3840x2160 `random_scene(200)` with
shadows, and the engine's 1920x500 supersampled twice (3840x1000,
`random_scene(100)`) without and with shadows; where the checkout's
`hard_kernel` has a shadow cull, it also reports `chip_smoke._cull_stats`:
the occluders a warp's cull admits (mean, most) and the warps that take
the full sweep. K1, K2 and K3 run at 1920x1080 on the first step of
the `--spheres 20` fit: `examples.inverse_render`'s layout with its centres
moved as `chip_smoke._fit_start` moves them, against the layout's own
tau-0.5 render, so K2's and K3's MSE cotangents are a training step's.
Each kernel has two times: `device_ms`, `chip_smoke.py`'s
`_kernel_device_ms` (the profiler's mean record over 20 launches, 5 at
4K), and `graph_ms`, `chip_smoke.py`'s `_graph_ms` (CUDA events around a
CUDA graph of 20 calls of the wrapper, the median of 5 replays), which no
stray profiler record can move. The reduction runs on K2's partials at
1080p, K5's at the headline and K6's at 4K/200; its time and its library
calls' (float64 `index_add_` and sums, held to its sums first) are
`_graph_ms`; its five kernels' shares are `_kernel_device_ms` a call. It
reports whether K7's planes, K1's planes and gates, K2's, K3's, K5's and
K6's partial tables, K4's planes and gates, K4-stats' counts and the
reduction's tables equal their plain versions', bit for bit, on these
inputs; a digest (sha256, first 16 hex digits) of K7's and K1's outputs,
so that two checkouts can be compared bit for bit; and the registers and
spill stores of the checkout's K7 and soft kernels
(`chip_smoke._ptxas_report` on its `_build/lib*.log`). It also times the
shadowed fused train step (`bench.train_step`, Adam on every leaf) at the
headline and at 4K/200 as host ms a step (`chip_smoke._step_ms`), eagerly
and, where the checkout has them, replayed as a CUDA graph
(render/step_graph.py), with the list kernel's device time
(`tile_lists_kernel`, `entry_tables_kernel`). A checkout from before the
entry tables (`list_entries`, partial tables sized by the entry count) is
driven through the same calls by `_entries`. Needs one CUDA card (exit 2
without one); prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
REDUCE_KERNELS = tuple(f"soft_grad_reduce_{k}"
                       for k in ("count", "prefix", "scatter", "spheres", "final"))


def _entries(SK, lists, shl=None):
    """(offsets, pidx, sh_offsets, pshidx, counts, sizes) of the checkout's
    soft kernels: its entry tables and their device counts (sizes {}), or,
    in a checkout from before them, the masked compaction with counts None
    and the entry counts the wrappers took (sizes)."""
    if hasattr(SK, "entry_tables"):
        return tuple(SK.entry_tables(lists, shl)) + ({},)
    offsets, pidx = SK.list_entries(lists)
    sizes = dict(n_entries=pidx.shape[0])
    if shl is None:
        return offsets, pidx, None, None, None, sizes
    sh_offsets, pshidx = SK.list_entries(shl)
    return offsets, pidx, sh_offsets, pshidx, None, dict(sizes, n_sh_entries=pshidx.shape[0])


def _real(t, counts, which):
    """The real entries of a capacity-sized table (all of a compact one)."""
    return t if counts is None else t[:int(counts[which])]


def _case(SK, SH, cfg, scene, cam, dev):
    """(spec, sizes, K4's, K5's and K6's launch arguments, pidx, pshidx,
    counts) for one shadowed configuration."""
    import torch

    spec = SK.SoftSpec(cfg, 0.5)
    sph, pl, camv = SK._packed(scene.to(dev), cam.to(dev))
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    offsets, pidx, sh_offsets, pshidx, counts, sizes = _entries(SK, lists, shl)
    out, gates = SH.soft_sh_fwd(sph, pl, camv, lists, shl, spec=spec)
    g = torch.zeros_like(out)
    g[:3] = (2.0 / (255.0 ** 2 * 3 * cfg.width * cfg.height)) * out[:3]
    tgt = torch.zeros((3,) + spec.extent, device=dev)
    fwd = (sph, pl, camv, lists, shl)
    return (spec, sizes, fwd, fwd + (offsets, sh_offsets, gates, out, g),
            fwd + (offsets, sh_offsets, tgt), pidx, pshidx, counts)


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _k7_cases(HK, P, dev):
    """{label: (K7's launch arguments, config)} on the packed tables and
    16x16 lists of chip_smoke.py phase 2 (and the engine's 3840x1000)."""
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.scene import default_scene, random_scene

    base = RenderConfig(width=400, height=150)
    shapes = {
        "400x150": (default_scene(base, device=dev), base),
        "1080p/20 shadows": (random_scene(20, seed=0, device=dev),
                             RenderConfig(width=1920, height=1080, shadows=True)),
        "4K/200 shadows": (random_scene(200, max_spheres=256, device=dev),
                           RenderConfig(width=3840, height=2160, shadows=True)),
        "3840x1000/100": (random_scene(100, seed=0, device=dev),
                          RenderConfig(width=3840, height=1000)),
        "3840x1000/100 shadows": (random_scene(100, seed=0, device=dev),
                                  RenderConfig(width=3840, height=1000, shadows=True)),
    }
    cases = {}
    for label, (scene, cfg) in shapes.items():
        sph, pl, counts = P.pack_scene(scene)
        camv = P.pack_camera(default_camera(), dev)
        lists = HK.tile_lists(sph, camv, cfg, 16, 16)
        cases[label] = ((sph, pl, counts.reshape(1, 2), camv, lists), cfg)
    return cases


def _unshadowed(SK, IR, cam, dev, fit_start):
    """(spec, sizes, K2's and K3's launch arguments, pidx, counts) at 1920x1080 on the
    first step of the --spheres 20 fit: its starting centres against the
    layout's own render (chip_smoke.py phase 5)."""
    import torch

    cfg, scene = IR.build(1920, 1080, 20)
    spec = SK.SoftSpec(cfg, 0.5)
    scene, cam = scene.to(dev), cam.to(dev)

    def render(sc):
        sph, pl, camv = SK._packed(sc, cam)
        lists = SK.build_lists(sph, camv, spec, True)
        return (sph, pl, camv, lists) + tuple(SK.soft_fwd(sph, pl, camv, lists, spec=spec))

    tgt = torch.zeros((3,) + spec.extent, device=dev)
    tgt[:, :1080, :1920] = render(scene)[4][:3, :1080, :1920]
    sph, pl, camv, lists, out, gates = render(scene.replace(
        spheres=scene.spheres.replace(center=fit_start(scene.spheres.center))))
    offsets, pidx, _, _, counts, sizes = _entries(SK, lists)
    g = torch.zeros_like(out)
    g[:3] = (2.0 / (255.0 ** 2 * 3 * 1920 * 1080)) * (out[:3] - tgt)
    return (spec, sizes, (sph, pl, camv, lists, offsets, gates, out, g),
            (sph, pl, camv, lists, offsets, tgt), pidx, counts)


def _steps(torch, B, cfg_hl, cfg_4k, scenes, cam, dev, step_ms):
    """Host ms a shadowed fused train step at the headline and 4K/200,
    eager and, where the checkout has it, as a CUDA graph, in turns."""
    import inspect

    modes = ([False, True, True, False] if "graph" in inspect.signature(B.train_step).parameters
             else [None])
    out = {}
    for label, cfg, reps in (("headline", cfg_hl, 20), ("4k200", cfg_4k, 5)):
        tgt = torch.zeros((cfg.height, cfg.width, 3), device=dev)
        for graph in modes:
            kw = {} if graph is None else {"graph": graph}
            ms = step_ms(B.train_step(cfg, scenes[label].to(dev), cam.to(dev), tgt, **kw), reps)
            out.setdefault(label, {}).setdefault("graph" if graph else "eager", []).append(ms)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]  # run by path
    sys.path.insert(0, CHECKOUT)
    from chip_smoke import (_card_line, _cull_stats, _fit_start, _graph_ms, _kernel_device_ms,
                            _ptxas_report, _reduce_library, _reduce_library_ms,
                            _step_ms)  # import nothing of the port
    import torch

    if not torch.cuda.is_available():
        print("shadow_times: no CUDA device; the device times need a card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rtwc_tpu_torch import bench as B
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.examples import inverse_render as IR
    from rtwc_tpu_torch.render import hard_kernel as HK
    from rtwc_tpu_torch.render import pack as P
    from rtwc_tpu_torch.render import shadow_kernel as SH
    from rtwc_tpu_torch.render import soft_kernel as SK
    from rtwc_tpu_torch.scene import random_scene

    if os.path.commonpath([os.path.abspath(SH.__file__), root]) != root:
        raise RuntimeError(f"imported {SH.__file__}, not the checkout at {root}")
    card = _card_line()
    print(card)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    cam = default_camera()
    soft_kw = dict(soft_miss_penalty=300.0, soft_mask_k=10.0, max_planes=4, shadows=True)
    cfg_hl = RenderConfig(width=1920, height=1080, max_spheres=20, **soft_kw)
    cfg_4k = RenderConfig(width=3840, height=2160, max_spheres=200, **soft_kw)
    scenes = {"headline": random_scene(20, max_spheres=20, max_planes=4, seed=0),
              "4k200": random_scene(200, max_spheres=200, max_planes=4, seed=0)}
    cases = {"headline": (_case(SK, SH, cfg_hl, scenes["headline"], cam, dev), 20),
             "4k200": (_case(SK, SH, cfg_4k, scenes["4k200"], cam, dev), 5)}
    spec20, sizes20, bwd20, mse20, pidx20, counts20 = _unshadowed(SK, IR, cam, dev, _fit_start)

    spec, sizes, fwd, bwd, mse, _, _, _ = cases["headline"][0]
    fwd20 = bwd20[:4]
    bit_equal, digest, cull = {}, {}, {}
    k7 = _k7_cases(HK, P, dev)
    for label, (a, cfg) in k7.items():
        got = HK.hard_render_packed(*a, config=cfg, bh=16, bw=16)
        bit_equal[f"K7 {label}"] = torch.equal(got, HK.hard_render_plain(*a, config=cfg, bh=16,
                                                                          bw=16))
        digest[f"K7 {label}"] = _digest(got)
        if cfg.shadows and hasattr(HK, "shadow_occluders"):
            cull[label] = _cull_stats(HK, a, cfg)
    k1_out = SK.soft_fwd(*fwd20, spec=spec20)
    digest["K1 1080p"] = _digest(*k1_out)
    bit_equal["K1"] = all(torch.equal(x, y) for x, y in
                          zip(k1_out, SK.soft_fwd_plain(*fwd20, spec=spec20)))
    for what, kern, plain, a, kw in (
            ("K2", SK.soft_bwd, SK.soft_bwd_plain, bwd20, dict(spec=spec20, **sizes20)),
            ("K3", SK.soft_mse, SK.soft_mse_plain, mse20, dict(spec=spec20, **sizes20)),
            ("K4", SH.soft_sh_fwd, SH.soft_sh_fwd_plain, fwd, dict(spec=spec)),
            ("K4-stats", SH.soft_sh_stats, SH.soft_sh_stats_plain, fwd, dict(spec=spec)),
            ("K5", SH.soft_sh_bwd, SH.soft_sh_bwd_plain, bwd, dict(spec=spec, **sizes)),
            ("K6", SH.soft_sh_mse, SH.soft_sh_mse_plain, mse, dict(spec=spec, **sizes))):
        got, want = kern(*a, **kw), plain(*a, **kw)
        bit_equal[what] = all(torch.equal(x, y) for x, y in zip(got, want))
    calls = {f"K7 {label}": ("hard_render_kernel", 5 if label.startswith("4K") else 20,
                             (lambda a=a, cfg=cfg: HK.hard_render_packed(*a, config=cfg, bh=16,
                                                                         bw=16)))
             for label, (a, cfg) in k7.items()}
    calls["K1 1080p"] = ("soft_fwd_kernel", 20, lambda: SK.soft_fwd(*fwd20, spec=spec20))
    calls["K2 1080p"] = ("soft_bwd_kernel", 20,
                         lambda: SK.soft_bwd(*bwd20, spec=spec20, **sizes20))
    calls["K3 1080p"] = ("soft_mse_kernel", 20,
                         lambda: SK.soft_mse(*mse20, spec=spec20, **sizes20))
    if hasattr(SK, "entry_tables"):  # the list kernel and the entry tables
        from rtwc_tpu_torch.render import list_kernel as LK

        for label, ((spec_c, _, fwd_c, _, _, _, _, _), reps) in cases.items():
            sph_c, pl_c, cam_c, lists_c, shl_c = fwd_c
            calls[f"tile_lists {label}"] = (
                "tile_lists_kernel", reps,
                lambda s=spec_c, a=(sph_c, pl_c, cam_c): SH.build_lists(*a, s, True))
            calls[f"entry_tables {label}"] = (
                "entry_tables_kernel", reps,
                lambda a=(lists_c, shl_c): LK.entry_tables(*a))
    for label, ((spec_c, sizes_c, fwd_c, bwd_c, mse_c, _, _, _), reps) in cases.items():
        def bind(fn, a, **kw):
            return lambda: fn(*a, **kw)
        calls[f"K4 {label}"] = ("soft_sh_fwd_kernel", reps, bind(SH.soft_sh_fwd, fwd_c, spec=spec_c))
        if label == "headline":
            calls["K4-stats headline"] = ("soft_sh_fwd_kernel", reps,
                                          bind(SH.soft_sh_stats, fwd_c, spec=spec_c))
        calls[f"K5 {label}"] = ("soft_sh_bwd_kernel", reps,
                                bind(SH.soft_sh_bwd, bwd_c, spec=spec_c, **sizes_c))
        calls[f"K6 {label}"] = ("soft_sh_mse_kernel", reps,
                                bind(SH.soft_sh_mse, mse_c, spec=spec_c, **sizes_c))
    times, graph = {}, {}
    for key, (kname, reps, fn) in calls.items():
        times[key] = _kernel_device_ms(fn, reps=reps, name=kname)
        graph[key] = _graph_ms(fn)[0]

    # the reduction's whole function and its library calls, as CUDA graphs
    parts = SK.soft_bwd(*bwd20, spec=spec20, **sizes20)
    red_args = {"unshadowed 1080p": (parts[0], pidx20, parts[1], parts[2], 20, None, None,
                                     counts20)}
    for label, kern, key in (("shadowed headline", SH.soft_sh_bwd, "headline"),
                             ("4k200", SH.soft_sh_mse, "4k200")):
        spec, sizes, _, bwd, mse, pidx, pshidx, counts = cases[key][0]
        p = kern(*(bwd if kern is SH.soft_sh_bwd else mse), spec=spec, **sizes)
        red_args[label] = (p[0], pidx, p[2], p[3], spec.config.max_spheres, p[1], pshidx, counts)
    reduction = {}
    for label, (pvals, pidx, ppl, ptf, ns, psh, pshidx, counts) in red_args.items():
        kw = {} if counts is None else {"counts": counts}

        def port():
            return SK.soft_grad_reduce(pvals, pidx, ppl, ptf, ns, psh=psh, pshidx=pshidx, **kw)
        out = port()
        real = (_real(pvals, counts, 0), _real(pidx, counts, 0))
        real_sh = (None, None) if psh is None else (_real(psh, counts, 1),
                                                     _real(pshidx, counts, 1))
        n, nsh = real[1].shape[0], 0 if pshidx is None else real_sh[1].shape[0]
        want = SK.soft_grad_reduce_plain(real[0], real[1], ppl, ptf, ns, *real_sh)
        bit_equal[f"reduction {label}"] = all(torch.equal(x, y) for x, y in zip(out, want))
        args_l = real + (ppl, ptf, ns) + (() if psh is None else real_sh)
        _reduce_library_ms(P, args_l, out)  # holds the library calls to its sums
        lib_ms, lib_runs = _graph_ms(lambda: _reduce_library(*args_l))
        port_ms, port_runs = _graph_ms(port)
        reduction[label] = {"function_device_ms": port_ms, "replays": port_runs,
                            "library_device_ms": lib_ms, "library_replays": lib_runs,
                            "entries": n, "shadow_entries": nsh, "tiles": ppl.shape[0],
                            "per_kernel_ms": {k: _kernel_device_ms(port, name=k, per_call=True)
                                              for k in REDUCE_KERNELS}}
    steps = _steps(torch, B, cfg_hl, cfg_4k, scenes, cam, dev, _step_ms)
    regs = {}
    for lib in ("hard_render", "soft_render", "soft_shadow", "broad_phase"):
        if not os.path.exists(os.path.join(root, "rtwc_tpu_torch", "csrc", f"{lib}.cu")):
            continue
        for kernel, n_regs, spill in _ptxas_report(os.path.join(root, "rtwc_tpu_torch", "_build",
                                                                f"lib{lib}.log")):
            if "reduce" not in kernel:
                regs[kernel] = f"{n_regs} registers; {spill}"
    print(json.dumps({"root": root, "card": card, "bit_equal_to_plain": bit_equal,
                      "digest": digest, "device_ms": times, "graph_ms": graph,
                      "k7_shadow_cull": cull, "reduction": reduction, "step_ms": steps,
                      "ptxas": regs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
