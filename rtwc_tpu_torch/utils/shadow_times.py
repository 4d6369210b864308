"""Device times of the shadowed kernels K4, K5 and K6 alone, at the bench
headline and at 4K/200, for one checkout of the port.

    python rtwc_tpu_torch/utils/shadow_times.py [--root DIR]

DIR is the root of the checkout whose `rtwc_tpu_torch` is timed (default:
the checkout that holds this file), for example an older commit unpacked
by `git archive` into the git-ignored `chip_work/`. Run it for each
checkout in turns, in one call, to compare two commits on one card. The
inputs are those of `chip_smoke.py` phase 5b: the bench headline
(1920x1080, `random_scene(20, max_spheres=20, max_planes=4, seed=0)`,
shadows, tau 0.5, 16x16 tiles) and 3840x2160 with `random_scene(200)`; at
both shapes K5 runs under the MSE cotangents of a zero target and K6
against that target. Each time is `chip_smoke.py`'s `_kernel_device_ms`
(the profiler's mean record) over 20 launches at the headline and 5 at 4K.
Before it times them, it holds K5's and K6's partial tables to their plain
versions' at the headline, bit for bit. Needs one CUDA card (exit 2
without one); prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))


def _case(SK, SH, cfg, scene, cam, dev):
    """(spec, sizes, K4's, K5's and K6's launch arguments) for one configuration."""
    import torch

    spec = SK.SoftSpec(cfg, 0.5)
    sph, pl, camv = SK._packed(scene.to(dev), cam.to(dev))
    lists, shl = SH.build_lists(sph, pl, camv, spec, True)
    offsets, pidx = SK.list_entries(lists)
    sh_offsets, pshidx = SK.list_entries(shl)
    sizes = dict(n_entries=pidx.shape[0], n_sh_entries=pshidx.shape[0])
    out, gates = SH.soft_sh_fwd(sph, pl, camv, lists, shl, spec=spec)
    g = torch.zeros_like(out)
    g[:3] = (2.0 / (255.0 ** 2 * 3 * cfg.width * cfg.height)) * out[:3]
    tgt = torch.zeros((3,) + spec.extent, device=dev)
    fwd = (sph, pl, camv, lists, shl)
    return (spec, sizes, fwd, fwd + (offsets, sh_offsets, gates, out, g),
            fwd + (offsets, sh_offsets, tgt))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=CHECKOUT)
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]  # run by path
    sys.path.insert(0, CHECKOUT)
    from chip_smoke import _card_line, _kernel_device_ms  # imports nothing of the port
    import torch

    if not torch.cuda.is_available():
        print("shadow_times: no CUDA device; the device times need a card", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
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
    cases = {"headline": (_case(SK, SH, RenderConfig(width=1920, height=1080, max_spheres=20,
                                                     **soft_kw),
                                random_scene(20, max_spheres=20, max_planes=4, seed=0), cam,
                                dev), 20),
             "4k200": (_case(SK, SH, RenderConfig(width=3840, height=2160, max_spheres=200,
                                                  **soft_kw),
                             random_scene(200, max_spheres=200, max_planes=4, seed=0), cam,
                             dev), 5)}

    spec, sizes, _, bwd, mse = cases["headline"][0]
    for what, kern, plain, a in (("K5", SH.soft_sh_bwd, SH.soft_sh_bwd_plain, bwd),
                                 ("K6", SH.soft_sh_mse, SH.soft_sh_mse_plain, mse)):
        got, want = kern(*a, spec=spec, **sizes), plain(*a, spec=spec, **sizes)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{what}'s partial tables differ from its plain version's")
    times = {}
    for label, ((spec, sizes, fwd, bwd, mse), reps) in cases.items():
        for key, kname, fn in (
                ("K4", "soft_sh_fwd_kernel", lambda: SH.soft_sh_fwd(*fwd, spec=spec)),
                ("K5", "soft_sh_bwd_kernel", lambda: SH.soft_sh_bwd(*bwd, spec=spec, **sizes)),
                ("K6", "soft_sh_mse_kernel", lambda: SH.soft_sh_mse(*mse, spec=spec, **sizes))):
            times[f"{key} {label}"] = _kernel_device_ms(fn, reps=reps, name=kname)
    print(json.dumps({"root": root, "card": card, "device_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
