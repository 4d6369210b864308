"""One rank of tests/test_torch_dist.py's gloo meshes (not a test module).

    python tests/_torch_dist_worker.py <coordinator> <world> <rank> <out.npz> <backend> <shadows> [<layout>]

Joins the group through rtwc_tpu_torch.dist.initialize_multihost, takes
one SGD step of the sharded train step (one band a rank) on the CPU with
every torch.distributed.all_reduce call counted, and saves the loss, the
gradients the step applied ((old - new) / lr), the parameters after it and
the all-reduce count and sizes, and the whole frame that
render_frame_sharded gathers from the ranks' bands (K7's plain version)
to out.npz.

With <layout> "tick" it takes one SGD step of the animated shadowed
step (the physics tick of DT inside the step) on random_scene(6) under a
torch profiler, and saves the loss, the gradients, the parameters, the
target, the program's span names and its dist.* counters' change.

With <layout> ("split" or "one") it sets the layout of the step and the
frame instead (dist.mesh._collective_in_graph, which picks "one" for NCCL
on a CUDA device; here the collectives run eagerly through gloo) and
takes 2 SGD steps, then 2 Adam steps of a new step, each step's losses,
parameters and all-reduce sizes saved; "one" gathers the frame inside
the frame graph's function (_FrameGraph, eager), "split" after it
(render_frame_sharded). Imports nothing of JAX.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

LR = 2.0 ** 16
DT = 1.0 / 60.0
TICK_SHIFT = (0.7, -0.4, 0.3)


def tick_case():
    """The animated case's config, start scene, camera and target (the soft
    render of the start with its centres shifted by TICK_SHIFT, ticked)."""
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.render import render_frame_soft
    from rtwc_tpu_torch.scene import random_scene, update_scene

    cfg = RenderConfig(width=64, height=32, max_spheres=6, max_planes=4,
                       soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=True)
    scene, cam = random_scene(6, max_spheres=6, max_planes=4, seed=0, spread=12.0), \
        default_camera()
    true = scene.replace(spheres=scene.spheres.replace(
        center=scene.spheres.center + torch.tensor(TICK_SHIFT)))
    target = render_frame_soft(update_scene(true, DT, cfg.bob_min_y, cfg.bob_max_y), cam, cfg,
                               tau=0.5).rgb.detach()
    return cfg, scene, cam, target


def _tick_run(out):
    from rtwc_tpu_torch.dist import make_mesh, make_sharded_train_step
    from rtwc_tpu_torch.dist.mesh import _leaves
    from rtwc_tpu_torch.utils import telemetry

    cfg, scene, cam, target = tick_case()
    step = make_sharded_train_step(
        cfg, make_mesh(), tau=0.5, backend="pallas", animate=True,
        optimizer=lambda leaves: torch.optim.SGD(list(leaves.values()), lr=LR))
    params = (scene, cam)
    state = step.init(params)
    before = telemetry.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        new, _, loss = step(params, state, target, DT)
    after = telemetry.counters()
    old_l, new_l = _leaves(params), _leaves(new)
    np.savez(out, loss=loss.numpy(), target=target.numpy(),
             spans=np.asarray(sorted({n for n, _, _ in telemetry.recorded()["spans"]})),
             **{f"count.{k}": after[k] - before.get(k, 0) for k in after if k.startswith("dist.")},
             **{f"grad.{k}": ((old_l[k] - new_l[k]) / LR).numpy() for k in old_l},
             **{f"param.{k}": v.numpy() for k, v in new_l.items()})


def _layout_run(layout, cfg, scene, cam, target, backend, sizes, out):
    from rtwc_tpu_torch.dist import make_mesh, make_sharded_train_step, render_frame_sharded
    from rtwc_tpu_torch.dist import mesh as M
    from rtwc_tpu_torch.dist.mesh import _leaves

    M._collective_in_graph = lambda group, device: layout == "one"
    saved = {}
    for name, opt, lr in (("sgd", torch.optim.SGD, LR), ("adam", torch.optim.Adam, 1e-2)):
        step = make_sharded_train_step(
            cfg, make_mesh(), tau=0.5, backend=backend,
            optimizer=lambda leaves: opt(list(leaves.values()), lr=lr))
        params = (scene, cam)
        state = step.init(params)
        saved[f"phases.{name}"] = len(state.phases)
        for i in range(2):
            del sizes[:]
            params, state, loss = step(params, state, target)
            saved[f"loss.{name}.{i}"] = loss.numpy()
            saved[f"sizes.{name}.{i}"] = np.asarray(sizes)
            saved.update({f"param.{name}.{i}.{k}": v.numpy().copy()
                          for k, v in _leaves(params).items()})
    mesh = make_mesh()
    if layout == "one":
        fg = M._FrameGraph(cfg, mesh.size, mesh.bands(), torch.device("cpu"), mesh.group,
                           graph=False)
        assert fg.gathers
        fb = fg(scene, cam)
    else:
        fb = render_frame_sharded(scene, cam, cfg, mesh, backend="pallas")
    np.savez(out, **saved,
             **{f"fb.{f}": getattr(fb, f).numpy() for f in ("rgb", "depth", "normal", "hit")})


def main() -> int:
    coordinator, world, rank, out, backend, shadows = sys.argv[1:7]
    layout = sys.argv[7] if len(sys.argv) > 7 else None
    torch.set_num_threads(1)
    from rtwc_tpu_torch.camera import default_camera
    from rtwc_tpu_torch.config import RenderConfig
    from rtwc_tpu_torch.dist import (initialize_multihost, make_mesh,
                                     make_sharded_train_step, render_frame_sharded)
    from rtwc_tpu_torch.dist.mesh import _leaves
    from rtwc_tpu_torch.render import render_frame_soft
    from rtwc_tpu_torch.scene import default_scene

    if not initialize_multihost(coordinator, int(world), int(rank), "gloo"):
        raise RuntimeError("initialize_multihost declined")
    cfg = RenderConfig(width=64, height=32, max_spheres=16, max_planes=4,
                       soft_miss_penalty=300.0, soft_mask_k=10.0, shadows=shadows == "1")
    scene, cam = default_scene(cfg), default_camera()
    target = render_frame_soft(scene, cam, cfg, tau=0.5).rgb.detach() + 10.0
    sizes = []
    all_reduce = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        sizes.append(tensor.numel())
        return all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = counted
    if layout == "tick":
        _tick_run(out)
        dist.destroy_process_group()
        return 0
    if layout is not None:
        _layout_run(layout, cfg, scene, cam, target, backend, sizes, out)
        dist.destroy_process_group()
        return 0
    step = make_sharded_train_step(
        cfg, make_mesh(), tau=0.5, backend=backend,
        optimizer=lambda leaves: torch.optim.SGD(list(leaves.values()), lr=LR))
    params = (scene, cam)
    new, _, loss = step(params, step.init(params), target)
    old_l, new_l = _leaves(params), _leaves(new)
    fb = render_frame_sharded(scene, cam, cfg, make_mesh(), backend="pallas")
    np.savez(out, loss=loss.numpy(), n_all_reduce=len(sizes), sizes=np.asarray(sizes),
             **{f"fb.{f}": getattr(fb, f).numpy() for f in ("rgb", "depth", "normal", "hit")},
             **{f"grad.{k}": ((old_l[k] - new_l[k]) / LR).numpy() for k in old_l},
             **{f"param.{k}": v.numpy() for k, v in new_l.items()})
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
