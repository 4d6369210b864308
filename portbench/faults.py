"""Faults planted in the port's timed path, underneath the harness: the
readings that a limit of `correct` must tell from a sound program, and
the test that sees `correct` come out false under each.

    undo = plant("half_batch_fused")
    ...
    undo()

Fit cells: `state_unchanged` (the optimiser's step does nothing), a half
batch (the loss taken over the top half of the rows alone), an answer
altered where it is produced (the loss, or the frame's colours, scaled by
1.01), and `replay_skips_backward`: the captured graph leaves out the
backward, so a replay's update reads the .grad that the step's eager
first call left (a card's replays alone; on the CPU every step is eager
and the fault changes nothing). Console cells: the physics tick skipped (`frame_unchanged`), the
bottom half of the cells' colours zeroed, the published escapes altered.
"""
from __future__ import annotations

import torch

FIT = ("state_unchanged", "half_batch_fused", "half_batch_frame", "answer_altered_fused",
       "answer_altered_frame", "replay_skips_backward")
CONSOLE = ("frame_unchanged", "half_frame", "bytes_altered")


def _set(obj, name, value, undo):
    old = getattr(obj, name)
    setattr(obj, name, value)
    undo.append(lambda: setattr(obj, name, old))


def plant(fault: str):
    """Plant `fault`; returns the function that takes it out again."""
    import portbench.drivers.fit_step as FS
    import rtwc_tpu_torch.engine.engine as E
    import rtwc_tpu_torch.render.soft_kernel as SK
    import rtwc_tpu_torch.render.step_graph as SG

    undo = []
    if fault == "state_unchanged":
        _set(torch.optim.Adam, "step", lambda self, closure=None: None, undo)
    elif fault == "half_batch_fused":
        full = SK.render_soft_mse_loss

        def half(scene, camera, target, config, **kw):
            h = config.height // 2
            return full(scene, camera, target[:h], config.replace(height=h), **kw)
        _set(SK, "render_soft_mse_loss", half, undo)
    elif fault == "half_batch_frame":
        full = SK.render_frame_soft_kernel

        def top_half(scene, camera, config, **kw):
            return full(scene, camera, config.replace(height=config.height // 2), **kw)
        loss_of = FS.loss_of

        def half(fb, target, target_a, w_sil):
            h = fb.rgb.shape[0]
            return loss_of(fb, target[:h], target_a[:h], w_sil)
        _set(SK, "render_frame_soft_kernel", top_half, undo)
        _set(FS, "loss_of", half, undo)
    elif fault == "answer_altered_fused":
        full = SK.render_soft_mse_loss
        _set(SK, "render_soft_mse_loss", lambda *a, **kw: full(*a, **kw) * 1.01, undo)
    elif fault == "answer_altered_frame":
        full = SK.render_frame_soft_kernel

        def altered(*a, **kw):
            fb = full(*a, **kw)
            return type(fb)(**{f: getattr(fb, f) for f in fb.__dataclass_fields__
                               if f != "rgb"}, rgb=fb.rgb * 1.01)
        _set(SK, "render_frame_soft_kernel", altered, undo)
    elif fault == "replay_skips_backward":
        def captured(self):
            static = self.loss_fn()
            if self.in_graph:
                self.opt.step()
            return static.detach()
        _set(SG.CapturedStep, "_captured", captured, undo)
    elif fault == "frame_unchanged":
        _set(E, "update_scene", lambda scene, *a, **kw: scene, undo)
    elif fault == "half_frame":
        cells = E.framebuffer_to_cells

        def half(fb, config):
            kind, color, char = cells(fb, config)
            color = color.clone()
            color[color.shape[0] // 2:] = 0
            return kind, color, char
        _set(E, "framebuffer_to_cells", half, undo)
    elif fault == "bytes_altered":
        enc = E.encode_frame
        _set(E, "encode_frame", lambda *a: enc(*a).replace(b";5;2", b";5;3"), undo)
    else:
        raise ValueError(f"no fault {fault!r}")

    def take_out():
        while undo:
            undo.pop()()
    return take_out
