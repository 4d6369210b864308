"""K6 (csrc/soft_shadow.cu `soft_sh_mse`) on the card, split by tile class:
its four partial tables `torch.equal` to the plain version's
(`soft_sh_mse_plain`, one path for every tile) and the loss sum with them,
in scenes whose tiles are plane-only (no sphere in the view list or the
shadow list), full, or both; two replays of a CUDA graph of K6 against its
eager launch; the tile counters against the classes the lists give.

These tests need a CUDA card: they carry the `card` marker and skip
where torch finds none. On a machine with one card:

    python -m pytest tests/test_torch_shadow_mse_card.py -q -m card -s --confcutdir=tests

This file imports nothing of JAX."""
import numpy as np
import pytest
import torch

import chip_smoke as CS
from rtwc_tpu_torch.camera import default_camera
from rtwc_tpu_torch.config import RenderConfig
from rtwc_tpu_torch.render import shadow_kernel as SH
from rtwc_tpu_torch.render import soft_kernel as SK
from rtwc_tpu_torch.scene import add_plane, add_sphere, empty_scene, random_scene

TAU = 0.5
BASE = dict(soft_miss_penalty=300.0, soft_mask_k=10.0)  # the fit cells' constants


def _floor(max_spheres: int):
    return add_plane(empty_scene(max_spheres, 2), (0.0, -3.0, 30.0), (0.0, 1.0, 0.0),
                     (100.0, 100.0, 100.0), 60.0, 60.0)


# name -> (scene, width, height, band rows or None, the band's first row)
CASES = {
    # the bench headline, `fit_1080p_s20.shadowed_mse`'s scene: 67 % plane-only
    "headline": (lambda: random_scene(20, max_spheres=20, max_planes=4, seed=0), 1920, 1080,
                 None, 0),
    # `.sharded4`'s rank 3: the bottom 270-row band of random_scene(100), 9 % plane-only
    "band rows 810-1079": (lambda: random_scene(100, max_spheres=100, max_planes=4, seed=0),
                           1920, 1080, 270, 810),
    # 72 tiles, fewer than one wave of either variant, half of them plane-only
    "under a wave": (CS._crowd_scene, 192, 96, None, 0),
    "plane-only tiles alone": (lambda: _floor(4), 320, 96, None, 0),
    # a sphere in every tile's view list
    "no plane-only tile": (lambda: add_sphere(_floor(4), 30.0, (0.0, 0.0, 45.0),
                                              (120.0, 80.0, 200.0), speed=1.0), 320, 96, None, 0),
    # tiles with more culled-in objects than NC take the exact re-walk
    "re-walk tiles": (CS._slab_crowd, 320, 96, None, 0),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch finds none")
    return torch.device("cuda", 0)


def _args(name, dev):
    make, W, H, band, row0 = CASES[name]
    scene = make()
    cfg = RenderConfig(width=W, height=H, max_spheres=scene.spheres.center.shape[0],
                       max_planes=scene.planes.center.shape[0], shadows=True, **BASE)
    spec = SK._spec(cfg, TAU, 16, 16, True, True, "K6 card test", band_h=band)
    sph, pl, cam = SK._packed(scene.to(dev), default_camera().to(dev))
    cam = SK._at_row(cam, row0)
    lists, shl = SH.build_lists(sph, pl, cam, spec, True)
    offsets, _, sh_offsets, _, _ = SK.entry_tables(lists, shl)
    rng = np.random.default_rng(7)
    tgt = torch.from_numpy(rng.uniform(0.0, 255.0, (3,) + spec.extent).astype(np.float32)).to(dev)
    return spec, (sph, pl, cam, lists, shl, offsets, sh_offsets, tgt)


def _classes(args):
    po, full = SH.tile_classes(args[3], args[4])
    return po.numel(), full.numel()


def _delta(before):
    after = SH.tile_counts()
    return (after["k6.tiles_plane_only"] - before["k6.tiles_plane_only"],
            after["k6.tiles_full"] - before["k6.tiles_full"])


@pytest.mark.card
@pytest.mark.parametrize("name", list(CASES))
def test_k6_split_equals_the_plain_version(card, name):
    """pvals, psh, ppl, ptf (the loss sum in ptf's slot 12) bit for bit;
    the counters advance by the classes' sizes."""
    spec, args = _args(name, card)
    n_po, n_full = _classes(args)
    if name == "plane-only tiles alone":
        assert n_full == 0 and n_po > 0
    if name == "no plane-only tile":
        assert n_po == 0 and n_full > 0
    if name == "re-walk tiles":
        counts = SH.soft_sh_stats(*args[:5], spec=spec)[2][:, 0]
        assert int(counts.max()) > SH.NC
    before = SH.tile_counts()
    got = SH.soft_sh_mse(*args, spec=spec)
    assert _delta(before) == (n_po, n_full)
    want = SH.soft_sh_mse_plain(*args, spec=spec)
    for x, y, what in zip(got, want, ("pvals", "psh", "ppl", "ptf")):
        assert torch.equal(x, y), (name, what, float((x - y).abs().max()) if x.numel() else 0.0)
    assert torch.equal(got[3][:, SK.SLOT_LOSS], want[3][:, SK.SLOT_LOSS])
    print(f"{name}: {n_po} plane-only tiles, {n_full} full")


@pytest.mark.card
@pytest.mark.parametrize("name", ["headline", "band rows 810-1079"])
def test_k6_graph_replays_equal_its_eager_launch(card, name):
    """K6 captured in a CUDA graph after one eager call: two replays give the
    eager call's tables, and each replay counts its tiles again."""
    spec, args = _args(name, card)
    n_po, n_full = _classes(args)
    eager = SH.soft_sh_mse(*args, spec=spec)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = SH.soft_sh_mse(*args, spec=spec)
    before = SH.tile_counts()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(out, eager):
            assert torch.equal(x, y)
    assert _delta(before) == (2 * n_po, 2 * n_full)
