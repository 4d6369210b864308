"""rtwc_tpu_torch heads and encoder against the JAX package (CPU).

The heads are integer code once the framebuffer is fixed, so on the same
framebuffer the cells must be equal, and the encoders must produce the
same bytes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtwc_tpu.config import RenderConfig as JRenderConfig
from rtwc_tpu.config import RenderMode as JRenderMode
from rtwc_tpu.heads import ansi256 as JA
from rtwc_tpu.heads import ascii as JASC
from rtwc_tpu.heads.encode import encode_frame_numpy as j_encode
from rtwc_tpu.heads.modes import framebuffer_to_cells as j_cells
from rtwc_tpu.render.reference import Framebuffer as JFB
from rtwc_tpu_torch.config import RenderConfig, RenderMode
from rtwc_tpu_torch.heads import ansi256 as TA
from rtwc_tpu_torch.heads import ascii as TASC
from rtwc_tpu_torch.heads.encode import encode_frame, encode_frame_numpy
from rtwc_tpu_torch.heads.modes import framebuffer_to_cells as t_cells
from rtwc_tpu_torch.render.reference import Framebuffer as TFB

torch.set_num_threads(2)

MODES = [RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
         RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS]


def test_palette_and_grey_lut_equal_jax():
    np.testing.assert_array_equal(TA.ANSI_PALETTE, JA.ANSI_PALETTE)
    np.testing.assert_array_equal(TA.GREY_LUT, JA.GREY_LUT)
    assert TASC.ASCII_RAMP == JASC.ASCII_RAMP and TASC.NUM_ASCII == 68


def test_ansi256_from_rgb_matches_jax():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(100_000, 3)).astype(np.int32)
    grey = np.repeat(np.arange(256, dtype=np.int32)[:, None], 3, axis=1)
    corners = np.array([[255, 255, 254], [255, 254, 255], [0, 0, 1], [254, 255, 255]], np.int32)
    rgb = np.concatenate([rgb, grey, corners])
    want = np.asarray(JA.ansi256_from_rgb(jnp.asarray(rgb)))
    got = TA.ansi256_from_rgb(torch.from_numpy(rgb))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # float input truncates toward zero like the reference's uint8_t casts
    f = (rgb[:1000] + 0.75).clip(0, 255).astype(np.float32)
    np.testing.assert_array_equal(TA.ansi256_from_rgb(torch.from_numpy(f)).numpy(),
                                  np.asarray(JA.ansi256_from_rgb(jnp.asarray(f))))
    # palette colours map back to themselves (away from the duplicate greys)
    idx = np.arange(16, 232)
    np.testing.assert_array_equal(
        TA.ansi256_from_rgb(TA.rgb_from_ansi256(torch.from_numpy(idx))).numpy(), idx)


def test_ascii_indices_match_jax():
    rng = np.random.default_rng(1)
    shading = rng.uniform(-0.5, 1.2, size=(40, 50)).astype(np.float32)
    depth = rng.uniform(0, 400, size=(40, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        TASC.ascii_indices(torch.from_numpy(shading), torch.from_numpy(depth), 250.0).numpy(),
        np.asarray(JASC.ascii_indices(jnp.asarray(shading), jnp.asarray(depth), 250.0)))


def _framebuffer(seed=2, H=24, W=40):
    """One seeded framebuffer with hits, misses, partial coverage and
    out-of-range colours / normals."""
    rng = np.random.default_rng(seed)
    hit = rng.uniform(size=(H, W)) < 0.6
    cov = np.where(hit, 1.0, np.where(rng.uniform(size=(H, W)) < 0.3, 0.25, 0.0))
    n = rng.normal(size=(H, W, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    f = np.float32
    leaves = dict(
        rgb=(rng.uniform(-10, 270, size=(H, W, 3)) * hit[..., None]).astype(f),
        normal=(n * hit[..., None]).astype(f),
        depth=np.where(hit, rng.uniform(1, 240, size=(H, W)), 1e8).astype(f),
        shading=(n[..., 0] * hit).astype(f),
        hit=hit, coverage=cov.astype(f), alpha=hit.astype(f))
    return (JFB(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            TFB(**{k: torch.from_numpy(np.asarray(v)) for k, v in leaves.items()}))


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_cells_and_bytes_match_jax(mode):
    jfb, tfb = _framebuffer()
    cfg = RenderConfig(width=40, height=24, mode=mode)
    jcfg = JRenderConfig(width=40, height=24, mode=JRenderMode(mode.value))
    want = [np.asarray(x) for x in j_cells(jfb, jcfg)]
    got = t_cells(tfb, cfg)
    for w, g, name in zip(want, got, ("kind", "color", "char")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    want_bytes = j_encode(*want)
    cells = [g.numpy() for g in got]
    assert encode_frame_numpy(*cells) == want_bytes
    assert encode_frame(*cells) == want_bytes  # native C++ encoder when it builds
    assert want_bytes.count(b"\n") == 24


def test_headless_mode_has_no_cell_head():
    _, tfb = _framebuffer()
    with pytest.raises(ValueError):
        t_cells(tfb, RenderConfig(mode=RenderMode.HEADLESS))
