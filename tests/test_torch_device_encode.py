"""The device encode's plain version (heads/device_encode.py) on the CPU:
byte for byte against the port's NumPy encoder, its C++ encoder and the
JAX package's NumPy encoder, in 256 colours and in truecolor, on fuzzed
cells, edge frames and the cells of rendered frames in every mode; and
the engine's publish of a frame whose stream the card encoded. The CUDA
kernel is held to the plain version on the card (chip_smoke.py's phase
3e)."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rtwc_tpu.heads.encode import encode_frame_numpy as j_encode
from rtwc_tpu_torch.camera import default_camera
from rtwc_tpu_torch.config import EngineConfig, RenderConfig, RenderMode
from rtwc_tpu_torch.engine import Engine
from rtwc_tpu_torch.engine import engine as E
from rtwc_tpu_torch.heads import device_encode as DE
from rtwc_tpu_torch.heads.encode import encode_frame, encode_frame_numpy
from rtwc_tpu_torch.io import FramebufferSink
from rtwc_tpu_torch.scene import default_scene
from rtwc_tpu_torch.utils import telemetry as T

torch.set_num_threads(2)

MODES = [RenderMode.BIT_ASCII, RenderMode.BIT_PIXEL, RenderMode.RGB_ASCII,
         RenderMode.RGB_PIXEL, RenderMode.RGB_NORMALS]
DIGITS = (0, 9, 10, 99, 100, 255)


def _stream(cells) -> bytes:
    buf, n = DE.encode_cells(*(torch.from_numpy(np.ascontiguousarray(c, np.int32))
                               for c in cells))
    assert buf.dtype == torch.uint8 and n.dtype == torch.int64 and n.shape == (1,)
    return bytes(buf[:int(n)].numpy())


def _agree(cells) -> bytes:
    """The plain device encode's bytes, held to every host encoder."""
    got = _stream(cells)
    want = encode_frame_numpy(*cells)
    assert got == want
    assert got == j_encode(*cells)
    assert got == encode_frame(*cells)  # the native C++ encoder where it builds
    return got


def _random_cells(rng, H, W, truecolor, runs):
    kind = rng.integers(0, 2, size=(H, W))
    color = rng.integers(0, 256, size=(H, W, 3) if truecolor else (H, W))
    char = rng.integers(32, 127, size=(H, W))
    if runs:  # constant runs that cross rows: few escapes
        flat_k, flat_c = kind.reshape(-1), color.reshape(H * W, -1)
        start = 0
        while start < H * W:
            end = start + int(rng.integers(1, 3 * W + 2))
            flat_k[start:end] = flat_k[start]
            flat_c[start:end] = flat_c[start]
            start = end
    return kind, color, char


@pytest.mark.parametrize("truecolor", [False, True], ids=["ansi256", "truecolor"])
@pytest.mark.parametrize("runs", [False, True], ids=["noise", "runs"])
def test_plain_stream_matches_the_encoders_on_fuzzed_cells(truecolor, runs):
    rng = np.random.default_rng(7 + truecolor + 2 * runs)
    for _ in range(12):
        H, W = int(rng.integers(1, 30)), int(rng.integers(1, 90))
        _agree(_random_cells(rng, H, W, truecolor, runs))


def _digit_cells(truecolor):
    """Every value of DIGITS in every channel, each cell after a change."""
    vals = np.array(DIGITS)
    if truecolor:
        r, g, b = np.meshgrid(vals, vals, vals, indexing="ij")
        color = np.stack([r, g, b], -1).reshape(12, 18, 3)
    else:
        color = np.tile(vals, 6).reshape(4, 9)
    H, W = color.shape[:2]
    kind = (np.arange(H * W) // 7 % 2).reshape(H, W)
    return kind, color, np.full((H, W), ord("#"))


def _edge_cases(truecolor):
    c3 = (lambda v: np.full((1, 1, 3), v)) if truecolor else (lambda v: np.full((1, 1), v))
    rng = np.random.default_rng(3)
    one = _random_cells(rng, 1, 57, truecolor, True)
    col = _random_cells(rng, 41, 1, truecolor, True)
    # kind changes under one colour; glyph changes under one (kind, colour)
    H, W = 5, 11
    same = np.zeros((H, W, 3) if truecolor else (H, W), int) + 42
    kind = (np.arange(H * W) % 3 == 0).reshape(H, W).astype(int)
    glyphs = (33 + np.arange(H * W) % 90).reshape(H, W)
    return {
        "first cell alone": (np.ones((1, 1), int), c3(7), np.full((1, 1), ord("x"))),
        "first cell background": (np.zeros((1, 1), int), c3(0), np.full((1, 1), 32)),
        "digits 0 9 10 99 100 255": _digit_cells(truecolor),
        "one row": one,
        "one column": col,
        "kind changes under one colour": (kind, same, np.full((H, W), ord("."))),
        "glyph changes under one colour": (np.ones((H, W), int), same, glyphs),
        "one colour everywhere": (np.zeros((3, 8), int), np.zeros((3, 8, 3) if truecolor
                                                                  else (3, 8), int),
                                  np.full((3, 8), 32)),
    }


EDGES = list(_edge_cases(False))


@pytest.mark.parametrize("truecolor", [False, True], ids=["ansi256", "truecolor"])
@pytest.mark.parametrize("case", EDGES)
def test_plain_stream_on_edge_frames(truecolor, case):
    cells = _edge_cases(truecolor)[case]
    got = _agree(cells)
    H, W = cells[0].shape
    assert got.count(b"\n") == H and got.endswith(b"\n") and got.startswith(b"\x1b[")
    if case == "first cell alone":
        assert got == (b"\x1b[38;2;7;7;7mx\n" if truecolor else b"\x1b[38;5;7mx\n")
    if case == "one colour everywhere":
        assert got.count(b"\x1b[") == 1
    if case == "glyph changes under one colour":
        assert got.count(b"\x1b[") == 1


@pytest.mark.parametrize("mode", MODES, ids=[m.value for m in MODES])
def test_plain_stream_of_rendered_frames(mode):
    """The cells of a frame the engine's step renders (shadows, 2x
    supersampling, the default scene) in each mode."""
    cfg = RenderConfig(width=64, height=20, mode=mode, shadows=True, supersample=2,
                       max_spheres=16, max_planes=4)
    _, cells = E._render_step(default_scene(cfg), default_camera(), 0.05, cfg)
    cells = [c.numpy() for c in cells]
    got = _agree(cells)
    assert len(got) <= DE.stream_bound(20, 64, cells[1].ndim == 3)


@pytest.mark.parametrize("truecolor", [False, True], ids=["ansi256", "truecolor"])
def test_plain_stream_layout(truecolor):
    """[bound] uint8 on the cells' device with the length [1] int64; zeros
    past the length; the bound a cell's most bytes a cell and a '\\n' a row."""
    rng = np.random.default_rng(5)
    H, W = 7, 13
    cells = [torch.from_numpy(c.astype(np.int32))
             for c in _random_cells(rng, H, W, truecolor, False)]
    buf, n = DE.encode_cells(*cells)
    assert DE.stream_bound(H, W, truecolor) == H * (W * (20 if truecolor else 12) + 1)
    assert buf.shape == (DE.stream_bound(H, W, truecolor),) and buf.device == cells[0].device
    assert int(n) <= buf.numel() and not buf[int(n):].any()
    assert not any(DE.LAUNCHES.values())  # the plain version launches nothing


@pytest.mark.parametrize("bad", ["host_buf short", "host_buf int32", "host_len shape"])
def test_copy_to_host_refuses_what_it_does_not_take(bad):
    stream = DE.encode_cells(*(torch.zeros((2, 3), dtype=torch.int32) for _ in range(3)))
    buf = torch.empty(stream[0].numel(), dtype=torch.uint8)
    n = torch.empty(1, dtype=torch.int64)
    args = {"host_buf short": (buf[:-1], n), "host_buf int32": (buf.int(), n),
            "host_len shape": (buf, n.reshape(1, 1))}[bad]
    with pytest.raises(ValueError):
        DE.copy_to_host(stream, *args)


@pytest.mark.parametrize("bad", ["int64 kind", "color shape", "char shape", "empty", "meta"])
def test_encode_cells_refuses_what_it_does_not_take(bad):
    k = torch.zeros((3, 4), dtype=torch.int32)
    c = torch.zeros((3, 4, 3), dtype=torch.int32)
    ch = torch.full((3, 4), 32, dtype=torch.int32)
    args = {"int64 kind": (k.long(), c, ch), "color shape": (k, c[:, :2], ch),
            "char shape": (k, c, ch[:2]), "empty": (k[:0], c[:0], ch[:0]),
            "meta": (k.to("meta"), c.to("meta"), ch.to("meta"))}[bad]
    with pytest.raises(ValueError):
        DE.encode_cells(*args)


def _engine():
    rcfg = RenderConfig(width=40, height=24, mode=RenderMode.BIT_ASCII, max_spheres=16,
                        max_planes=4)
    sink = FramebufferSink(keep_all=True)
    return Engine(rcfg, EngineConfig(spawn=False, show_fps=False, seed=1), presenter=sink,
                  interactive=False, device="cpu"), sink


def test_engine_publishes_a_stream_encoded_on_the_device():
    """A Download holding a stream's host copy and its length, made by
    `copy_to_host` as the card's pinned pair holds them: the published
    bytes are the stream's first `length` bytes; one host read, one
    `encode.device`, the `encode` span open and `encode.native` not."""
    eng, sink = _engine()
    frame = eng.device_frame(0.05)
    stream = DE.encode_cells(*frame.cells)
    host = (torch.full((stream[0].numel() + 5,), 7, dtype=torch.uint8),
            torch.zeros(1, dtype=torch.int64))
    DE.copy_to_host(stream, *host)
    assert torch.equal(host[1], stream[1])
    before = T.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng._publish(E.Download(None, host, None))
    after = T.counters()
    assert sink.frames[-1] == encode_frame_numpy(*(c.numpy() for c in frame.cells))
    assert after["encode.device"] - before.get("encode.device", 0) == 1
    assert after["host_reads"] - before.get("host_reads", 0) == 1
    names = {e.name for e in prof.events()}
    assert T.PREFIX + "encode" in names and T.PREFIX + "encode.native" not in names


def test_engine_keeps_the_host_encoder_for_host_cells():
    """Cells on the host: no stream, the host encoder publishes them, and
    `encode.device` does not count."""
    eng, sink = _engine()
    before = T.counters().get("encode.device", 0)
    eng.run(max_frames=3)
    assert eng.device_frame(0.05).stream is None
    assert len(sink.frames) == 3 and T.counters().get("encode.device", 0) == before
