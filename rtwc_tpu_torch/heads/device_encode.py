"""The console frame's ANSI stream encoded where its cells are: the wrapper
of csrc/ansi_encode.cu and its plain version.

Replaces no Pallas kernel: the JAX package encodes on the host
(rtwc_tpu/heads/encode.py, io/native/ansi_encoder.cpp), as the port does
for cells on the host (heads/encode.py `encode_frame`). On the card the
engine's frame ends in this encode, inside its CUDA graph, and the host
copies the finished bytes and their length instead of the cell planes.
The kernel's source note gives its design and what bounds it (memory:
one read of the cells for the counts, one to write, one write of the
stream).

`encode_cells(kind, color, char)` returns (stream [bound] uint8, length
[1] int64) on the cells' device: the stream's first `length` bytes are
`encode_frame_numpy`'s bytes for the same cells; the rest of the buffer
is unspecified. `bound` (`stream_bound`) is H x (W x 12 + 1) bytes in
256 colours and H x (W x 20 + 1) in truecolor, a cell's most bytes and a
row's '\\n'. For CUDA tensors it launches the kernel (two launches,
counted in `LAUNCHES["ansi_encode"]`) or raises; for CPU tensors it runs
`encode_cells_plain`, the same arithmetic in torch ops: each cell's
record and its valid bytes, the per-cell lengths, their cumsum and a
scatter. Nothing reads a value back to the host.

`copy_to_host(stream, host_buf, host_len)` queues the download: the
stream's first `length` bytes and the length into pinned host buffers,
by one launch of the copy kernel (`LAUNCHES["ansi_copy"]`), which reads
the length on the card; so the copy moves the stream's bytes, not its
bound, and the host reads the length only after the frame's event.
"""
from __future__ import annotations

import ctypes

import torch

from rtwc_tpu_torch.render import _cuda

# CUDA launches in this process: the encode's two kernels, the download's copy.
LAUNCHES = {"ansi_encode": 0, "ansi_copy": 0}

_ESC, _LB, _SEMI, _M, _NL, _D0 = 0x1B, ord("["), ord(";"), ord("m"), ord("\n"), ord("0")


def cell_bytes(truecolor: bool) -> int:
    """A cell's most bytes: the escape and the glyph."""
    return 20 if truecolor else 12


def stream_bound(H: int, W: int, truecolor: bool) -> int:
    """The most bytes a frame's stream can take."""
    return H * (W * cell_bytes(truecolor) + 1)


def _check(kind: torch.Tensor, color: torch.Tensor, char: torch.Tensor) -> bool:
    """Raise on cells the encoder does not take; returns truecolor."""
    if kind.dim() != 2 or kind.shape[0] < 1 or kind.shape[1] < 1:
        raise ValueError(f"kind must be [H, W] with H, W >= 1, got {tuple(kind.shape)}")
    H, W = kind.shape
    truecolor = color.dim() == 3
    want = (H, W, 3) if truecolor else (H, W)
    for name, t, shape in (("kind", kind, (H, W)), ("color", color, want), ("char", char, (H, W))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != kind.device:
            raise ValueError(f"{name} must be an int32 {shape} tensor on {kind.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return truecolor


@torch.no_grad()
def encode_cells_plain(kind: torch.Tensor, color: torch.Tensor, char: torch.Tensor):
    """The plain version, on the cells' device: (stream [bound] uint8,
    length [1] int64), the stream's bytes past `length` zero."""
    truecolor = _check(kind, color, char)
    H, W = kind.shape
    n, dev = H * W, kind.device
    k = kind.reshape(n)
    c = color.reshape(n, -1)
    key = torch.cat([k[:, None], c], 1)
    change = torch.ones(n, dtype=torch.bool, device=dev)
    change[1:] = (key[1:] != key[:-1]).any(1)

    # each cell's record: [escape (7 fixed bytes, the digits, separators,
    # 'm')] glyph ['\n' after a row's last cell], and which bytes it emits
    L = cell_bytes(truecolor)
    rec = torch.zeros((n, L + 1), dtype=torch.uint8, device=dev)
    valid = torch.zeros((n, L + 1), dtype=torch.bool, device=dev)
    fixed = [_ESC, _LB, 0, ord("8"), _SEMI, ord("2" if truecolor else "5"), _SEMI]
    rec[:, :7] = torch.tensor(fixed, dtype=torch.uint8, device=dev)
    rec[:, 2] = torch.where(k == 1, ord("3"), ord("4")).to(torch.uint8)
    valid[:, :L - 1] = change[:, None]
    for ci, start in enumerate((7, 11, 15) if truecolor else (7,)):
        v = c[:, ci]
        rec[:, start] = (_D0 + v // 100).to(torch.uint8)
        rec[:, start + 1] = (_D0 + (v // 10) % 10).to(torch.uint8)
        rec[:, start + 2] = (_D0 + v % 10).to(torch.uint8)
        valid[:, start] &= v >= 100
        valid[:, start + 1] &= v >= 10
        if truecolor and start < 15:
            rec[:, start + 3] = _SEMI
    rec[:, L - 2] = _M
    rec[:, L - 1] = char.reshape(n).to(torch.uint8)
    valid[:, L - 1] = True
    rec[:, L] = _NL
    valid[:, L] = (torch.arange(n, device=dev) % W) == W - 1

    # per-cell lengths, each cell's offset, and its valid bytes scattered
    # there (the rest to a spare slot past the bound, cut off)
    lens = valid.sum(1)
    ends = torch.cumsum(lens, 0)
    bound = stream_bound(H, W, truecolor)
    dest = (ends - lens)[:, None] + torch.cumsum(valid, 1) - 1
    dest = torch.where(valid, dest, bound)
    out = torch.zeros(bound + 1, dtype=torch.uint8, device=dev)
    out.scatter_(0, dest.reshape(-1), rec.reshape(-1))
    return out[:bound], ends[-1:].to(torch.int64)


_ARGTYPES = {
    "rtwc_ansi_encode": [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_void_p],
    "rtwc_ansi_copy": [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
}


def _fn(name: str = "rtwc_ansi_encode"):
    fn = getattr(_cuda.load("ansi_encode"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@torch.no_grad()
def encode_cells(kind: torch.Tensor, color: torch.Tensor, char: torch.Tensor):
    """(stream [bound] uint8, length [1] int64) on the cells' device: the
    kernel on a CUDA device, the plain version on the CPU."""
    truecolor = _check(kind, color, char)
    dev = kind.device
    if dev.type == "cpu":
        return encode_cells_plain(kind, color, char)
    if dev.type != "cuda":
        raise ValueError(f"the encode runs on cuda (plain version on cpu), not {dev}")
    kind, color, char = (t.contiguous() for t in (kind, color, char))
    H, W = kind.shape
    out = torch.empty(stream_bound(H, W, truecolor), dtype=torch.uint8, device=dev)
    length = torch.empty(1, dtype=torch.int64, device=dev)
    rows = torch.empty(H, dtype=torch.int32, device=dev)
    rc = _fn()(kind.data_ptr(), color.data_ptr(), char.data_ptr(), rows.data_ptr(),
               out.data_ptr(), length.data_ptr(), H, W, int(truecolor), _index(dev),
               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rtwc_ansi_encode launch failed: cudaError {rc}")
    LAUNCHES["ansi_encode"] += 2
    return out, length


@torch.no_grad()
def copy_to_host(stream: tuple, host_buf: torch.Tensor, host_len: torch.Tensor) -> None:
    """The stream's (bytes, length) first `length` bytes into host_buf [>=
    bound] uint8 and the length into host_len [1] int64, host tensors
    (pinned for a stream on the card, 16-byte aligned): on the card one
    launch of the copy kernel, queued on the current stream; on the CPU a
    plain copy."""
    buf, length = stream
    if (host_buf.dtype != torch.uint8 or host_buf.dim() != 1 or host_buf.numel() < buf.numel()
            or host_len.dtype != torch.int64 or host_len.shape != (1,)
            or host_buf.device.type != "cpu" or host_len.device.type != "cpu"):
        raise ValueError(f"host_buf must be a uint8 [>= {buf.numel()}] and host_len an int64 [1] "
                         f"host tensor, got {host_buf.dtype} {tuple(host_buf.shape)} on "
                         f"{host_buf.device}, {host_len.dtype} {tuple(host_len.shape)} on "
                         f"{host_len.device}")
    dev = buf.device
    if dev.type == "cpu":
        n = int(length)
        host_buf[:n] = buf[:n]
        host_len.copy_(length)
        return
    if dev.type != "cuda":
        raise ValueError(f"the copy runs on cuda (a plain copy on cpu), not {dev}")
    rc = _fn("rtwc_ansi_copy")(buf.data_ptr(), length.data_ptr(), host_buf.data_ptr(),
                               host_len.data_ptr(), buf.numel(), _index(dev),
                               torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rtwc_ansi_copy launch failed: cudaError {rc}")
    LAUNCHES["ansi_copy"] += 1
