"""Host-side ANSI escape-stream encoder with run-length minimisation.

Counterpart: rtwc_tpu/heads/encode.py:30-145, copied (that module is
NumPy-only, but importing it runs rtwc_tpu/heads/__init__.py, which
imports JAX). Same byte contract: an escape only where (kind, colour)
changes from the previous cell in row-major order, bare glyphs otherwise,
one '\\n' per row. The native C++ encoder (io/native.py, built from the
JAX package's ansi_encoder.cpp) is preferred; this NumPy version is the
fallback and the reference for tests. These encode cells on the host;
cells on a CUDA device are encoded there (heads/device_encode.py).
"""
from __future__ import annotations

import logging

import numpy as np

from rtwc_tpu_torch.utils.telemetry import span

log = logging.getLogger("rtwc_tpu_torch")

_ESC, _LB, _SEMI, _M, _NL = 0x1B, ord("["), ord(";"), ord("m"), ord("\n")
_D0 = ord("0")


def _digits(v: np.ndarray):
    """(d100, d10, d1) ASCII bytes + visibility masks (leading-zero drop)."""
    d100 = v // 100
    d10 = (v // 10) % 10
    d1 = v % 10
    return ((_D0 + d100).astype(np.uint8), (_D0 + d10).astype(np.uint8),
            (_D0 + d1).astype(np.uint8), v >= 100, v >= 10)


def _change_mask(key: np.ndarray) -> np.ndarray:
    """True where a cell's (kind, colour) differs from the previous cell;
    the first cell always emits."""
    flat = key.reshape(key.shape[0] * key.shape[1], -1)
    change = np.empty(flat.shape[0], bool)
    change[0] = True
    change[1:] = (flat[1:] != flat[:-1]).any(axis=-1)
    return change


def encode_frame_numpy(kind: np.ndarray, color: np.ndarray, char: np.ndarray) -> bytes:
    """Encode one frame of cells to a minimised ANSI byte stream.

    kind [H, W] 0 = background ('48'), 1 = foreground ('38');
    color [H, W] (256-colour index) or [H, W, 3] (truecolour); char [H, W].
    """
    H, W = kind.shape
    truecolor = color.ndim == 3
    n = H * W
    key = np.concatenate([kind.reshape(H, W, 1), color.reshape(H, W, -1)],
                         axis=-1).astype(np.int32)
    change = _change_mask(key)
    k_byte = np.where(kind.reshape(n) == 1, ord("3"), ord("4")).astype(np.uint8)
    ch = char.reshape(n).astype(np.uint8)

    if not truecolor:
        L = 12
        rec = np.zeros((n, L), np.uint8)
        valid = np.zeros((n, L), bool)
        d100, d10, d1, m100, m10 = _digits(color.reshape(n).astype(np.int32))
        rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3] = _ESC, _LB, k_byte, ord("8")
        rec[:, 4], rec[:, 5], rec[:, 6] = _SEMI, ord("5"), _SEMI
        rec[:, 7], rec[:, 8], rec[:, 9] = d100, d10, d1
        rec[:, 10], rec[:, 11] = _M, ch
        valid[change, :] = True
        valid[:, 7] &= m100
        valid[:, 8] &= m10
        valid[:, 11] = True
    else:
        L = 20
        rec = np.zeros((n, L), np.uint8)
        valid = np.zeros((n, L), bool)
        rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3] = _ESC, _LB, k_byte, ord("8")
        rec[:, 4], rec[:, 5], rec[:, 6] = _SEMI, ord("2"), _SEMI
        c = color.reshape(n, 3).astype(np.int32)
        digit_masks = np.zeros((n, 6), bool)
        for ci, (start, sep) in enumerate([(7, 10), (11, 14), (15, 18)]):
            d100, d10, d1, m100, m10 = _digits(c[:, ci])
            rec[:, start], rec[:, start + 1], rec[:, start + 2] = d100, d10, d1
            digit_masks[:, 2 * ci] = m100
            digit_masks[:, 2 * ci + 1] = m10
            if sep < 18:
                rec[:, sep] = _SEMI
        rec[:, 18], rec[:, 19] = _M, ch
        valid[change, :] = True
        valid[:, [7, 8, 11, 12, 15, 16]] = digit_masks & change[:, None]
        valid[:, 19] = True

    rec = rec.reshape(H, W, L)
    valid = valid.reshape(H, W, L)
    nl_rec = np.zeros((H, 1, L), np.uint8)
    nl_rec[:, 0, 0] = _NL
    nl_valid = np.zeros((H, 1, L), bool)
    nl_valid[:, 0, 0] = True
    rec = np.concatenate([rec, nl_rec], axis=1)
    valid = np.concatenate([valid, nl_valid], axis=1)
    return rec[valid].tobytes()


_native_failed = False


def encode_frame(kind, color, char) -> bytes:
    """Encode host cells to ANSI bytes, preferring the native C++ encoder;
    if it cannot be built, warn once and use the NumPy encoder."""
    global _native_failed
    with span("encode"):
        kind, color, char = np.asarray(kind), np.asarray(color), np.asarray(char)
        if not _native_failed:
            try:
                from rtwc_tpu_torch.io.native import encode_frame_native

                return encode_frame_native(kind, color, char)
            except (OSError, RuntimeError) as e:
                _native_failed = True
                log.warning("native ANSI encoder unavailable (%s); using the NumPy encoder", e)
        return encode_frame_numpy(kind, color, char)
