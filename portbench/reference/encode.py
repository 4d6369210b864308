"""The ANSI byte stream of a frame of cells, both ways.

`encode` is the NumPy run-length encoder (upstream's print machine byte
contract): an escape ESC[<k>8;5;<n>m or ESC[<k>8;2;<r>;<g>;<b>m (k = 4
background, 3 foreground) only where (kind, colour) differs from the
previous cell in row-major order, then the glyph; one '\\n' a row.
`decode` reads such a stream back into cells, so a published frame can be
compared cell by cell with the reference's.
"""
from __future__ import annotations

import numpy as np

_ESC, _LB, _SEMI, _M, _NL, _D0 = 0x1B, ord("["), ord(";"), ord("m"), ord("\n"), ord("0")


def _digits(v):
    return ((_D0 + v // 100).astype(np.uint8), (_D0 + (v // 10) % 10).astype(np.uint8),
            (_D0 + v % 10).astype(np.uint8), v >= 100, v >= 10)


def encode(kind: np.ndarray, color: np.ndarray, char: np.ndarray) -> bytes:
    H, W = kind.shape
    n = H * W
    key = np.concatenate([kind.reshape(H, W, 1), color.reshape(H, W, -1)], -1).astype(np.int32)
    flat = key.reshape(n, -1)
    change = np.empty(n, bool)
    change[0] = True
    change[1:] = (flat[1:] != flat[:-1]).any(-1)
    k_byte = np.where(kind.reshape(n) == 1, ord("3"), ord("4")).astype(np.uint8)
    ch = char.reshape(n).astype(np.uint8)
    if color.ndim == 2:
        L = 12
        rec = np.zeros((n, L), np.uint8)
        valid = np.zeros((n, L), bool)
        d100, d10, d1, m100, m10 = _digits(color.reshape(n).astype(np.int32))
        rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3] = _ESC, _LB, k_byte, ord("8")
        rec[:, 4], rec[:, 5], rec[:, 6] = _SEMI, ord("5"), _SEMI
        rec[:, 7], rec[:, 8], rec[:, 9], rec[:, 10], rec[:, 11] = d100, d10, d1, _M, ch
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
        masks = np.zeros((n, 6), bool)
        for ci, (start, sep) in enumerate([(7, 10), (11, 14), (15, 18)]):
            d100, d10, d1, m100, m10 = _digits(c[:, ci])
            rec[:, start], rec[:, start + 1], rec[:, start + 2] = d100, d10, d1
            masks[:, 2 * ci], masks[:, 2 * ci + 1] = m100, m10
            if sep < 18:
                rec[:, sep] = _SEMI
        rec[:, 18], rec[:, 19] = _M, ch
        valid[change, :] = True
        valid[:, [7, 8, 11, 12, 15, 16]] = masks & change[:, None]
        valid[:, 19] = True
    rec, valid = rec.reshape(H, W, L), valid.reshape(H, W, L)
    nl = np.zeros((H, 1, L), np.uint8)
    nl[:, 0, 0] = _NL
    nl_valid = np.zeros((H, 1, L), bool)
    nl_valid[:, 0, 0] = True
    return np.concatenate([rec, nl], 1)[np.concatenate([valid, nl_valid], 1)].tobytes()


def decode(frame: bytes, height: int, width: int):
    """(kind, colour, char) of a stream `encode` wrote, or None where the
    stream does not hold height rows of width cells, each escape well
    formed. colour is [H, W, 3] for truecolour escapes, [H, W] for
    256-colour ones."""
    b = np.frombuffer(frame, np.uint8)
    esc = np.flatnonzero(b == _ESC)
    ms = np.flatnonzero(b == _M)
    if esc.size == 0 or esc[0] != 0:
        return None
    ends = ms[np.searchsorted(ms, esc)] if ms.size else np.array([], np.int64)
    if ends.size != esc.size or (esc.size > 1 and np.any(ends[:-1] >= esc[1:])):
        return None
    inside = np.zeros(b.size + 1, np.int64)
    np.add.at(inside, esc, 1)
    np.add.at(inside, ends + 1, -1)
    in_esc = np.cumsum(inside[:-1]) > 0
    glyph = ~in_esc & (b != _NL)
    rows = np.flatnonzero(~in_esc & (b == _NL))
    if rows.size != height:
        return None
    per_row = np.diff(np.concatenate([[0], np.cumsum(glyph)[rows]]))
    if np.any(per_row != width):
        return None
    # escape bodies: ESC [ k 8 ; t ; n1 (; n2 ; n3) m
    if np.any(ends - esc < 8):
        return None
    if (np.any(b[esc + 1] != _LB) or np.any(b[esc + 3] != ord("8")) or np.any(b[esc + 4] != _SEMI)
            or np.any(b[esc + 6] != _SEMI) or np.any((b[esc + 2] != ord("3")) & (b[esc + 2] != ord("4")))
            or np.any((b[esc + 5] != ord("2")) & (b[esc + 5] != ord("5")))):
        return None
    kinds = np.where(b[esc + 2] == ord("3"), 1, 0)
    true = b[esc + 5] == ord("2")
    if not (np.all(true) or not np.any(true)):
        return None
    nums = _numbers(b, esc + 7, ends)
    want = 3 if true[0] else 1
    if nums is None or nums.shape[1] != want:
        return None
    # each glyph takes the last escape before it
    gpos = np.flatnonzero(glyph)
    which = np.searchsorted(esc, gpos) - 1
    if which[0] < 0:
        return None
    kind = kinds[which].reshape(height, width).astype(np.int32)
    color = nums[which].reshape((height, width, 3) if true[0] else (height, width))
    char = b[gpos].reshape(height, width).astype(np.int32)
    return kind, color.astype(np.int32), char


def _numbers(b, starts, ends):
    """[n_escapes, k] of the ';'-separated decimal numbers in b[s:e] each,
    or None where the escapes hold different counts or a non-digit."""
    lengths = ends - starts
    if lengths.size == 0 or np.any(lengths <= 0):
        return None
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    idx = np.repeat(starts - offsets, lengths) + np.arange(lengths.sum())
    body = b[idx]
    esc_of = np.repeat(np.arange(starts.size), lengths)
    semi = body == _SEMI
    digit = (body >= _D0) & (body <= _D0 + 9)
    if not np.all(semi | digit):
        return None
    n_semi = np.bincount(esc_of, weights=semi, minlength=starts.size).astype(np.int64)
    if np.any(n_semi != n_semi[0]):
        return None
    k = int(n_semi[0]) + 1
    # the field of each byte inside its escape (a ';' opens the next one)
    field = np.cumsum(semi) - np.repeat(np.concatenate([[0], np.cumsum(n_semi)[:-1]]), lengths)
    slot = esc_of * k + field
    # a digit's place: the digits after it in its own field
    last = np.ones(idx.size, bool)
    last[:-1] = slot[:-1] != slot[1:]
    rank = np.cumsum(digit[::-1])[::-1]              # digits from here to the end
    rank_after = np.concatenate([rank[1:], [0]])
    field_end = np.flatnonzero(last)
    after = rank_after[field_end][np.searchsorted(field_end, np.arange(idx.size))]
    place = rank - after - 1
    if np.any(place[digit] > 2):
        return None
    out = np.zeros(starts.size * k, np.int64)
    np.add.at(out, slot[digit], (body[digit].astype(np.int64) - _D0) * 10 ** place[digit])
    return out.reshape(starts.size, k)
