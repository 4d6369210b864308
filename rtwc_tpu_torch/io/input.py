"""Non-blocking POSIX keyboard + mouse input.

Counterpart: rtwc_tpu/io/input.py:1-233, copied with the port's Keys
(the JAX module imports rtwc_tpu.camera, which imports JAX).

Replaces Engine3D::CheckKeyboard's Win32 GetKeyState/GetCursorPos polling
(Engine3D.cpp:110-240). A terminal delivers key *events* (with autorepeat),
not key *state*, so held keys are emulated: each WASD/space/'c' event arms
its key for `hold_s` seconds (tuned to typical autorepeat) and the engine
reads a PressedKeys-style snapshot every frame.

Mouse look (reference parity with Engine3D.cpp:200-239's GetCursorPos
deltas): xterm any-motion mouse tracking in SGR encoding (DECSET 1003 +
1006) is enabled on start and parsed from stdin; deltas between successive
reported cell positions are scaled to "screen pixel" units (cells are
~10x20 px) so the reference's per-pixel mouse sensitivity (0.002 rad,
Camera3D.cpp:168) applies unchanged. Arrow keys / the terminal without
mouse support keep working as a fallback look control.

Bindings (reference parity, Engine3D.cpp:113-239):
  w/a/s/d   move            (GetKeyState W/A/S/D)
  space     up, c           down (VK_SPACE / VK_SHIFT - shift state is not
                             readable on a tty, 'c' stands in)
  mouse     look            (GetCursorPos deltas -> AddRot)
  arrows    look            (keyboard fallback)
  1..5 / F1..F5             rendering mode switch
  q / Esc   quit            (VK_ESCAPE)
"""
from __future__ import annotations

import dataclasses
import os
import re
import select
import sys
import time

from rtwc_tpu_torch.camera.controller import Keys
from rtwc_tpu_torch.config import RenderMode

_MODE_BY_DIGIT = {
    "1": RenderMode.BIT_ASCII,
    "2": RenderMode.BIT_PIXEL,
    "3": RenderMode.RGB_ASCII,
    "4": RenderMode.RGB_PIXEL,
    "5": RenderMode.RGB_NORMALS,
}
# F1-F5 escape sequences (xterm: ESC O P..S, ESC [ 1 5 ~).
_MODE_BY_FKEY = {
    "OP": RenderMode.BIT_ASCII,
    "OQ": RenderMode.BIT_PIXEL,
    "OR": RenderMode.RGB_ASCII,
    "OS": RenderMode.RGB_PIXEL,
    "[15~": RenderMode.RGB_NORMALS,
}
_ARROW_ROT = {  # (pitch_delta, yaw_delta) in "mouse pixel" units
    "[A": (40.0, 0.0),
    "[B": (-40.0, 0.0),
    "[C": (0.0, -40.0),
    "[D": (0.0, 40.0),
}
# SGR mouse report: ESC [ < b ; x ; y (M = press/motion, m = release).
_SGR_MOUSE = re.compile(r"\[<(\d+);(\d+);(\d+)([Mm])")
# Any other CSI (ESC [ params final) / SS3 (ESC O final) sequence: consumed
# and ignored so stray reports never alias to the bare-Esc quit.
_OTHER_SEQ = re.compile(r"\[[0-9;<=>?]*[@-~]|O[@-~]")

# Approximate terminal cell size in screen pixels: converts mouse-report
# cell deltas into the reference's per-pixel rotation units.
_CELL_PX_X, _CELL_PX_Y = 10.0, 20.0

_MOUSE_ENABLE = b"\x1b[?1003h\x1b[?1006h"
_MOUSE_DISABLE = b"\x1b[?1003l\x1b[?1006l"


@dataclasses.dataclass
class InputState:
    keys: Keys
    rot_delta: tuple  # (dp, dy)
    mode: RenderMode | None
    quit: bool


class InputHandler:
    """cbreak-mode stdin poller; restores termios + mouse mode on cleanup."""

    def __init__(self, stream=None, hold_s: float = 0.25, mouse: bool = True):
        self._stream = stream if stream is not None else sys.stdin
        self._hold_s = hold_s
        self._mouse = mouse
        self._held: dict[str, float] = {}
        self._old_attrs = None
        self._fd = None
        self._carry = ""  # partial escape sequence split across reads
        self._esc_pending = False  # lone trailing ESC carried one poll
        self._mouse_pos: tuple[int, int] | None = None
        self._mouse_enabled = False

    def start(self) -> None:
        try:
            import termios
            import tty

            self._fd = self._stream.fileno()
            if os.isatty(self._fd):
                self._old_attrs = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                if self._mouse and self._tty_write(_MOUSE_ENABLE):
                    self._mouse_enabled = True
        except Exception:
            self._fd = None

    def cleanup(self) -> None:
        if self._mouse_enabled:
            self._tty_write(_MOUSE_DISABLE)
            self._mouse_enabled = False
        if self._old_attrs is not None and self._fd is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old_attrs)
            self._old_attrs = None

    def _tty_write(self, data: bytes) -> bool:
        """Write a control sequence to the terminal (stdin is typically
        opened read/write on a tty; fall back to stdout)."""
        for fd in (self._fd, 1):
            if fd is None:
                continue
            try:
                os.write(fd, data)
                return True
            except OSError:
                continue
        return False

    def _read_pending(self) -> str:
        if self._fd is None:
            return ""
        chunks = []
        try:
            while select.select([self._fd], [], [], 0)[0]:
                data = os.read(self._fd, 1024)
                if not data:
                    break
                chunks.append(data.decode(errors="ignore"))
        except Exception:
            return ""
        return "".join(chunks)

    def poll(self) -> InputState:
        now = time.monotonic()
        was_pending = self._esc_pending
        self._esc_pending = False
        buf = self._carry + self._read_pending()
        self._carry = ""
        rot = [0.0, 0.0]
        mode = None
        quit_ = False

        i = 0
        while i < len(buf):
            ch = buf[i]
            if ch == "\x1b":
                rest = buf[i + 1:]
                matched = False
                for seq, m_ in _MODE_BY_FKEY.items():
                    if rest.startswith(seq):
                        mode, i, matched = m_, i + 1 + len(seq), True
                        break
                if not matched:
                    for seq, (dp, dy) in _ARROW_ROT.items():
                        if rest.startswith(seq):
                            rot[0] += dp
                            rot[1] += dy
                            i += 1 + len(seq)
                            matched = True
                            break
                if not matched:
                    m = _SGR_MOUSE.match(rest)
                    if m:
                        x, y = int(m.group(2)), int(m.group(3))
                        if self._mouse_pos is not None:
                            px, py = self._mouse_pos
                            # up/left motion = positive pitch/yaw, matching
                            # the arrow-key units above.
                            rot[0] += (py - y) * _CELL_PX_Y
                            rot[1] += (px - x) * _CELL_PX_X
                        self._mouse_pos = (x, y)
                        i += 1 + m.end()
                        matched = True
                if not matched:
                    m = _OTHER_SEQ.match(rest)
                    if m:
                        # unknown CSI/SS3: swallow, never treat as quit
                        i += 1 + m.end()
                        matched = True
                if not matched:
                    if rest and rest[0] in "[O" and len(rest) < 16:
                        # sequence split across reads: finish it next poll
                        self._carry = buf[i:]
                        break
                    if not rest:
                        # A read boundary can fall immediately after the ESC
                        # byte of a mouse report (DECSET 1003 floods stdin),
                        # so a lone trailing ESC is carried for one poll and
                        # only counts as the bare-Esc quit (VK_ESCAPE,
                        # Engine3D.cpp:172-175) if it is still unaccompanied
                        # on the next poll.
                        if was_pending and buf == "\x1b":
                            quit_ = True
                            i += 1
                            continue
                        self._carry = "\x1b"
                        self._esc_pending = True
                        break
                    # ESC + unrecognized byte = bare escape = quit
                    quit_ = True
                    i += 1
                continue
            lo = ch.lower()
            if lo in "wasd c":
                self._held[" " if ch == " " else lo] = now
            elif lo in _MODE_BY_DIGIT:
                mode = _MODE_BY_DIGIT[lo]
            elif lo == "q":
                quit_ = True
            i += 1

        def held(k: str) -> int:
            return int(now - self._held.get(k, -1e9) < self._hold_s)

        keys = Keys(
            w=held("w"), a=held("a"), s=held("s"), d=held("d"),
            space=held(" "), shift=held("c"),
        )
        return InputState(keys=keys, rot_delta=(rot[0], rot[1]), mode=mode, quit=quit_)
