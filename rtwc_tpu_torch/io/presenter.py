"""ConsolePresenter: double-buffered threaded terminal blitter.

Counterpart: rtwc_tpu/io/presenter.py:34-243, copied (importing the JAX
package's io/ runs io/input.py, which imports JAX). The native print
thread comes from rtwc_tpu_torch/io/native.py.

The POSIX re-design of PrintMachine (PrintMachine.h/.cpp): an own print
thread decoupled from the render loop, a mutex-guarded back buffer the
renderer publishes into (PrintMachine.cpp:178-192), cursor-home + whole-
frame write per iteration (PrintMachine.cpp:257-306), an FPS overlay
(two rates: rendering and printing, PrintMachine.cpp:297-299), and
terminal setup/teardown. Win32 console modes (QuickEdit, VT enable,
PrintMachine.cpp:36-78) become the VT sequences every POSIX terminal
already speaks plus termios raw mode; the Ctrl-close graceful-shutdown
handler (PrintMachine.cpp:81-101) becomes SIGINT/SIGTERM handlers that
restore the terminal.

Unlike the reference it is an instantiable class, not a global static
singleton (SURVEY.md section 1 lists that coupling as a thing not to
reproduce).
"""
from __future__ import annotations

import signal
import sys
import threading
import time

_HIDE_CURSOR = b"\x1b[?25l"
_SHOW_CURSOR = b"\x1b[?25h"
_ALT_SCREEN_ON = b"\x1b[?1049h"
_ALT_SCREEN_OFF = b"\x1b[?1049l"
_CURSOR_HOME = b"\x1b[H"
_RESET = b"\x1b[0m"
_CLEAR = b"\x1b[2J"


class ConsolePresenter:
    """Threaded, double-buffered ANSI frame presenter.

    The print thread itself comes in two implementations, chosen at start():
    the native C++ print machine (rtwc_tpu/io/native/print_machine.cpp - blits
    outside the GIL, used whenever the output has a real file descriptor
    and the native library builds) and the pure-Python loop below (any
    file-like sink; the fallback without a toolchain). Byte-for-byte same
    output contract.
    """

    def __init__(self, width: int, height: int, out=None, show_fps: bool = True,
                 max_print_fps: float = 0.0, title: str = "rtwc-tpu",
                 backend: str = "auto"):
        self.width = width
        self.height = height
        self._out = out if out is not None else sys.stdout.buffer
        self._show_fps = show_fps
        self._min_period = 1.0 / max_print_fps if max_print_fps > 0 else 0.0
        self._title = title
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown presenter backend {backend!r}")
        self._backend = backend
        self._native = None  # NativePrintMachine when active

        self._lock = threading.Lock()
        self._back_buffer: bytes = b""
        self._fresh = False
        self._running = False
        self._terminate = False
        self._thread: threading.Thread | None = None

        self._rendering_fps = 0.0
        self._printing_fps = 0.0
        self._print_count = 0
        self._prev_handlers: dict[int, object] = {}

    # -- lifecycle (PrintMachine::Start / CleanUp) ---------------------------

    def _try_native(self):
        if self._backend == "python":
            return None
        try:
            fd = self._out.fileno()
        except Exception:
            fd = None
        if fd is None:
            if self._backend == "native":
                raise RuntimeError("native presenter needs an output with a file descriptor")
            return None
        try:
            from rtwc_tpu_torch.io.native import NativePrintMachine

            return NativePrintMachine(fd, self._show_fps, self._min_period)
        except Exception:
            if self._backend == "native":
                raise
            return None

    def start(self) -> None:
        self._setup_terminal()
        self._install_signal_handlers()
        self._running = True
        self._terminate = False
        self._native = self._try_native()
        if self._native is None:
            self._thread = threading.Thread(target=self._print_loop, daemon=True,
                                            name="rtwc-print")
            self._thread.start()

    def cleanup(self) -> None:
        self._terminate = True
        if self._native is not None:
            self._native.stop()
            self._native = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._restore_terminal()
        self._restore_signal_handlers()
        self._running = False

    def check_if_running(self) -> bool:
        """Liveness probe the engine polls each frame (Engine3D.cpp:33)."""
        if self._native is not None and not self._native.running():
            return False  # e.g. broken pipe in the native blit thread
        return self._running and not self._terminate

    # -- producer side (PrintMachine::SetDataInBackBuffer) -------------------

    def set_data_in_back_buffer(self, frame: bytes) -> None:
        if self._native is not None:
            self._native.publish(frame)
            return
        with self._lock:
            self._back_buffer = frame
            self._fresh = True

    def update_rendering_fps(self, fps: float) -> None:
        self._rendering_fps = fps
        if self._native is not None:
            self._native.set_rendering_fps(fps)

    @property
    def printing_fps(self) -> float:
        if self._native is not None:
            return self._native.printing_fps
        return self._printing_fps

    # -- print thread (PrintMachine::Print) ----------------------------------

    def _print_loop(self) -> None:
        current = b""
        last_overlay: bytes | None = None
        fps_t0 = time.perf_counter()
        try:
            while True:
                fresh = False
                with self._lock:
                    if self._fresh:
                        current = self._back_buffer
                        self._fresh = False
                        fresh = True
                if self._terminate and not fresh:
                    # Drain-on-stop: a frame published just before cleanup()
                    # still gets one blit (a short --frames run must not
                    # exit with zero output); leave once nothing is pending.
                    break
                if not current:
                    if self._terminate:
                        break
                    time.sleep(0.002)
                    continue
                overlay = b""
                if self._show_fps:
                    overlay = (
                        f"\x1b[0mRendering FPS: {self._rendering_fps:8.1f}\n"
                        f"Printing  FPS: {self._printing_fps:8.1f}"
                    ).encode()
                if not fresh and overlay == last_overlay:
                    # Nothing changed since the last blit: re-writing the
                    # identical bytes at ~500 Hz is pure wasted terminal
                    # bandwidth (the reference does exactly that,
                    # PrintMachine.cpp:257-306 - deliberately not kept).
                    # The held frame re-blits only when the overlay text
                    # changes (1 Hz FPS updates).
                    time.sleep(0.002)
                    continue
                t_start = time.perf_counter()
                chunks = [_CURSOR_HOME, current]
                if overlay:
                    chunks.append(overlay)
                last_overlay = overlay
                self._out.write(b"".join(chunks))
                self._out.flush()
                self._print_count += 1
                now = time.perf_counter()
                if now - fps_t0 >= 1.0:  # 1 Hz like PrintMachine.cpp:266-272
                    self._printing_fps = self._print_count / (now - fps_t0)
                    self._print_count = 0
                    fps_t0 = now
                if self._min_period:
                    sleep = self._min_period - (now - t_start)
                    if sleep > 0:
                        time.sleep(sleep)
        finally:
            self._running = False

    # -- terminal management --------------------------------------------------

    def _is_tty(self) -> bool:
        try:
            return self._out.isatty()
        except Exception:
            return False

    def _setup_terminal(self) -> None:
        if not self._is_tty():
            return
        seq = _ALT_SCREEN_ON + _HIDE_CURSOR + _CLEAR + _CURSOR_HOME
        seq += b"\x1b]0;" + self._title.encode() + b"\x07"  # title (PrintMachine.cpp:128)
        self._out.write(seq)
        self._out.flush()

    def _restore_terminal(self) -> None:
        if not self._is_tty():
            return
        self._out.write(_RESET + _SHOW_CURSOR + _ALT_SCREEN_OFF)
        self._out.flush()

    def _install_signal_handlers(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return

        def handler(signum, frame):
            self._terminate = True

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                self._prev_handlers[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):
                pass

    def _restore_signal_handlers(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
