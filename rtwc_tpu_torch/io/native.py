"""ctypes loader for the native C++ ANSI encoder and print machine.

Counterpart: rtwc_tpu/io/native/__init__.py:19-146. The C++ sources are
the port's own copies, rtwc_tpu_torch/io/native/ansi_encoder.cpp and
print_machine.cpp, of rtwc_tpu/io/native/*.cpp; the two copies are
identical, and a fix to either goes to both. They are compiled with g++
into rtwc_tpu_torch/io/_build/, atomically (temp file + rename), and
rebuilt when a source is newer than its library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

from rtwc_tpu_torch.utils.telemetry import span

_NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_SRC = os.path.join(_NATIVE_SRC, "ansi_encoder.cpp")
_PRINT_SRC = os.path.join(_NATIVE_SRC, "print_machine.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_libs: dict[str, ctypes.CDLL] = {}


def _compile(src: str, lib_name: str, extra_flags=()) -> str:
    """Build src -> _build/lib_name if stale; returns the .so path. Raises
    RuntimeError with g++'s output on failure."""
    so = os.path.join(BUILD_DIR, lib_name)
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                               *extra_flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {src}: {proc.stderr[-2000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load_encoder() -> ctypes.CDLL:
    lib = _libs.get("ansi")
    if lib is None:
        lib = ctypes.CDLL(_compile(_SRC, "librtwc_ansi.so"))
        lib.rtwc_encode_frame.restype = ctypes.c_int64
        lib.rtwc_encode_frame.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
        ]
        _libs["ansi"] = lib
    return lib


def encode_frame_native(kind: np.ndarray, color: np.ndarray, char: np.ndarray) -> bytes:
    """C++ encode; same byte contract as heads.encode.encode_frame_numpy."""
    lib = _load_encoder()
    H, W = kind.shape
    truecolor = 1 if color.ndim == 3 else 0
    kind32 = np.ascontiguousarray(kind, np.int32)
    color32 = np.ascontiguousarray(color, np.int32)
    char32 = np.ascontiguousarray(char, np.int32)
    out = np.empty(H * W * 20 + H, np.uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    with span("encode.native"):
        n = lib.rtwc_encode_frame(kind32.ctypes.data_as(p32), color32.ctypes.data_as(p32),
                                  char32.ctypes.data_as(p32), H, W, truecolor,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:n].tobytes()


def _load_print() -> ctypes.CDLL:
    lib = _libs.get("print")
    if lib is None:
        lib = ctypes.CDLL(_compile(_PRINT_SRC, "librtwc_print.so", extra_flags=("-pthread",)))
        lib.rtwc_printer_start.restype = ctypes.c_void_p
        lib.rtwc_printer_start.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double]
        lib.rtwc_printer_publish.restype = None
        lib.rtwc_printer_publish.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                             ctypes.c_int64]
        lib.rtwc_printer_set_rendering_fps.restype = None
        lib.rtwc_printer_set_rendering_fps.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.rtwc_printer_printing_fps.restype = ctypes.c_double
        lib.rtwc_printer_printing_fps.argtypes = [ctypes.c_void_p]
        lib.rtwc_printer_running.restype = ctypes.c_int
        lib.rtwc_printer_running.argtypes = [ctypes.c_void_p]
        lib.rtwc_printer_stop.restype = None
        lib.rtwc_printer_stop.argtypes = [ctypes.c_void_p]
        _libs["print"] = lib
    return lib


class NativePrintMachine:
    """ctypes handle on the C++ print thread (print_machine.cpp): the blit
    runs outside the GIL; Python only publishes encoded frames."""

    def __init__(self, fd: int, show_fps: bool, min_period: float = 0.0):
        self._lib = _load_print()
        self._h = self._lib.rtwc_printer_start(fd, 1 if show_fps else 0, float(min_period))
        if not self._h:
            raise RuntimeError("rtwc_printer_start failed")

    def publish(self, frame: bytes) -> None:
        buf = (ctypes.c_uint8 * len(frame)).from_buffer_copy(frame)
        self._lib.rtwc_printer_publish(self._h, buf, len(frame))

    def set_rendering_fps(self, fps: float) -> None:
        self._lib.rtwc_printer_set_rendering_fps(self._h, float(fps))

    @property
    def printing_fps(self) -> float:
        return float(self._lib.rtwc_printer_printing_fps(self._h))

    def running(self) -> bool:
        return bool(self._lib.rtwc_printer_running(self._h))

    def stop(self) -> None:
        if self._h:
            self._lib.rtwc_printer_stop(self._h)
            self._h = None
