"""Measure, on the card, the marginal cost of every primitive the roofline
model weights (utils/roofline.py), in FMA slots, and the FMA and device
memory rates.

    python -m rtwc_tpu_torch.utils.calibrate    # needs a CUDA card; prints one JSON line

Port of scripts/calibrate_roofline.py. Its Pallas `_chain_kernel` is
csrc/calibrate.cu (`chain_kernel<Op>`): NCHAIN = 4 independent float32
chains a thread in registers, DEPTH = 16 applications of the body per loop
iteration, `iters` iterations, a grid that fills every SM. Each body is the
op followed by a stabilising multiply-add, v = fma(op(v, C), A, B), whose
constants keep the chain in the op's domain forever and differ per chain
(c = 1 + 1e-4 k), so no two chains merge.

The time of one application is the SLOPE of the best of REPS CUDA-event times
at two iteration counts, which cancels the launch and the chains' loads and
stores. An op's weight is its marginal slowdown of the FMA chain:
slots = max(0, (slope(op) - slope(fma)) / n / slope(fma)) with n ops a body
(`slots`, calibrate_roofline.py:135).

`chain_kernel` launches the kernel on CUDA tensors (counting launches in
LAUNCHES) and runs `chain_plain`, its torch twin, on CPU tensors only;
`main` refuses to run without a card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from rtwc_tpu_torch.render import _cuda

NCHAIN = 4
DEPTH = 16
THREADS = 256
I1, I2 = 2048, 8192       # the two iteration counts of a slope
REPS = 5
HBM_BYTES = 256 * 2**20   # the device-to-device copy that gives the memory rate
X0 = 0.6                  # the chains' start, as jnp.full(SHAPE, 0.6)

# name -> (n ops a body, C(c), A(c), B): v = fma(core(v, C), A, B), each
# constant computed from c = 1 + 1e-4 k in double and rounded to float32 once,
# as JAX rounds its Python-float constants (calibrate_roofline.py:103-120).
BODIES = {
    "fma": (0, lambda c: 0.0, lambda c: 0.999 * c, 6.0e-4),
    "mul": (1, lambda c: c, lambda c: 0.999, 6.0e-4),
    "add": (1, lambda c: c - 1.0, lambda c: 0.999, 6.0e-4),
    "max": (1, lambda c: 0.1 * c, lambda c: 0.999, 6.0e-4),
    "abs": (1, lambda c: 0.0, lambda c: 0.999 * c, 6.0e-4),
    "select": (2, lambda c: 0.5 * c, lambda c: 0.999, 6.0e-4),
    "exp": (1, lambda c: 0.0, lambda c: 0.25 * c, 0.1),
    "log": (1, lambda c: 0.0, lambda c: -0.5 * c, 0.3),
    "log1p": (1, lambda c: 0.0, lambda c: -0.5 * c, 0.3),
    "rsqrt": (1, lambda c: 0.0, lambda c: 0.5 * c, 0.2),
    "sqrt": (1, lambda c: 0.0, lambda c: 0.8 * c, 0.1),
    "div": (1, lambda c: 0.7 * c, lambda c: 0.5, 0.2),
    "logistic": (1, lambda c: 0.0, lambda c: 0.8 * c, 0.1),
    "tanh": (1, lambda c: 0.0, lambda c: 0.8 * c, 0.2),
}
OPS = tuple(BODIES)  # the kernel's Op ids, in this order
# Bodies whose kernel and plain version give the same bits (IEEE-exact ops
# and the emulated fma); the others agree within INEXACT_RTOL.
EXACT = ("mul", "add", "max", "abs", "select", "sqrt", "div")
INEXACT_RTOL = 1e-5

LAUNCHES = 0  # CUDA launches of the chain kernel in this process


class ChainParams(ctypes.Structure):
    """Mirror of `struct ChainParams` in csrc/calibrate.cu."""

    _fields_ = [("op", ctypes.c_int), ("n", ctypes.c_int), ("iters", ctypes.c_int),
                ("device", ctypes.c_int),
                ("init", ctypes.c_float * NCHAIN), ("c", ctypes.c_float * NCHAIN),
                ("a", ctypes.c_float * NCHAIN), ("b", ctypes.c_float * NCHAIN)]


def constants(op: str):
    """(init, C, A, B): float32 arrays [NCHAIN] of chain k's start factor
    1 + 0.01 k and its body constants."""
    _, cf, af, b = BODIES[op]
    cs = [1.0 + 1e-4 * k for k in range(NCHAIN)]
    f32 = lambda vals: np.asarray(vals, dtype=np.float64).astype(np.float32)  # noqa: E731
    return (f32([1.0 + 0.01 * k for k in range(NCHAIN)]), f32([cf(c) for c in cs]),
            f32([af(c) for c in cs]), f32([b] * NCHAIN))


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) on float32 tensors: a * b + c rounded once. The product
    is exact in float64; the sum is rounded to odd in float64 (a two_sum gives
    its error), and rounding that to float32 is then the correctly rounded
    result (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _core(op: str, v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The body's op in the kernel's form (csrc/calibrate.cu `core`)."""
    if op == "fma":
        return v
    if op == "mul":
        return v * c
    if op == "add":
        return v + c
    if op == "max":
        return torch.maximum(v, c)
    if op == "abs":
        return v.abs()
    if op == "select":
        return torch.where(v > 0.5, v, c)
    if op == "exp":
        return torch.exp(v)
    if op == "log":
        return torch.log(v)
    if op == "log1p":
        return torch.log1p(v)
    if op == "rsqrt":
        return 1.0 / torch.sqrt(v)
    if op == "sqrt":
        return torch.sqrt(v)
    if op == "div":
        return c / v
    if op == "logistic":
        return 1.0 / (1.0 + torch.exp(-v))
    if op == "tanh":
        return torch.tanh(v)
    raise ValueError(f"unknown body {op!r}; one of {OPS}")


def chain_plain(op: str, x: torch.Tensor, iters: int) -> torch.Tensor:
    """The kernel's chains in torch ops: [NCHAIN, n] float32."""
    init, cc, aa, bb = (torch.from_numpy(t).to(x.device)[:, None] for t in constants(op))
    v = x[None, :] * init
    for _ in range(iters * DEPTH):
        v = fma(_core(op, v, cc), aa, bb)
    return v


def _check(op: str, x: torch.Tensor, iters: int):
    if op not in BODIES:
        raise ValueError(f"unknown body {op!r}; one of {OPS}")
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.dim() != 1 \
            or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("x must be a non-empty contiguous 1-d float32 tensor")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the chain kernel runs on cuda or cpu, not {x.device}")


def chain_kernel(op: str, x: torch.Tensor, iters: int) -> torch.Tensor:
    """Run body `op` for `iters` iterations: [NCHAIN, n] float32 chains. On a
    CUDA tensor it launches csrc/calibrate.cu (raising on a CUDA error); on a
    CPU tensor it runs chain_plain."""
    global LAUNCHES
    _check(op, x, iters)
    if x.device.type == "cpu":
        return chain_plain(op, x, iters)
    fn = _kernel_fn()
    out = torch.empty((NCHAIN, x.numel()), dtype=torch.float32, device=x.device)
    init, cc, aa, bb = constants(op)
    arr = ctypes.c_float * NCHAIN
    prm = ChainParams(op=OPS.index(op), n=x.numel(), iters=iters,
                      device=x.device.index if x.device.index is not None
                      else torch.cuda.current_device(),
                      init=arr(*init), c=arr(*cc), a=arr(*aa), b=arr(*bb))
    rc = fn(x.data_ptr(), out.data_ptr(), ctypes.byref(prm),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rtwc_chain launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def _kernel_fn():
    fn = _cuda.load("calibrate").rtwc_chain
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ChainParams),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def full_occupancy_elems(dev) -> int:
    """Threads that fill every SM of `dev` at full occupancy."""
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count * getattr(props, "max_threads_per_multi_processor", 2048)


def _best_ms(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def slope(op: str, dev) -> float:
    """Seconds per application of body `op` to all NCHAIN chains of a grid
    that fills the card: (best time at I2 - best time at I1) / ((I2 - I1) *
    DEPTH), after a warm-up launch at I2. `dev` must be a CUDA device."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        raise RuntimeError(f"slope times the CUDA kernel; {dev} is not a CUDA device")
    x = torch.full((full_occupancy_elems(dev),), X0, dtype=torch.float32, device=dev)
    chain_kernel(op, x, I2)  # warm-up: build, load, clocks up
    t1 = _best_ms(lambda: chain_kernel(op, x, I1), REPS)
    t2 = _best_ms(lambda: chain_kernel(op, x, I2), REPS)
    return (t2 - t1) * 1e-3 / ((I2 - I1) * DEPTH)


def slots(s: float, s_fma: float, n: int) -> float:
    """An op's marginal cost in FMA slots (calibrate_roofline.py:135)."""
    return max(0.0, (s - s_fma) / n / s_fma)


def hbm_bytes_per_s(dev) -> float:
    """Device memory rate of a 256 MB device-to-device copy, read + write."""
    src = torch.empty(HBM_BYTES // 4, dtype=torch.float32, device=dev).uniform_()
    dst = torch.empty_like(src)
    dst.copy_(src)
    return 2.0 * HBM_BYTES / (_best_ms(lambda: dst.copy_(src), REPS) * 1e-3)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def calibrate(dev) -> dict:
    """Every body's slope, the FMA rate, the slot weights and the memory
    rate, on CUDA device `dev`."""
    dev = torch.device(dev)
    n = full_occupancy_elems(dev)
    elems = n * NCHAIN
    s_fma = slope("fma", dev)
    out = {"shape": [n], "nchain": NCHAIN, "depth": DEPTH, "fma_ops_per_s": elems / s_fma,
           "slots": {}, "slope_ns": {"fma": s_fma * 1e9}}
    for op, (n_ops, *_) in BODIES.items():
        if op == "fma":
            continue
        s = slope(op, dev)
        out["slope_ns"][op] = s * 1e9
        out["slots"][op] = slots(s, s_fma, n_ops)
    out["hbm_bytes_per_s"] = hbm_bytes_per_s(dev)
    return out


def sass_counts() -> dict:
    """Instructions of each chain_kernel<Op> in the built library
    (cuobjdump -sass), by opcode: {op: {opcode: count}}; the loop body holds
    NCHAIN x DEPTH applications."""
    so = _cuda.build("calibrate")
    tool = os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            name = s.split(":", 1)[1].strip()
            cur = None
            # _Z12chain_kernelILi<op>EEv11ChainParamsPKfPf
            if "chain_kernel" in name:
                cur = OPS[int(name.split("ILi", 1)[1].split("E", 1)[0])]
                counts[cur] = {}
        elif cur is not None and s.startswith("/*") and "*/" in s:
            body = s.split("*/", 1)[1].strip()
            if not body or body.startswith("/*"):
                continue
            toks = body.replace(";", " ").split()
            if toks[0].startswith("@"):
                toks = toks[1:]
            opcode = toks[0].split(".")[0]
            counts[cur][opcode] = counts[cur].get(opcode, 0) + 1
    return counts


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("rtwc_tpu_torch.utils.calibrate must run on a CUDA card (torch finds none)",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    res = calibrate(dev)
    card = card_line()
    res["device"] = {"name": torch.cuda.get_device_name(dev), "nvidia_smi": card}
    print(f"# {card}: fma {res['fma_ops_per_s'] / 1e12:.3f} T elem-ops/s; memory "
          f"{res['hbm_bytes_per_s'] / 1e9:.1f} GB/s", file=sys.stderr)
    for op in res["slots"]:
        print(f"# {op:9s}: slope {res['slope_ns'][op]:8.4f} ns/app -> {res['slots'][op]:6.2f} "
              f"FMA slots", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
