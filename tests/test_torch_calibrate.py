"""The calibration chains of the port (rtwc_tpu_torch/utils/calibrate.py,
csrc/calibrate.cu) against scripts/calibrate_roofline.py.

JAX's support chain and twelve bodies are copied here from the script (it
builds them inside main(), so they cannot be imported), constants and all;
log1p, which JAX does not measure, is JAX's log body with jnp.log1p. Beside
each stands its mirror in the port's form, v = fma(core(v, C), A, B), with
C, A and B typed from the same source line, never read from the port.

- One application of each mirror agrees with JAX's own body within 1e-6 of
  the magnitude of the terms it sums, |core * A| + |B| (a few ulps: the
  port rounds JAX's multiply and add once, and writes lax.rsqrt as
  1 / sqrt and the logistic explicitly). A factor wrong by 1e-4 relative
  (one chain's c) fails it.
- The port's chain_plain agrees with JAX's `_chain_kernel` running the
  mirror, on numpy buffers: same seeded inputs, 16 iterations of 16
  applications, within 1e-5 relative (XLA's exp / log / tanh differ from
  torch's by ulps; the chains contract, so that does not grow).

The exactly emulated fma is held to the exact rational a * b + c."""
import importlib.util
import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtwc_tpu_torch.utils import calibrate as CB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 16
RTOL = 1e-5
STEP_RTOL = 1e-6


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "calibrate_roofline", os.path.join(ROOT, "scripts", "calibrate_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# calibrate_roofline.py:103 (the support chain) and :108-119 (the bodies).
_JAX_BODIES = {
    "fma": lambda x, c: x * (0.999 * c) + 6.0e-4,
    "mul": lambda x, c: (x * c) * 0.999 + 6.0e-4,
    "add": lambda x, c: (x + (c - 1.0)) * 0.999 + 6.0e-4,
    "max": lambda x, c: jnp.maximum(x, 0.1 * c) * 0.999 + 6.0e-4,
    "abs": lambda x, c: jnp.abs(x) * (0.999 * c) + 6.0e-4,
    "select": lambda x, c: jnp.where(x > 0.5, x, 0.5 * c) * 0.999 + 6.0e-4,
    "exp": lambda x, c: jnp.exp(x) * (0.25 * c) + 0.1,
    "log": lambda x, c: jnp.log(x) * (-0.5 * c) + 0.3,
    "rsqrt": lambda x, c: jax.lax.rsqrt(x) * (0.5 * c) + 0.2,
    "sqrt": lambda x, c: jnp.sqrt(x) * (0.8 * c) + 0.1,
    "div": lambda x, c: ((0.7 * c) / x) * 0.5 + 0.2,
    "logistic": lambda x, c: jax.nn.sigmoid(x) * (0.8 * c) + 0.1,
    "tanh": lambda x, c: jnp.tanh(x) * (0.8 * c) + 0.2,
    # not in JAX's harness: its log body with log1p
    "log1p": lambda x, c: jnp.log1p(x) * (-0.5 * c) + 0.3,
}

# The same bodies in the port's form: (core(x, c), A(c), B), typed from the
# lines above.
_MIRRORS = {
    "fma": (lambda x, c: x, lambda c: 0.999 * c, 6.0e-4),
    "mul": (lambda x, c: x * c, lambda c: 0.999, 6.0e-4),
    "add": (lambda x, c: x + (c - 1.0), lambda c: 0.999, 6.0e-4),
    "max": (lambda x, c: jnp.maximum(x, 0.1 * c), lambda c: 0.999, 6.0e-4),
    "abs": (lambda x, c: jnp.abs(x), lambda c: 0.999 * c, 6.0e-4),
    "select": (lambda x, c: jnp.where(x > 0.5, x, 0.5 * c), lambda c: 0.999, 6.0e-4),
    "exp": (lambda x, c: jnp.exp(x), lambda c: 0.25 * c, 0.1),
    "log": (lambda x, c: jnp.log(x), lambda c: -0.5 * c, 0.3),
    "rsqrt": (lambda x, c: 1.0 / jnp.sqrt(x), lambda c: 0.5 * c, 0.2),
    "sqrt": (lambda x, c: jnp.sqrt(x), lambda c: 0.8 * c, 0.1),
    "div": (lambda x, c: (0.7 * c) / x, lambda c: 0.5, 0.2),
    "logistic": (lambda x, c: 1.0 / (1.0 + jnp.exp(-x)), lambda c: 0.8 * c, 0.1),
    "tanh": (lambda x, c: jnp.tanh(x), lambda c: 0.8 * c, 0.2),
    "log1p": (lambda x, c: jnp.log1p(x), lambda c: -0.5 * c, 0.3),
}


def _mirror(op):
    """v = fmaf(core(v, c), A(c), B) in jnp (run under jax.enable_x64): the
    multiply-add in float64 (exact product, one rounding of the sum, then
    float32: the fma's result but for a double-rounding tie, about 2^-29 of
    the time)."""
    core, af, b = _MIRRORS[op]

    def body(x, c):
        a32, b32 = float(np.float32(af(c))), float(np.float32(b))
        return (core(x, c).astype(jnp.float64) * a32 + b32).astype(jnp.float32)
    return body


def _x():
    return np.random.default_rng(7).uniform(0.4, 0.8, 1024).astype(np.float32)


def test_every_port_body_has_a_jax_body():
    assert set(_JAX_BODIES) == set(_MIRRORS) == set(CB.OPS)


@pytest.mark.parametrize("op", list(_JAX_BODIES))
def test_mirror_is_the_jax_body(op):
    core, af, b = _MIRRORS[op]
    x = jnp.asarray(np.linspace(0.05, 1.6, 512, dtype=np.float32))
    for k in range(CB.NCHAIN):
        c = 1.0 + 1e-4 * k
        ref = np.asarray(_JAX_BODIES[op](x, c))
        with jax.enable_x64(True):
            got = np.asarray(_mirror(op)(x, c))
        assert got.dtype == ref.dtype == np.float32
        terms = np.abs(np.asarray(core(x, c), np.float64) * af(c)) + abs(b)
        excess = np.abs(got.astype(np.float64) - ref) - STEP_RTOL * terms
        assert excess.max() <= 0.0, (op, k, excess.max())


@pytest.mark.parametrize("op", list(_JAX_BODIES))
def test_chain_plain_matches_jax_chain_kernel(op):
    mod = _jax_script()
    assert (mod.NCHAIN, mod.DEPTH) == (CB.NCHAIN, CB.DEPTH)
    x = _x()
    outs = [np.empty_like(x) for _ in range(CB.NCHAIN)]
    with jax.enable_x64(True):
        mod._chain_kernel(_mirror(op), ITERS, x, *outs)
    ref = np.stack(outs)
    got = CB.chain_plain(op, torch.from_numpy(x), ITERS).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


def test_chain_kernel_on_cpu_runs_the_plain_version():
    x = torch.full((64,), 0.6)
    before = CB.LAUNCHES
    assert torch.equal(CB.chain_kernel("log1p", x, 2), CB.chain_plain("log1p", x, 2))
    assert CB.LAUNCHES == before
    with pytest.raises(ValueError):
        CB.chain_kernel("pow", x, 2)


def test_fma_is_correctly_rounded():
    rng = np.random.default_rng(0)
    n = 400
    a = rng.uniform(-2, 2, n).astype(np.float32)
    b = rng.uniform(-2, 2, n).astype(np.float32)
    c = (rng.uniform(-1, 1, n) * 10.0 ** rng.integers(-9, 2, n)).astype(np.float32)
    r = CB.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        err = abs(exact - Fraction(float(r[i])))
        for nb in (np.nextafter(r[i], np.float32(np.inf)), np.nextafter(r[i], np.float32(-np.inf))):
            other = abs(exact - Fraction(float(nb)))
            assert err < other or (err == other and not int(r[i:i + 1].view(np.int32)[0]) & 1)


def test_constants_round_once_from_double():
    init, cc, aa, bb = CB.constants("fma")
    assert init.dtype == np.float32 and init[2] == np.float32(1.0 + 0.01 * 2)
    assert aa[3] == np.float32(0.999 * (1.0 + 1e-4 * 3)) and bb[0] == np.float32(6.0e-4)
    assert CB.constants("div")[1][1] == np.float32(0.7 * (1.0 + 1e-4))


@pytest.mark.parametrize("s, s_fma, n, want", [(3.0, 1.0, 1, 2.0), (5.0, 1.0, 2, 2.0),
                                                (0.5, 1.0, 1, 0.0), (1.0, 1.0, 1, 0.0)])
def test_slots_formula(s, s_fma, n, want):
    assert CB.slots(s, s_fma, n) == pytest.approx(want)


def test_main_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "rtwc_tpu_torch.utils.calibrate"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == "" and "CUDA" in proc.stderr


def test_cuda_request_raises_without_a_card():
    """A CUDA request never quietly runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs")
    before = CB.LAUNCHES
    with pytest.raises((RuntimeError, AssertionError)):
        CB.slope("fma", "cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        CB.calibrate("cuda")
    with pytest.raises(RuntimeError):
        CB.slope("fma", "cpu")
    assert CB.LAUNCHES == before
