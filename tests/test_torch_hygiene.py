"""The port stands alone: no module of rtwc_tpu_torch, and nothing
chip_smoke.py imports, pulls in jax or the JAX package; the port's config
copy has the JAX package's fields and defaults; and its builds read only
sources that lie under rtwc_tpu_torch/ (the native C++ copies are identical
to the JAX package's, the rule that a fix goes to both)."""
import dataclasses
import filecmp
import os
import subprocess
import sys

import rtwc_tpu.config as JCFG
import rtwc_tpu_torch
import rtwc_tpu_torch.config as TCFG
from rtwc_tpu_torch.io import native
from rtwc_tpu_torch.render import _cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(rtwc_tpu_torch.__file__))


def test_port_and_chip_smoke_import_no_jax():
    """In a fresh interpreter (the root conftest imports JAX into this one)."""
    code = (
        "import pkgutil, sys\n"
        "import rtwc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(rtwc_tpu_torch.__path__, 'rtwc_tpu_torch.')\n"
        "         if not m.name.endswith('__main__')]  # running it would start the CLI\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'rtwc_tpu')\n"
        "       or m.startswith(('jax.', 'rtwc_tpu.', 'jaxlib'))]\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "print('IMPORTED', len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=180, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "IMPORTED" in proc.stdout


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default
        out.append((f.name, getattr(default, "value", default)))
    return out


def test_config_copy_has_the_jax_fields_and_defaults():
    assert _fields(TCFG.RenderConfig) == _fields(JCFG.RenderConfig)
    assert _fields(TCFG.EngineConfig) == _fields(JCFG.EngineConfig)
    assert [m.value for m in TCFG.RenderMode] == [m.value for m in JCFG.RenderMode]
    assert _fields(type(TCFG.DEFAULT_RENDER_CONFIG)) == _fields(JCFG.RenderConfig)
    assert TCFG.RenderConfig().fov == JCFG.RenderConfig().fov
    assert TCFG.RenderConfig.__module__ == "rtwc_tpu_torch.config"


def test_builds_read_only_the_ports_sources():
    for src in (native._SRC, native._PRINT_SRC):
        assert os.path.commonpath([os.path.abspath(src), PKG]) == PKG, src
        assert os.path.exists(src)
        twin = os.path.join(ROOT, "rtwc_tpu", "io", "native", os.path.basename(src))
        assert filecmp.cmp(src, twin, shallow=False), f"{src} and {twin} differ"
    assert os.path.commonpath([_cuda.SRC_DIR, PKG]) == PKG
    assert {"hard_render.cu", "soft_render.cu", "soft_shadow.cu"} <= set(os.listdir(_cuda.SRC_DIR))
