"""The port stands alone: cbf_tpu_torch and chip_smoke.py import neither
jax nor the JAX package (the card machine has no JAX)."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cbf_tpu_torch")
_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|cbf_tpu)\b(?![\w])",
                     re.MULTILINE)


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    return paths


def test_no_jax_or_reference_imports_in_sources():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        offenders += [f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}"
                      for m in _IMPORT.finditer(src)]
        offenders += [f"{os.path.relpath(path, ROOT)}: import_module"
                      for _ in re.finditer(r"import_module\(\s*['\"](jax|"
                                           r"cbf_tpu)\b(?![\w])", src)]
    assert not offenders, offenders
    assert len(_port_sources()) >= 12


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cbf_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "cbf_tpu_torch.__path__, 'cbf_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'cbf_tpu.')) or m == 'cbf_tpu')\n"
        "assert not bad, bad\n"
        "assert len(names) >= 14, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
