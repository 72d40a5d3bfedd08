"""The port imports nothing of JAX and nothing of the JAX package, nor
does its benchmark.

Two checks: every module of ``rawalign_tpu_torch`` and of ``bench_torch``
imported in a fresh interpreter leaves no ``jax`` and no ``rawalign_tpu``
module in ``sys.modules``; and the source of both packages and of
``chip_smoke.py``,
strings and comments included, names the JAX package nowhere except as a
file path (``rawalign_tpu/...``): the docstrings say which file each copy
mirrors and the kernel record names the TPU kernel each CUDA kernel
replaces, and a path is read by people, never imported.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX package's name as a module (dotted, quoted, alone), not as the
#: port's prefix and not as the start of a file path
JAX_PACKAGE = re.compile(r"rawalign_tpu(?!_torch|/)")

IMPORT_ALL = """
import importlib, pkgutil, sys
import bench_torch, rawalign_tpu_torch
names = [m.name for pkg in (rawalign_tpu_torch, bench_torch)
         for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "rawalign_tpu")
             or k.startswith(("jax.", "rawalign_tpu.")))
print(len(names))
print(bad)
"""


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for pkg in ("rawalign_tpu_torch", "bench_torch"):
        for root, _dirs, files in os.walk(os.path.join(REPO, pkg)):
            out += [os.path.join(root, f) for f in files
                    if f.endswith((".py", ".cu", ".cuh", ".json"))]
    return sorted(out)


def test_importing_every_module_loads_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().splitlines()
    assert int(n) >= 45  # the port's own modules, its host copies, the benchmark
    assert bad == "[]"


LOAD_ONE = """
import importlib, pkgutil, sys
import rawalign_tpu_torch
walked = [m.name for m in pkgutil.walk_packages(rawalign_tpu_torch.__path__,
                                                "rawalign_tpu_torch.")]
importlib.import_module(sys.argv[1])
print(sys.argv[1] in walked)
print(sorted(k for k in sys.modules if k in ("jax", "rawalign_tpu")
             or k.startswith(("jax.", "rawalign_tpu."))))
"""


@pytest.mark.parametrize("module", [
    "rawalign_tpu_torch.golden.index", "rawalign_tpu_torch.cli",
    "rawalign_tpu_torch.runtime",
])
def test_the_last_ported_modules_load_neither_jax_nor_the_jax_package(module):
    """Each is among the modules the walk above imports, and alone in a
    fresh interpreter it loads no ``jax`` and no ``rawalign_tpu``."""
    proc = subprocess.run([sys.executable, "-c", LOAD_ONE, module], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["True", "[]"]


def test_sources_name_the_jax_package_only_as_a_path():
    hits = []
    for path in _sources():
        with open(path) as f:
            for k, line in enumerate(f, 1):
                if JAX_PACKAGE.search(line):
                    hits.append(f"{os.path.relpath(path, REPO)}:{k}: {line.strip()}")
    assert len(_sources()) >= 40
    assert any(os.sep + "bench_torch" + os.sep in p for p in _sources())
    assert not hits, "\n".join(hits)


@pytest.mark.parametrize("text,named", [
    ("from rawalign_tpu import native", True),
    ("import rawalign_tpu.config", True),
    ("from rawalign_tpu.golden import engine", True),
    ("importlib.import_module('rawalign_tpu')", True),
    ('"rawalign_tpu"', True),
    ("from rawalign_tpu_torch import native", False),
    ('"replaces": "rawalign_tpu/map/chain_pallas.py:162"', False),
])
def test_the_scan_tells_a_module_from_a_path(text, named):
    assert bool(JAX_PACKAGE.search(text)) == named
