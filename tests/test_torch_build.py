"""``kernels/build.py`` without a compiler: a stand-in ``nvcc`` records its
arguments and writes an empty library, so that what ``build.py`` asks of
the compiler, and where it puts the result, can be checked on the CPU.
"""

import os
import stat

import pytest

from rawalign_tpu_torch.kernels import build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$(dirname "$0")/../../calls.txt"
while [ "$1" != "-o" ]; do shift; done
: > "$2"
"""


@pytest.fixture
def fake_nvcc(monkeypatch, tmp_path):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "build_seconds", {})
    return tmp_path / "calls.txt"


@pytest.mark.parametrize("name", build.KERNELS)
def test_each_kernel_is_built_once_with_the_package_flags(fake_nvcc, name):
    so = build._build(name)
    assert os.path.dirname(so) == build.BUILD_DIR and os.path.exists(so)
    assert build._build(name) == so  # found built: no second compiler run
    (call,) = fake_nvcc.read_text().splitlines()
    assert "--fmad=false" in call and "sm_90a" in call
    assert "fast-math" not in call and "-ftz" not in call
    assert call.endswith(os.path.join("csrc", f"{name}.cu"))
    assert build.build_seconds[name] > 0.0
