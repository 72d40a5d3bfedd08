"""The port's device chain path (hybrid stage1, chaining DP on the
device, the Python round tail) and its all-device path against the JAX
engine's same paths and the golden engine, on the dataset and helpers of
``test_torch_engine.py`` (in a file of their own so that the two files
run in parallel under pytest-xdist). PAF lines are compared byte for
byte (mt:f stripped), except against the JAX engine's float32 device
event detector (see ``test_torch_engine._close_to``).
"""

import re

import pytest

from test_torch_engine import (  # noqa: F401  (fixtures)
    JaxEngine,
    _close_to,
    _map,
    _need_native,
    _port,
    golden,
    setup,
)

#: the JAX engine's DTW tiles all run in the native library, bit-identical
#: to its device DTW (the JAX package's own tests pin that), which spares
#: the XLA compiles of its DTW classes on the CPU
JAX_DTW_ON_HOST = dict(dtw_device_max_n=0, dtw_device_max_b=0)


@pytest.mark.parametrize("window", [2048, 64])
@pytest.mark.parametrize("use_dtw", [False, True])
def test_device_chain_matches_jax_device_chain_and_golden(setup, golden,
                                                          use_dtw, window):
    """Hybrid stage1, chain DP on the device, the Python round tail."""
    _ds, idx, reads = setup
    got, eng = _port(idx, reads, use_dtw, chain_impl="device",
                     chain_window=window)
    assert eng.chain_impl == "device" and eng.stage1_impl == "hybrid"
    want, _ = _map(JaxEngine, idx, reads, use_dtw, stage1_impl="hybrid",
                   chain_impl="device", chain_window=window, **JAX_DTW_ON_HOST)
    assert got == want
    assert got == golden(use_dtw)


def test_all_device_matches_golden_and_jax_within_tolerance(setup, golden):
    _ds, idx, reads = setup
    got, eng = _port(idx, reads, True, stage1_impl="device", chain_impl="device")
    assert got == golden(True)
    chunks = [int(re.search(r"ci:i:(\d+)", ln).group(1)) for ln in got.values()]
    assert max(chunks) == 3
    want, _ = _map(JaxEngine, idx, reads, True, stage1_impl="device",
                   chain_impl="device", **JAX_DTW_ON_HOST)
    n_same = 0
    for name, line in got.items():
        if line == want[name]:
            n_same += 1
        else:
            assert _close_to(line, want[name]), (name, want[name], line)
    assert n_same >= int(0.8 * len(got))
