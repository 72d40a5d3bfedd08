"""The Python-tail flags on the port's all-device path (device events,
device chain DP): PAF and stderr byte for byte equal to the JAX engine's
on host-detected events, since the port's device detector follows the
native one bit for bit. Under CIGAR output the events come back in the
stage1 download and the DTW reads a per-round uploaded event pool.
Dataset and helpers: ``test_torch_flags``."""

import pytest

from test_torch_flags import (  # noqa: F401  (fixtures)
    FLAG_SETS,
    _need_native,
    check_flags,
    flag_setup,
)


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_flags_all_device_match_jax(flag_setup, capsys, name):
    check_flags(flag_setup, capsys, name, jax_chain="native",
                stage1_impl="device", chain_impl="device")
