"""The Python-tail flags with the chaining DP on the device (hybrid
stage1): the port against the JAX engine's device chain path, PAF and
stderr byte for byte. Dataset and helpers: ``test_torch_flags``."""

import pytest

from test_torch_flags import (  # noqa: F401  (fixtures)
    FLAG_SETS,
    _need_native,
    check_flags,
    flag_setup,
)


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_flags_hybrid_device_chain_match_jax(flag_setup, capsys, name):
    check_flags(flag_setup, capsys, name, jax_chain="device",
                chain_impl="device")
