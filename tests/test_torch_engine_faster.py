"""Minimizer seeding (the ``faster`` preset, w=5 e=7) through the port's
engine, against the JAX engine.

The port's minimizer filter follows the JAX package's set semantics, not
golden's ordered ``sketch_min`` (the JAX package holds its own filter to
golden only as a set, ``tests/test_sketch.py``), so the oracle here is
the JAX engine: byte for byte (mt:f stripped) on the hybrid stage1 with
either chain placement, and within the JAX package's own tolerance
against its float32 device event detector. The port's all-device pass
equals its hybrid pass. Dataset: ``test_torch_flags``.
"""

import pytest

from rawalign_tpu import config
from rawalign_tpu.config import MappingFlag as F
from test_torch_engine import _close_to
from test_torch_flags import (  # noqa: F401  (fixtures)
    JAX_KW,
    PORT_KW,
    JaxEngine,
    MappingEngine,
    _need_native,
    build_index,
    dataset,
    run,
)


@pytest.fixture(scope="module")
def faster_setup():
    idx = build_index("faster")
    assert (idx.opt.w, idx.opt.e) == (5, 7)
    return idx, dataset()[1]


def faster_opts() -> config.MappingOptions:
    mo = config.MappingOptions()
    config.set_opt("faster", config.IndexOptions(), mo)
    mo.set_flag(F.DTW_EVALUATE_CHAINS)
    return mo


@pytest.mark.parametrize("chain_impl", ["native", "device"])
def test_faster_matches_jax_hybrid(faster_setup, capsys, chain_impl):
    idx, reads = faster_setup
    mo = faster_opts()
    got, _ = run(MappingEngine, idx, reads, mo, capsys, chain_impl=chain_impl,
                 **PORT_KW)
    want, _ = run(JaxEngine, idx, reads, mo, capsys, chain_impl=chain_impl,
                  **JAX_KW)
    assert got == want
    assert sum(ln.split("\t")[2] != "*" for ln in got.values()) >= 5


def test_faster_all_device_matches_hybrid_and_jax_device(faster_setup, capsys):
    idx, reads = faster_setup
    mo = faster_opts()
    got, _ = run(MappingEngine, idx, reads, mo, capsys, stage1_impl="device",
                 chain_impl="device", **PORT_KW)
    hybrid, _ = run(MappingEngine, idx, reads, mo, capsys, **PORT_KW)
    assert got == hybrid
    want, _ = run(JaxEngine, idx, reads, mo, capsys, stage1_impl="device",
                  dtw_device_max_n=0, dtw_device_max_b=0)
    n_same = 0
    for name, line in got.items():
        if line == want[name]:
            n_same += 1
        else:
            assert _close_to(line, want[name]), (name, want[name], line)
    assert n_same >= int(0.8 * len(got))
