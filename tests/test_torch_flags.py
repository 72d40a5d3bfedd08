"""The flags that finish every round in the Python tail (CIGAR output,
chain output, the DTW score log, the anchor logs), each alone and all
together, on the hybrid stage1 with the native chain DP: the port's PAF
and stderr against the JAX engine's, byte for byte (mt:f stripped), and
the CIGAR PAF against the golden engine's.

The dataset and helpers here are shared with ``test_torch_flags_device``
(the device chain DP) and ``test_torch_flags_all_device`` (device events
and device chain DP), files of their own so that pytest-xdist runs the
three in parallel. Every placement of the port gives the same PAF and
logs, so all three are held to the JAX engine's hybrid stage1 with the
chain placement named in each test.
"""

import functools
import re

import numpy as np
import pytest
import torch

from rawalign_tpu import config
from rawalign_tpu.config import MappingFlag as F
from rawalign_tpu.golden import engine as gengine
from rawalign_tpu.index import index as dindex
from rawalign_tpu.io import paf
from rawalign_tpu.map.engine import MappingEngine as JaxEngine
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import native
from test_torch_engine import MappingEngine, line_of

torch.set_num_threads(1)

ENGINE_KW = dict(batch_size=4, chain_window=2048, max_occ=256)
#: the JAX engine's DTW tiles all run in the native library, bit-identical
#: to its device DTW, which spares the XLA compiles of its tile classes
JAX_KW = dict(stage1_impl="hybrid", dtw_device_max_n=0, dtw_device_max_b=0)
PORT_KW = dict(device="cpu", dtw_device_max_n=256, dtw_device_max_b=256)
FLAG_SETS = {
    "cigar": F.DTW_OUTPUT_CIGAR,
    "chains": F.OUTPUT_CHAINS,
    "log_scores": F.DTW_LOG_SCORES,
    "log_anchors": F.LOG_ANCHORS,
    "log_num_anchors": F.LOG_NUM_ANCHORS,
    "all": (F.DTW_OUTPUT_CIGAR | F.OUTPUT_CHAINS | F.DTW_LOG_SCORES
            | F.LOG_ANCHORS | F.LOG_NUM_ANCHORS),
}


def _strip_time(line: str) -> str:
    return re.sub(r"mt:f:[0-9.]+", "mt:f:X", line)


@pytest.fixture(autouse=True)
def _need_native():
    if not (native.available() and native.events_available()
            and native.round_tail_available()):
        pytest.skip("native host library not built")


@functools.cache
def dataset():
    """A 12 kb genome, five reads that map in their first chunk, one that
    maps only in its second (a noise chunk before a real read: carried
    anchors) and one noise read that runs all three chunks (the stop
    decision)."""
    ds = synth.make_dataset(seed=11, genome_lengths=[12_000], n_reads=5,
                            read_len_bp=(250, 700), noise_pa=1.3)
    rng = np.random.default_rng(5)
    L = config.MappingOptions().chunk_size
    noise = lambda n: rng.normal(95.0, 15.0, n).astype(np.float32)  # noqa: E731
    reads = [(r.name, r.signal) for r in ds.reads] + [
        ("late", np.concatenate([noise(L), ds.reads[1].signal])),
        ("noise", noise(3 * L)),
    ]
    return ds, reads


def build_index(preset: str):
    ds, _ = dataset()
    io = config.IndexOptions()
    config.set_opt(preset, io, config.MappingOptions())
    return dindex.build_index(ds.seqs, ds.model.pore_vals, io)


@pytest.fixture(scope="module")
def flag_setup():
    return build_index("viral"), dataset()[1]


def flag_opts(flags) -> config.MappingOptions:
    """``viral`` with ``flags``; DTW evaluation unless the score log is
    asked for alone (it runs the DTW tiles without evaluating)."""
    mo = config.MappingOptions()
    config.set_opt("viral", config.IndexOptions(), mo)
    mo.flag |= flags
    if flags != F.DTW_LOG_SCORES:
        mo.set_flag(F.DTW_EVALUATE_CHAINS)
    return mo


def run(engine_cls, idx, reads, mo, capsys, **kw):
    """({read name: PAF line}, stderr) of one engine pass."""
    capsys.readouterr()
    eng = engine_cls(idx, mo, **{**ENGINE_KW, **kw})
    lines = {r.read_name: line_of(r) for r in eng.map_reads(reads)}
    eng.close()
    return lines, capsys.readouterr().err


def check_flags(flag_setup, capsys, name, *, jax_chain, **port_kw):
    """The port with ``port_kw`` against the JAX engine (hybrid stage1,
    chain DP ``jax_chain``): PAF and stderr equal; returns the PAF."""
    idx, reads = flag_setup
    flags = FLAG_SETS[name]
    mo = flag_opts(flags)
    got, got_err = run(MappingEngine, idx, reads, mo, capsys, **PORT_KW,
                       **port_kw)
    want, want_err = run(JaxEngine, idx, reads, mo, capsys, chain_impl=jax_chain,
                         **JAX_KW)
    assert got == want
    assert got_err == want_err
    mapped = [ln for ln in got.values() if ln.split("\t")[2] != "*"]
    assert len(mapped) >= 6 and "ci:i:2" in got["late"]
    if flags & F.DTW_OUTPUT_CIGAR:
        assert all("\taln:s:" in ln and "\talns:f:" in ln for ln in mapped)
    if flags & F.OUTPUT_CHAINS:
        assert all("\tanchors:s:" in ln for ln in mapped)
    if flags & F.DTW_LOG_SCORES:
        assert "alignment_score=" in got_err
    if flags & F.LOG_ANCHORS:
        assert "readname=late refname=" in got_err
    if flags & F.LOG_NUM_ANCHORS:
        assert "readname=late pos=[" in got_err
    return got


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_flags_hybrid_native_match_jax(flag_setup, capsys, name):
    got = check_flags(flag_setup, capsys, name, jax_chain="native")
    if FLAG_SETS[name] & F.DTW_OUTPUT_CIGAR:
        # the CIGAR lines also equal the golden engine's
        idx, reads = flag_setup
        mo = flag_opts(FLAG_SETS[name])
        capsys.readouterr()
        for rname, sig in reads:
            want = _strip_time(paf.paf_line(gengine.map_read(idx, sig, rname, mo)))
            assert got[rname] == want, rname
