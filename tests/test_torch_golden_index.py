"""The port's copy of the golden index (``golden/index.py``: a sorted
(hash, y) table and the expected signals, rawindex.cpp:194-246) against
the JAX package's, and the port's production index against it: every
array equal, every query hash of a read batch answered with the same y
values in the same order, and the port's golden engine mapping to the
same PAF on either index. On two presets.
"""

import functools
import re

import numpy as np
import pytest

from rawalign_tpu import config as jconfig
from rawalign_tpu.golden import index as jgindex
from rawalign_tpu.testing import synth as jsynth
from rawalign_tpu_torch import config
from rawalign_tpu_torch.golden import engine as tgolden
from rawalign_tpu_torch.golden import events as gevents
from rawalign_tpu_torch.golden import index as tgindex
from rawalign_tpu_torch.golden import sketch as gsketch
from rawalign_tpu_torch.index import index as tindex
from rawalign_tpu_torch.io import paf
from rawalign_tpu_torch.testing import synth

PRESETS = ["sensitive", "viral"]
DATA = dict(seed=13, genome_lengths=[14_000, 6_000], n_reads=6,
            read_len_bp=(250, 700), noise_pa=1.3)


@functools.cache
def _built(preset):
    """(dataset, options, port golden index, JAX golden index, port
    production index), each index built by its own code from the same
    seeded genome."""
    ds, jds = synth.make_dataset(**DATA), jsynth.make_dataset(**DATA)
    assert [s.seq for s in ds.seqs] == [s.seq for s in jds.seqs]
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt(preset, io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    jio = jconfig.IndexOptions()
    jconfig.set_opt(preset, jio, jconfig.MappingOptions())
    return (ds, io, mo,
            tgindex.build_index(ds.seqs, ds.model.pore_vals, io),
            jgindex.build_index(jds.seqs, jds.model.pore_vals, jio),
            tindex.build_index(ds.seqs, ds.model.pore_vals, io))


@pytest.mark.parametrize("preset", PRESETS)
def test_golden_index_equals_the_jax_golden_index(preset):
    _ds, _io, _mo, got, want, _idx = _built(preset)
    assert got.seq_names == want.seq_names
    for k in ("seq_lens", "sig_lens", "keys", "vals"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype, k
        assert np.array_equal(g, w), k
    for strand in (0, 1):
        assert len(got.signals[strand]) == len(want.signals[strand])
        for g, w in zip(got.signals[strand], want.signals[strand]):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got.keys.size > 1000 and got.n_seq == 2


def _query_hashes(ds, io, mo) -> np.ndarray:
    """Every seed hash of the reads' events, in read order."""
    out = []
    for r in ds.reads:
        ev = gevents.detect_events(r.signal, mo)
        seeds = gsketch.sketch(ev, 0, 0, io.w, io.e, io.n, io.q, io.lq, io.k)
        out.append(seeds[:, 0] >> np.uint64(gsketch.RI_HASH_SHIFT))
    return np.concatenate(out)


@pytest.mark.parametrize("preset", PRESETS)
def test_production_index_answers_as_the_golden_index(preset):
    """The production index (one uint32 key array, id and pos|strand
    apart) holds the golden table, and ``get`` answers every query hash
    of the reads with the golden y values, in order."""
    ds, io, mo, gidx, _jidx, idx = _built(preset)
    assert np.array_equal(idx.keys.astype(np.uint64), gidx.keys)
    y = (idx.val_id.astype(np.uint64) << np.uint64(32)) | idx.val_ps
    assert np.array_equal(y, gidx.vals)
    hashes = _query_hashes(ds, io, mo)
    assert hashes.size > 500
    hits = 0
    for h in hashes:
        got, want = idx.get(int(h)), gidx.get(int(h))
        assert got.dtype == want.dtype and np.array_equal(got, want), int(h)
        hits += want.size
    assert hits > 0


def _strip_time(line: str) -> str:
    return re.sub(r"mt:f:[0-9.]+", "mt:f:X", line)


@pytest.mark.parametrize("preset", PRESETS)
def test_golden_engine_maps_alike_on_either_index(preset):
    ds, _io, mo, gidx, _jidx, idx = _built(preset)
    mapped = 0
    for r in ds.reads:
        on_golden = tgolden.map_read(gidx, r.signal, r.name, mo)
        on_index = tgolden.map_read(idx, r.signal, r.name, mo)
        assert (_strip_time(paf.paf_line(on_golden))
                == _strip_time(paf.paf_line(on_index)))
        mapped += on_golden.mapped
    assert mapped >= len(ds.reads) // 2
