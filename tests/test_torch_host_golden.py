"""The port's copy of the golden engine (with its copies of the golden
events, sketch, chain and DTW models, the index build and the options)
against the JAX package's golden engine: PAF lines byte for byte, mt:f
(a wall time) masked, on the ``viral`` and ``sensitive`` presets with
DTW evaluation, and with CIGAR and chain output. This is the oracle
``chip_smoke.py`` holds the port's engine to on the card.
"""

import functools
import re

import numpy as np
import pytest

from rawalign_tpu import config as jconfig
from rawalign_tpu.golden import engine as jgolden
from rawalign_tpu.index import index as jindex
from rawalign_tpu.io import paf as jpaf
from rawalign_tpu.testing import synth as jsynth
from rawalign_tpu_torch import config, native
from rawalign_tpu_torch.golden import engine as tgolden
from rawalign_tpu_torch.index import index as tindex
from rawalign_tpu_torch.io import paf as tpaf
from rawalign_tpu_torch.testing import synth


@pytest.fixture(autouse=True)
def _need_native():
    if not native.available():
        pytest.skip("native host library not built")


def _strip_time(line: str) -> str:
    return re.sub(r"mt:f:[0-9.]+", "mt:f:X", line)


def _reads(ds):
    """The dataset's reads and a pure-noise read three chunks long (it
    runs every chunk and ends unmapped)."""
    rng = np.random.default_rng(5)
    return [(r.name, r.signal) for r in ds.reads] + [
        ("noise", rng.normal(95.0, 15.0, 12_000).astype(np.float32))]


@functools.cache
def _indexes(preset):
    kw = dict(seed=11, genome_lengths=[12_000, 6_000], n_reads=8,
              read_len_bp=(250, 700), noise_pa=1.3)
    ds, jds = synth.make_dataset(**kw), jsynth.make_dataset(**kw)
    io, jio = config.IndexOptions(), jconfig.IndexOptions()
    config.set_opt(preset, io, config.MappingOptions())
    jconfig.set_opt(preset, jio, jconfig.MappingOptions())
    return (tindex.build_index(ds.seqs, ds.model.pore_vals, io),
            jindex.build_index(jds.seqs, jds.model.pore_vals, jio),
            _reads(ds), _reads(jds))


@pytest.mark.parametrize("preset,flags", [
    ("viral", 0),
    ("sensitive", 0),
    ("viral", jconfig.MappingFlag.DTW_OUTPUT_CIGAR | jconfig.MappingFlag.OUTPUT_CHAINS),
], ids=["viral", "sensitive", "viral-cigar-chains"])
def test_golden_paf_equals_the_jax_golden(preset, flags):
    idx, jidx, reads, jreads = _indexes(preset)
    jmo = jconfig.MappingOptions()
    jconfig.set_opt(preset, jconfig.IndexOptions(), jmo)
    jmo.set_flag(jconfig.MappingFlag.DTW_EVALUATE_CHAINS | flags)
    mo = config.options_from(jmo)
    got = [_strip_time(tpaf.paf_line(tgolden.map_read(idx, sig, name, mo)))
           for name, sig in reads]
    want = [_strip_time(jpaf.paf_line(jgolden.map_read(jidx, sig, name, jmo)))
            for name, sig in jreads]
    assert got == want
    mapped = [ln for ln in got if ln.split("\t")[2] != "*"]
    assert len(mapped) >= 6 and got[-1].split("\t")[2] == "*"
    if flags:
        assert all("\taln:s:" in ln and "\tanchors:s:" in ln for ln in mapped)


def test_golden_map_reads_streams_like_the_jax_golden():
    idx, jidx, reads, jreads = _indexes("viral")
    jmo = jconfig.MappingOptions()
    jconfig.set_opt("viral", jconfig.IndexOptions(), jmo)
    mo = config.options_from(jmo)
    got = [_strip_time(tpaf.paf_line(r))
           for r in tgolden.map_reads(idx, iter(reads[:4]), mo)]
    want = [_strip_time(jpaf.paf_line(r))
            for r in jgolden.map_reads(jidx, iter(jreads[:4]), jmo)]
    assert got == want
