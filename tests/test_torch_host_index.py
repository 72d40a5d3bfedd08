"""The port's copies of the index build and its inputs against the JAX
package's originals: expected-signal conversion, the index build, the
``.npz`` and reference-format (``.ind``) files, and the function that
carries a JAX-built index and options into the port's classes. Every
comparison is bit for bit (arrays, dtypes, file bytes).
"""

import dataclasses

import numpy as np
import pytest

from rawalign_tpu import config as jconfig
from rawalign_tpu.index import index as jindex
from rawalign_tpu.index import ref_format as jref
from rawalign_tpu.signal import seq2sig as jseq2sig
from rawalign_tpu.testing import synth as jsynth
from rawalign_tpu_torch import config, native
from rawalign_tpu_torch.index import index as tindex
from rawalign_tpu_torch.index import ref_format as tref
from rawalign_tpu_torch.pore_model import synthetic_pore_model
from rawalign_tpu_torch.signal import seq2sig as tseq2sig
from rawalign_tpu_torch.testing import synth

ARRAYS = ("seq_lens", "sig_lens", "sig_offsets", "signals_s1", "signals_s0",
          "keys", "val_id", "val_ps")


def _same_index(got, want):
    assert got.seq_names == want.seq_names
    for k in ARRAYS:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert dataclasses.asdict(got.opt) == dataclasses.asdict(want.opt)


def _both(preset, genome_lengths):
    """(port index, JAX index) of the same seeded genome and preset, each
    built by its own package."""
    ds = synth.make_dataset(seed=3, genome_lengths=genome_lengths, n_reads=1)
    jds = jsynth.make_dataset(seed=3, genome_lengths=genome_lengths, n_reads=1)
    assert [s.seq for s in ds.seqs] == [s.seq for s in jds.seqs]
    io, jio = config.IndexOptions(), jconfig.IndexOptions()
    config.set_opt(preset, io, config.MappingOptions())
    jconfig.set_opt(preset, jio, jconfig.MappingOptions())
    return (tindex.build_index(ds.seqs, ds.model.pore_vals, io),
            jindex.build_index(jds.seqs, jds.model.pore_vals, jio))


@pytest.mark.parametrize("preset,genome_lengths", [
    ("sensitive", [20_000]),
    ("viral", [9_000, 5_000, 3_000]),
    ("faster", [15_000, 4_000]),
])
def test_build_index_equals_the_jax_build(preset, genome_lengths):
    got, want = _both(preset, genome_lengths)
    _same_index(got, want)
    assert got.keys.size > 1000
    assert isinstance(got.opt, config.IndexOptions)


def test_index_from_carries_the_jax_index(tmp_path):
    got, want = _both("viral", [9_000, 5_000])
    carried = tindex.index_from(want)
    assert isinstance(carried, tindex.RawIndex)
    assert isinstance(carried.opt, config.IndexOptions)
    _same_index(carried, got)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_files_read_across_packages(tmp_path, writer):
    got, want = _both("viral", [9_000, 5_000])
    path = str(tmp_path / "ref.idx.npz")
    if writer == "port":
        got.save(path)
        _same_index(tindex.index_from(jindex.RawIndex.load(path)), got)
    else:
        want.save(path)
        _same_index(tindex.RawIndex.load(path), got)


def test_reference_format_bytes_and_reload(tmp_path):
    got, want = _both("sensitive", [6_000, 2_500])
    tref.dump_reference_index(got, str(tmp_path / "port.ind"))
    jref.dump_reference_index(want, str(tmp_path / "jax.ind"))
    assert (tmp_path / "port.ind").read_bytes() == (tmp_path / "jax.ind").read_bytes()
    back = tref.load_reference_index(str(tmp_path / "port.ind"))
    jback = jref.load_reference_index(str(tmp_path / "port.ind"))
    _same_index(back, tindex.index_from(jback))


@pytest.mark.parametrize("strand", [0, 1])
def test_seq_to_sig_equals_the_jax_conversion(strand):
    rng = np.random.default_rng(strand)
    seq = "".join(rng.choice(list("ACGTN"), 3000, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
    model = synthetic_pore_model(k=6, seed=1)
    got = tseq2sig.seq_to_sig(tseq2sig.seq_to_codes(seq), model.pore_vals, 6, strand)
    want = jseq2sig.seq_to_sig(jseq2sig.seq_to_codes(seq), model.pore_vals, 6, strand)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_native_registers_znorm_apply_with_the_gather():
    """The port's bindings register ``ra_znorm_apply`` on its own and
    report the gather available only with it: seq2sig calls both."""
    lib = native.load()
    if lib is None:
        pytest.skip("native host library not built")
    assert native.pore_gather_available() == (
        hasattr(lib, "ra_pore_gather") and hasattr(lib, "ra_znorm_apply"))
    if hasattr(lib, "ra_znorm_apply"):
        assert lib.ra_znorm_apply.argtypes is not None
        vals = np.array([1.0, 2.0, 4.0], np.float32)
        native.znorm_apply(vals, 2.0, 2.0)
        np.testing.assert_array_equal(vals, np.float32([-0.5, 0.0, 1.0]))


def test_options_from_copies_every_field():
    jio, jmo = jconfig.IndexOptions(), jconfig.MappingOptions()
    jconfig.set_opt("faster", jio, jmo)
    jmo.set_flag(jconfig.MappingFlag.DTW_EVALUATE_CHAINS
                 | jconfig.MappingFlag.OUTPUT_CHAINS)
    jmo.dtw_border_constraint = jconfig.BorderConstraint.GLOBAL
    jmo.dtw_fill_method = jconfig.FillMethod.FULL
    jmo.min_chaining_score = 12.5
    io, mo = config.options_from(jio), config.options_from(jmo)
    assert isinstance(io, config.IndexOptions)
    assert isinstance(mo, config.MappingOptions)
    assert dataclasses.asdict(io) == dataclasses.asdict(jio)
    assert dataclasses.asdict(mo) == dataclasses.asdict(jmo)
    assert type(mo.flag) is config.MappingFlag
    assert mo.flag == config.MappingFlag.DTW_EVALUATE_CHAINS | config.MappingFlag.OUTPUT_CHAINS
    assert mo.dtw_border_constraint is config.BorderConstraint.GLOBAL
    assert mo.dtw_fill_method is config.FillMethod.FULL
