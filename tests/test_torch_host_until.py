"""The port's copy of Sequence Until (``rawalign_tpu_torch/until.py``)
and its CLI's Sequence Until branch (the stop message, then every later
mapped read printed as a forced-unmapped line, ``cli.py``) against the
JAX originals: the estimator step by step on the inputs of
``tests/test_cli.py`` and on others, and the two CLIs on one index and
one FAST5 file, PAF and stderr line for line.
"""

import re

import numpy as np
import pytest

from rawalign_tpu import cli as jcli
from rawalign_tpu import config as jconfig
from rawalign_tpu import until as juntil
from rawalign_tpu.io import fast5, fasta
from rawalign_tpu.pore_model import save_pore_model
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import cli as tcli
from rawalign_tpu_torch import config as tconfig
from rawalign_tpu_torch import native
from rawalign_tpu_torch import until as tuntil

STOP = "[M::map] Sequence Until is activated"


def _pair(n_seq, **opts):
    """The JAX and the port's SequenceUntil on the same options."""
    jo, to = jconfig.MappingOptions(), tconfig.MappingOptions()
    for k, v in opts.items():
        setattr(jo, k, v)
        setattr(to, k, v)
    return juntil.SequenceUntil(n_seq, jo), tuntil.SequenceUntil(n_seq, to)


def _same_state(j, t):
    assert (t.n_reads, t.ab_count, t.cur, t.n_estimations, t.stopped) == (
        j.n_reads, j.ab_count, j.cur, j.n_estimations, j.stopped)
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_array_equal(t.estimates, j.estimates)
    np.testing.assert_array_equal(t.abundance, j.abundance)


@pytest.mark.parametrize("n_seq,p1,seed,opts", [
    # tests/test_cli.py:104's stream and options
    (2, 0.3, 0, dict(tmin_reads=10, ttest_freq=10, tn_samples=3)),
    (2, 0.5, 1, dict(tmin_reads=10, ttest_freq=10, tn_samples=3)),
    (3, 0.6, 2, dict(tmin_reads=0, ttest_freq=1, tn_samples=2, t_threshold=0.01)),
    (4, 0.9, 3, dict()),  # the defaults
])
def test_sequence_until_step_by_step(n_seq, p1, seed, opts):
    """Every read of a stream fed to both (reference 0 with probability
    1 - p1, else one of the others; after the stop too), the state
    compared after each."""
    j, t = _pair(n_seq, **opts)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        ref = int(rng.random() < p1)
        if ref and n_seq > 2:
            ref = int(rng.integers(1, n_seq))
        length = int(rng.integers(100, 900)) if n_seq > 2 else 500
        assert t.add_mapped_read(ref, length) == j.add_mapped_read(ref, length)
        _same_state(j, t)
    if seed == 0:  # tests/test_cli.py's convergence
        assert t.stopped and 0.5 < t.abundance[0] < 0.9


@pytest.mark.parametrize("x", [
    np.array([[0.5, 0.5], [0.5, 0.5], [0.9, 0.1]], np.float32),  # test_cli.py:122
    np.zeros((4, 3), np.float32),
    np.random.default_rng(0).random((5, 4)).astype(np.float32),
    np.random.default_rng(1).random((1, 6)).astype(np.float32),
])
def test_find_outlier(x):
    assert tuntil.find_outlier(x) == juntil.find_outlier(x)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One reference, ten reads in one FAST5 file, and the index the JAX
    CLI builds from them (``-x sequence-until``)."""
    if not (native.available() and native.events_available()
            and native.round_tail_available()):
        pytest.skip("native host library not built")
    d = tmp_path_factory.mktemp("until")
    ds = synth.make_dataset(seed=5, genome_lengths=[10_000], n_reads=10,
                            read_len_bp=(250, 600), noise_pa=1.2)
    fasta.write_fasta(str(d / "ref.fa"), [(s.name, s.seq) for s in ds.seqs])
    save_pore_model(str(d / "model.txt"), ds.model)
    fast5.write_fast5(str(d / "reads.fast5"), [(r.name, r.signal) for r in ds.reads])
    assert jcli.main(["-x", "sequence-until", "-t", "1", "-p", str(d / "model.txt"),
                      "-d", str(d / "ref.idx.npz"), str(d / "ref.fa")]) == 0
    return d, ds


#: with one reference every estimate is (1.0): the outlier distance is 0,
#: so the estimator stops on its third estimate, the fourth mapped read
SU_ARGS = ["-x", "sequence-until", "--sequence-until", "--min-reads", "1",
           "--test-frequency", "1", "--n-samples", "2", "--threshold", "1.0",
           "--dtw-evaluate-chains", "-t", "1"]


def _strip(text: str) -> list[str]:
    return [re.sub(r"\tmt:f:[0-9.]+", "", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("port_engine", [
    ["--engine", "golden"],
    # the mapping engine on the CPU, one read at a time: input order
    ["--device", "cpu", "--batch-size", "1", "--pipeline-depth", "1"],
])
def test_cli_sequence_until_matches_the_jax_cli(workdir, tmp_path, capsys,
                                                port_engine):
    """The JAX CLI's golden engine (no JAX compile; reads in input order)
    and the port's CLI print the same stop message once, and the same PAF:
    the mapped reads after the stop as forced-unmapped lines (columns 3-11
    ``*``, read length, mapq and tags kept)."""
    d, ds = workdir
    args = [str(d / "ref.idx.npz"), str(d / "reads.fast5")]
    out = {}
    for name, main, extra in (("jax", jcli.main, ["--engine", "golden"]),
                              ("port", tcli.main, port_engine)):
        path = tmp_path / f"{name}.paf"
        assert main(SU_ARGS + extra + ["-o", str(path)] + args) == 0
        err = capsys.readouterr().err
        out[name] = (_strip(path.read_text()),
                     [ln for ln in err.splitlines() if ln.startswith(STOP)])
    (jpaf, jstop), (tpaf, tstop) = out["jax"], out["port"]
    assert tstop == jstop and len(tstop) == 1
    assert "after processing 4 mapped reads" in tstop[0]
    assert tpaf == jpaf and len(tpaf) == len(ds.reads)
    forced = [ln for ln in tpaf
              if ln.split("\t")[2] == "*" and "\ts1:f:" in ln
              and ln.split("\t")[11] != "0"]
    assert forced  # mapped reads after the stop, printed unmapped
    for ln in forced:
        assert ln.split("\t")[2:11] == ["*"] * 9
