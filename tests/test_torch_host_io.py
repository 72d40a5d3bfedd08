"""The port's copies of the host I/O modules (``io/prefetch.py``,
``io/slow5.py``, ``io/vbz.py``, ``io/fast5.py``'s vbz path,
``pore_model.py``) and of the CLI's ``--selfcheck`` and ``--resume``
paths against the JAX originals, on files the tests write themselves:
the same bytes written, the same values read back, the same stderr
lines and exit codes (``tests/test_cli.py:182-229``).
"""

import re

import numpy as np
import pytest

from rawalign_tpu import cli as jcli
from rawalign_tpu import pore_model as jpore
from rawalign_tpu.io import fast5 as jfast5
from rawalign_tpu.io import fasta
from rawalign_tpu.io import prefetch as jprefetch
from rawalign_tpu.io import slow5 as jslow5
from rawalign_tpu.io import vbz as jvbz
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import cli as tcli
from rawalign_tpu_torch import native
from rawalign_tpu_torch import pore_model as tpore
from rawalign_tpu_torch.io import fast5 as tfast5
from rawalign_tpu_torch.io import prefetch as tprefetch
from rawalign_tpu_torch.io import slow5 as tslow5
from rawalign_tpu_torch.io import vbz as tvbz
from rawalign_tpu_torch.selfcheck import SelfCheck


@pytest.fixture(scope="module")
def ds():
    return synth.make_dataset(seed=5, genome_lengths=[10_000], n_reads=6,
                              read_len_bp=(250, 600), noise_pa=1.2)


def _same_reads(got, want):
    got, want = list(got), list(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,seed", [(6, 0), (5, 3)])
def test_pore_model_files_cross_read(tmp_path, k, seed):
    model = jpore.synthetic_pore_model(k=k, seed=seed)
    tm = tpore.synthetic_pore_model(k=k, seed=seed)
    for f in ("level_mean", "level_stdv", "sd_mean", "sd_stdv"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(model, f))
    jpath, tpath = tmp_path / "j.txt", tmp_path / "t.txt"
    jpore.save_pore_model(str(jpath), model)
    tpore.save_pore_model(str(tpath), tm)
    assert tpath.read_bytes() == jpath.read_bytes()
    got, want = tpore.load_pore_model(str(jpath)), jpore.load_pore_model(str(jpath))
    assert got.k == want.k == k
    for f in ("level_mean", "level_stdv", "sd_mean", "sd_stdv"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert tpore.encode_kmer("ACGTNA") == jpore.encode_kmer("ACGTNA")
    (tmp_path / "short.txt").write_text("ACGT\t1\t2\t3\t4\n")
    for load in (tpore.load_pore_model, jpore.load_pore_model):
        with pytest.raises(ValueError, match="k=4"):
            load(str(tmp_path / "short.txt"))


def test_slow5_written_and_read_as_the_jax_copy(tmp_path, ds):
    reads = [(r.name, r.signal) for r in ds.reads]
    jpath, tpath = tmp_path / "j.slow5", tmp_path / "t.slow5"
    jslow5.write_slow5(str(jpath), reads)
    tslow5.write_slow5(str(tpath), reads)
    assert tpath.read_bytes() == jpath.read_bytes()
    _same_reads(tslow5.read_slow5(str(jpath)), jslow5.read_slow5(str(jpath)))


@pytest.mark.parametrize("seed", range(3))
def test_vbz_codec_as_the_jax_copy(seed):
    if not (tvbz.HAVE_ZSTD and jvbz.HAVE_ZSTD):
        pytest.skip("zstandard unavailable")
    rng = np.random.default_rng(seed)
    sig = (550 + np.cumsum(rng.normal(0, 4 + 40 * seed, 5000))).astype(np.int16)
    payload = tvbz.svb16_encode(sig)
    assert payload == jvbz.svb16_encode(sig)
    np.testing.assert_array_equal(tvbz.svb16_decode(payload, sig.size), sig)
    blob = tvbz.compress(sig)
    assert blob == jvbz.compress(sig)
    np.testing.assert_array_equal(tvbz.decompress(blob), jvbz.decompress(blob))
    np.testing.assert_array_equal(tvbz.decompress(blob[4:], n_expected=sig.size), sig)


@pytest.mark.parametrize("compression", ["none", "vbz"])
def test_fast5_read_as_the_jax_copy(tmp_path, ds, compression):
    if not tfast5.HAVE_H5PY or (compression == "vbz" and not tvbz.HAVE_ZSTD):
        pytest.skip("h5py/zstandard unavailable")
    reads = [(r.name, r.signal) for r in ds.reads]
    path = str(tmp_path / f"t_{compression}.fast5")
    tfast5.write_fast5(path, reads, compression=compression)
    _same_reads(tfast5.read_fast5(path), jfast5.read_fast5(path))


def test_prefetch_signals_as_the_jax_copy(tmp_path, ds):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"part{i}.slow5")
        jslow5.write_slow5(p, [(r.name, r.signal) for r in ds.reads[i::4]])
        paths.append(p)
    want = list(jfast5.read_signals(paths))
    for n_threads, depth in ((3, 2), (1, 4), (2, 1)):
        _same_reads(tprefetch.prefetch_signals(paths, n_threads=n_threads,
                                               depth=depth), want)
        _same_reads(jprefetch.prefetch_signals(paths, n_threads=n_threads,
                                               depth=depth), want)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, ds):
    """tests/test_cli.py's files: a reference, a pore model, the reads in
    one FAST5 file and the index the JAX CLI builds."""
    if not (native.available() and native.events_available()
            and native.round_tail_available()):
        pytest.skip("native host library not built")
    d = tmp_path_factory.mktemp("cli_io")
    fasta.write_fasta(str(d / "ref.fa"), [(s.name, s.seq) for s in ds.seqs])
    jpore.save_pore_model(str(d / "model.txt"), ds.model)
    jfast5.write_fast5(str(d / "reads.fast5"), [(r.name, r.signal) for r in ds.reads])
    assert jcli.main(["-x", "viral", "-t", "1", "-p", str(d / "model.txt"),
                      "-d", str(d / "ref.idx.npz"), str(d / "ref.fa")]) == 0
    return d


def _masked(lines: list[str]) -> list[str]:
    return [re.sub(r"\d+(\.\d+)?", "N", ln) for ln in lines]


def _selfcheck_lines(err: str) -> list[str]:
    return [ln for ln in err.splitlines() if ln.startswith("[M::selfcheck]")]


def test_cli_selfcheck_ok_line(workdir, capsys):
    """``--selfcheck 1.0``: the port's mapping engine (on the CPU) checked
    against its golden engine prints the JAX CLI's ok line, every read
    checked."""
    d = workdir
    args = ["-x", "viral", "-t", "1", "--dtw-evaluate-chains", "--selfcheck",
            "1.0", str(d / "ref.idx.npz"), str(d / "reads.fast5")]
    assert tcli.main(args + ["--device", "cpu", "-o", str(d / "t.paf")]) == 0
    got = _selfcheck_lines(capsys.readouterr().err)
    assert jcli.main(args + ["--engine", "golden", "-o", str(d / "j.paf")]) == 0
    want = _selfcheck_lines(capsys.readouterr().err)
    assert got and got[0].startswith("[M::selfcheck] ok:"), got
    assert _masked(got) == _masked(want)
    assert re.findall(r"\d+", got[0])[:1] == re.findall(r"\d+", want[0])[:1]


def test_cli_selfcheck_strict_exit_code(workdir, capsys, monkeypatch):
    """A divergence report exits 7 under ``--selfcheck-strict`` and 0
    without it, as the JAX CLI does (the divergence injected by tampering
    the report)."""
    d = workdir
    real_report = SelfCheck.report

    def tampered_report(self, stream=None):
        rep = real_report(self, stream)
        rep["n_divergent"] = 1
        return rep

    monkeypatch.setattr(SelfCheck, "report", tampered_report)
    args = ["-x", "viral", "-t", "1", "--dtw-evaluate-chains", "--device",
            "cpu", "--selfcheck", "1.0", "--selfcheck-strict", "-o",
            str(d / "t2.paf"), str(d / "ref.idx.npz"), str(d / "reads.fast5")]
    assert tcli.main(args) == 7
    args.remove("--selfcheck-strict")
    assert tcli.main(args) == 0
    capsys.readouterr()


def test_cli_resume_maps_only_the_rest(workdir, capsys, ds):
    """``--resume`` after a run cut short: the reads already in the PAF
    are skipped, the rest appended; the PAF ends as the JAX CLI's whole
    run and the resume line is the JAX CLI's for the same file."""
    d = workdir
    common = ["-x", "viral", "-t", "1", "--dtw-evaluate-chains"]
    args = [str(d / "ref.idx.npz"), str(d / "reads.fast5")]
    jpath, tpath = d / "j_full.paf", d / "t_resume.paf"
    assert jcli.main(common + ["--engine", "golden", "-o", str(jpath)] + args) == 0
    full = jpath.read_text().splitlines()
    errs = {}
    for name, main, extra, path in (
            ("jax", jcli.main, ["--engine", "golden"], d / "j_resume.paf"),
            ("port", tcli.main, ["--device", "cpu"], tpath)):
        path.write_text("\n".join(full[:2]) + "\n")
        capsys.readouterr()
        assert main(common + extra + ["--resume", "-o", str(path)] + args) == 0
        errs[name] = capsys.readouterr().err.splitlines()
    resume = [ln for ln in errs["port"] if "resume:" in ln]
    assert resume == ["[M::main] resume: 2 reads already mapped"]
    assert resume == [ln for ln in errs["jax"] if "resume:" in ln]
    strip = lambda t: sorted(re.sub(r"\tmt:f:[0-9.]+", "", ln)  # noqa: E731
                             for ln in t.splitlines())
    assert strip(tpath.read_text()) == strip("\n".join(full))
    assert len(tpath.read_text().splitlines()) == len(ds.reads)
