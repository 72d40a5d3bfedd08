"""The port's copy of the CLI's parser and option handling against the
JAX CLI's: every option with the same flags, destination, default,
choices, type and help (the port adds ``--device``), and the same argv to
the same parsed arguments and the same index and mapping options; and
the same stderr lines under ``--resume`` and at the end of a run.
"""

import argparse
import dataclasses
import re

import pytest

from rawalign_tpu import cli as jcli
from rawalign_tpu.io import fast5, fasta
from rawalign_tpu.pore_model import save_pore_model
from rawalign_tpu.testing import synth
from rawalign_tpu_torch import cli as tcli
from rawalign_tpu_torch import config

ARGVS = [
    ["ref.fa"],
    ["-x", "sensitive", "-p", "model.txt", "-d", "ref.idx.npz", "ref.fa"],
    ["-x", "faster", "-w", "3", "-e", "8", "-q", "10", "-l", "4", "-k", "5",
     "-t", "2", "-K", "750M", "ref.idx.npz", "reads/", "more.fast5"],
    ["-x", "viral", "--dtw-evaluate-chains", "--dtw-output-cigar",
     "--output-chains", "--log-anchors", "--log-num-anchors",
     "--dtw-log-scores", "--no-chainingscore-filtering", "ref.idx.npz", "r"],
    ["--dtw-border-constraint", "global", "--dtw-fill-method", "banded=0.25",
     "--dtw-match-bonus", "0.5", "--dtw-min-score", "15", "ref.idx.npz", "r"],
    ["--dtw-border-constraint", "local", "--dtw-fill-method", "full",
     "--min-events", "40", "--max-gap", "1500", "--max-target-gap", "4000",
     "--max-chains", "3000", "--min-anchors", "3", "--best-chains", "5",
     "--min-score", "12.5", "ref.idx.npz", "r"],
    ["--max-chunks", "12", "--stop-min-anchor", "3", "--map-min-anchor", "4",
     "--stop-best-ratio", "1.5", "--map-best-ratio", "1.4",
     "--stop-mean-ratio", "4", "--map-mean-ratio", "6", "--bp-per-sec", "400",
     "--sample-rate", "5000", "--chunk-size", "3000", "ref.idx.npz", "r"],
    ["-x", "sequence-until", "--sequence-until", "--threshold", "2.0",
     "--n-samples", "7", "--test-frequency", "300", "--min-reads", "100",
     "ref.idx.npz", "r"],
    ["--batch-size", "16", "--max-occ", "1024", "--chain-window", "2048",
     "--max-anchors", "4096", "--seeds-out", "512", "--pipeline-depth", "8",
     "--engine", "golden", "--chain-impl", "device", "--stage1-impl", "host",
     "--resume", "-o", "out.paf", "--selfcheck", "0.1",
     "--selfcheck-max-reads", "8", "--mt-mode", "wall", "--selfcheck-strict",
     "ref.idx.npz", "r"],
]


def _actions(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.help,
                 a.nargs, type(a).__name__)
        for a in parser._actions if not isinstance(a, argparse._HelpAction)
    }


def test_parser_has_the_jax_options_and_help():
    """The same options; only ``--profile`` and ``--debug-nans`` have help
    of their own, naming what they do in the port."""
    got, want = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert set(got) - set(want) == {"device"}
    for dest, spec in want.items():
        if dest == "version":
            continue
        if dest in ("profile", "debug_nans"):
            assert got[dest][:4] + got[dest][5:] == spec[:4] + spec[5:], dest
            continue
        assert got[dest] == spec, dest
    assert got["device"][:2] == (("--device",), "cuda")
    assert "torch.profiler" in got["profile"][4]
    assert "NaN" in got["debug_nans"][4]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_same_argv_gives_the_same_options(argv):
    targs = tcli.build_parser().parse_args(argv)
    jargs = jcli.build_parser().parse_args(argv)
    assert {k: v for k, v in vars(targs).items() if k != "device"} == vars(jargs)
    io, mo = tcli.apply_options(targs)
    jio, jmo = jcli.apply_options(jargs)
    assert isinstance(io, config.IndexOptions)
    assert isinstance(mo, config.MappingOptions)
    assert type(mo.flag) is config.MappingFlag
    assert dataclasses.asdict(io) == dataclasses.asdict(jio)
    assert dataclasses.asdict(mo) == dataclasses.asdict(jmo)


def test_unknown_fill_method_exits_as_in_the_jax_cli():
    argv = ["--dtw-fill-method", "diagonal", "ref.idx.npz"]
    with pytest.raises(SystemExit, match="unknown DTW fill method"):
        tcli.apply_options(tcli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit, match="unknown DTW fill method"):
        jcli.apply_options(jcli.build_parser().parse_args(argv))


@pytest.mark.parametrize("text", ["500M", "1.5g", "750k", "42", " 2G "])
def test_parse_num(text):
    assert tcli.parse_num(text) == jcli.parse_num(text)


def _stderr_fields(text: str) -> list[str]:
    """stderr lines with every number masked (times, RSS, counts stay
    apart from the words around them)."""
    return [re.sub(r"\d+(\.\d+)?", "N", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("engine", ["golden", "device"])
def test_resume_and_final_lines_match_the_jax_cli(tmp_path, capsys, engine):
    """A first run writes the PAF, a second with ``--resume`` finds every
    read mapped: the port prints the JAX CLI's ``resume:`` line and its
    final ``Real time: ... CPU: ... Peak RSS: ...; reads:`` line, numbers
    masked, and leaves the same PAF. The JAX CLI runs its golden engine
    (no JAX compile); the port its golden engine or the mapping engine on
    the CPU."""
    ds = synth.make_dataset(seed=5, genome_lengths=[6_000], n_reads=3,
                            read_len_bp=(250, 400), noise_pa=1.2)
    fasta.write_fasta(str(tmp_path / "ref.fa"), [(s.name, s.seq) for s in ds.seqs])
    save_pore_model(str(tmp_path / "model.txt"), ds.model)
    fast5.write_fast5(str(tmp_path / "reads.fast5"),
                      [(r.name, r.signal) for r in ds.reads])
    common = ["-x", "viral", "-t", "1"]
    assert jcli.main(common + ["-p", str(tmp_path / "model.txt"),
                               "-d", str(tmp_path / "ref.idx.npz"),
                               str(tmp_path / "ref.fa")]) == 0
    capsys.readouterr()
    args = [str(tmp_path / "ref.idx.npz"), str(tmp_path / "reads.fast5")]
    port = (["--engine", "golden"] if engine == "golden"
            else ["--device", "cpu"])
    runs = {}
    for name, main, extra in (("jax", jcli.main, ["--engine", "golden"]),
                              ("port", tcli.main, port)):
        out = str(tmp_path / f"{name}.paf")
        assert main(common + extra + ["-o", out] + args) == 0
        first = capsys.readouterr().err
        assert main(common + extra + ["--resume", "-o", out] + args) == 0
        runs[name] = (first, capsys.readouterr().err,
                      (tmp_path / f"{name}.paf").read_text())
    (jfirst, jresume, jpaf), (tfirst, tresume, tpaf) = runs["jax"], runs["port"]
    assert f"[M::main] resume: {len(ds.reads)} reads already mapped" in tresume
    assert _stderr_fields(tresume) == _stderr_fields(jresume)
    assert _stderr_fields(tfirst)[-2:] == _stderr_fields(jfirst)[-2:]
    last = tfirst.splitlines()[-1]
    assert re.fullmatch(r"\[M::main\] Real time: \d+\.\d{3} sec; CPU: \d+\.\d{3} "
                        r"sec; Peak RSS: \d+\.\d{3} GB; reads: 3", last), last
    assert tpaf.count("\n") == len(ds.reads)
    strip = lambda s: sorted(re.sub(r"mt:f:[0-9.]+", "", s).splitlines())  # noqa: E731
    assert strip(tpaf) == strip(jpaf)
