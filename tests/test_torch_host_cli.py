"""The port's copy of the CLI's parser and option handling against the
JAX CLI's: every option with the same flags, destination, default,
choices, type and help (the port adds ``--device``), and the same argv to
the same parsed arguments and the same index and mapping options.
"""

import argparse
import dataclasses

import pytest

from rawalign_tpu import cli as jcli
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
    got, want = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert set(got) - set(want) == {"device"}
    for dest, spec in want.items():
        if dest == "version":
            continue
        assert got[dest] == spec, dest
    assert got["device"][:2] == (("--device",), "cuda")


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
