"""The port's CLI under ``--profile DIR`` and ``--debug-nans``, on the CPU
(``--device cpu``), on a small synthetic genome written as FASTA and its
reads as FAST5.

``--profile`` writes one Chrome trace (``torch.profiler``) a run into
DIR and leaves the PAF as it is; a run that fails inside the mapping
loop leaves no profiler running. ``--debug-nans`` is the port's
``jax_debug_nans``: clean reads map as without it (and as the JAX CLI
maps them), and a NaN out of the DTW, event or chain dispatcher raises
``FloatingPointError`` naming the kernel. PAF lines are compared with
mt:f (a wall time) masked.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from rawalign_tpu import cli as jcli
from rawalign_tpu_torch import cli as tcli
from rawalign_tpu_torch import runtime
from rawalign_tpu_torch.io import fast5, fasta
from rawalign_tpu_torch.map import chain as tchain
from rawalign_tpu_torch.map import dtw as tdtw
from rawalign_tpu_torch.map import dtw_cuda
from rawalign_tpu_torch.map import tiles as ttiles
from rawalign_tpu_torch.pore_model import save_pore_model
from rawalign_tpu_torch.signal import events as tevents
from rawalign_tpu_torch.testing import synth


@pytest.fixture(autouse=True)
def _guard_off():
    runtime.set_debug_nans(False)
    yield
    runtime.set_debug_nans(False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """argv of a run on the dataset (output and flags to be added), and
    the PAF of that run without flags."""
    d = tmp_path_factory.mktemp("cli_profile")
    ds = synth.make_dataset(seed=5, genome_lengths=[10_000], n_reads=6,
                            read_len_bp=(250, 600), noise_pa=1.2)
    fasta.write_fasta(str(d / "ref.fa"), [(s.name, s.seq) for s in ds.seqs])
    save_pore_model(str(d / "model.txt"), ds.model)
    fast5.write_fast5(str(d / "reads.fast5"),
                      [(r.name, r.signal) for r in ds.reads])
    argv = ["-x", "viral", "--dtw-evaluate-chains", "-t", "1", "-p",
            str(d / "model.txt"), str(d / "ref.fa"), str(d / "reads.fast5")]
    assert tcli.main(argv + ["--device", "cpu", "-o", str(d / "plain.paf")]) == 0
    return argv, _paf(d / "plain.paf")


def _paf(path) -> list[str]:
    with open(path) as f:
        return [re.sub(r"mt:f:[0-9.]+", "mt:f:X", ln) for ln in f.read().splitlines()]


def _port(files, tmp_path, *flags, name="port.paf") -> list[str]:
    argv, _ = files
    out = tmp_path / name
    assert tcli.main(argv + ["--device", "cpu", "-o", str(out), *flags]) == 0
    return _paf(out)


def _traces(d) -> list[str]:
    return sorted(os.path.join(d, f) for f in os.listdir(d))


def test_profile_writes_a_chrome_trace_and_keeps_the_paf(files, tmp_path, capsys):
    """Each run writes one trace into DIR (created if missing) that loads
    with ``json``; the PAF equals the run without the flag; a second run
    into the same DIR leaves two files."""
    _, plain = files
    prof = tmp_path / "prof" / "new"
    assert _port(files, tmp_path, "--profile", str(prof)) == plain
    (first,) = _traces(prof)
    assert first.endswith(".pt.trace.json")
    assert f"[M::main] profiler trace written to {first}" in capsys.readouterr().err
    assert _port(files, tmp_path, "--profile", str(prof), name="again.paf") == plain
    both = _traces(prof)
    assert len(both) == 2 and first in both
    for path in both:
        with open(path) as f:
            trace = json.load(f)
        assert len(trace["traceEvents"]) > 0
    assert not torch._C._autograd._profiler_enabled()


def test_a_run_that_fails_in_the_mapping_loop_stops_the_profiler(
        files, tmp_path, monkeypatch):
    """A DTW round that raises ends the run with its error, the profiler
    stopped; the next ``--profile`` run succeeds and writes its trace."""
    _, plain = files
    argv, _ = files

    def boom(*args, **kwargs):
        raise RuntimeError("DTW round failed")

    monkeypatch.setattr(tdtw, "dtw_banded_round", boom)
    prof = tmp_path / "prof"
    with pytest.raises(RuntimeError, match="DTW round failed"):
        tcli.main(argv + ["--device", "cpu", "-o", str(tmp_path / "x.paf"),
                          "--profile", str(prof)])
    assert not torch._C._autograd._profiler_enabled()
    monkeypatch.undo()
    assert _port(files, tmp_path, "--profile", str(prof)) == plain
    assert len(_traces(prof)) == 1
    assert not torch._C._autograd._profiler_enabled()


def test_debug_nans_on_clean_reads_keeps_the_paf(files, tmp_path):
    """The same PAF with ``--debug-nans``, without it, and from the JAX
    CLI's default path without flags; the switch is off after the run."""
    argv, plain = files
    assert _port(files, tmp_path, "--debug-nans") == plain
    assert not runtime.debug_nans()
    assert jcli.main(argv + ["-o", str(tmp_path / "jax.paf")]) == 0
    assert sorted(_paf(tmp_path / "jax.paf")) == sorted(plain)


def _first_live(n: torch.Tensor) -> int:
    return int(torch.nonzero(n > 0)[0, 0])


def _nan_costs(fn):
    def poisoned(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[0] = float("nan")
        return out
    return poisoned


def _nan_events(fn):
    def poisoned(*args, **kwargs):
        ev = fn(*args, **kwargs)
        values = ev.values.clone()
        values[_first_live(ev.n_events), 0] = float("nan")
        return ev._replace(values=values)
    return poisoned


def _nan_scores(fn):
    def poisoned(seg, target, query, n_anchors, **kw):
        dp = fn(seg, target, query, n_anchors, **kw)
        scores = dp.scores.clone()
        scores[_first_live(n_anchors), 0] = float("nan")
        return dp._replace(scores=scores)
    return poisoned


# (kernel the error names, module and plain function whose output gets a
# NaN, the placement that runs that kernel)
NAN_CASES = {
    "dtw_banded_round": (tdtw, "dtw_banded_round", _nan_costs, []),
    "detect_events": (tevents, "detect_events_plain", _nan_events,
                      ["--stage1-impl", "device"]),
    "chain_dp": (tchain, "chain_dp_plain", _nan_scores,
                 ["--chain-impl", "device"]),
}


@pytest.mark.parametrize("kernel", sorted(NAN_CASES))
def test_debug_nans_raises_on_a_nan_out_of_a_kernel(files, tmp_path,
                                                    monkeypatch, kernel):
    """A NaN put into the live part of one dispatcher's output raises
    ``FloatingPointError`` naming that kernel under ``--debug-nans``; the
    same run without the flag finishes."""
    argv, _ = files
    module, fn, poison, placement = NAN_CASES[kernel]
    monkeypatch.setattr(module, fn, poison(getattr(module, fn)))
    run = argv + ["--device", "cpu", "-o", str(tmp_path / "nan.paf")] + placement
    with pytest.raises(FloatingPointError, match=f"NaN in {kernel} output"):
        tcli.main(run + ["--debug-nans"])
    assert not runtime.debug_nans()
    assert tcli.main(run) == 0
    assert len(_paf(tmp_path / "nan.paf")) == len(files[1])


class Untouchable(torch.Tensor):
    """A tensor on which every torch operation raises."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"tensor operation {func}")


def test_check_finite_with_the_switch_off_touches_no_tensor():
    t = torch.full((2, 4), float("nan")).as_subclass(Untouchable)
    n = torch.tensor([4, 4], dtype=torch.int32).as_subclass(Untouchable)
    runtime.check_finite("x", t)
    runtime.check_finite("x", t, t, lengths=n)
    runtime.set_debug_nans(True)
    with pytest.raises(AssertionError, match="tensor operation"):
        runtime.check_finite("x", t)


@pytest.mark.parametrize("case,raises", [
    ("clean", False),
    ("nan in padding", False),
    ("nan in a live slot", True),
    ("nan in an unbounded row", True),
    ("integer tensor", False),
])
def test_check_finite_checks_the_live_part(case, raises):
    """With the switch on: only the first ``lengths[b]`` entries of row b
    count, the whole tensor without ``lengths``; integers never raise."""
    runtime.set_debug_nans(True)
    x = torch.from_numpy(np.arange(12, dtype=np.float32).reshape(3, 4))
    lengths = torch.tensor([4, 2, 0], dtype=torch.int32)
    if case == "nan in padding":
        x[1, 2] = x[2, 0] = float("nan")
    elif case in ("nan in a live slot", "nan in an unbounded row"):
        x[1, 1] = float("nan")
    if case == "integer tensor":
        x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    kw = {} if case == "nan in an unbounded row" else {"lengths": lengths}
    if raises:
        with pytest.raises(FloatingPointError, match="^NaN in kernel x$"):
            runtime.check_finite("kernel x", x, **kw)
    else:
        runtime.check_finite("kernel x", x, **kw)


@pytest.mark.parametrize("where,raises", [
    ("nowhere", False),
    ("an unread reference slot", False),
    ("an unread event slot", False),
    ("a read reference slot", True),
    ("a read event slot", True),
])
def test_the_dtw_guard_checks_the_pool_slots_the_tiles_read(where, raises):
    """Under the switch the DTW wrapper checks, of its two pools, only the
    slots its tiles' descriptors read (``a_base + [0, n)``, ``b_base +
    [0, m)``): a NaN elsewhere leaves the costs as without the switch."""
    rng = np.random.default_rng(3)
    ref = rng.normal(0.0, 1.0, 40).astype(np.float32)
    hist = rng.normal(0.0, 1.0, (2, 16)).astype(np.float32)
    # (a_base, n, b_base, m, radius, exclude_last): reference spans
    # [0, 12) and [20, 30), events [40, 47) and [56, 62) of the joint pool
    da = np.array([[0, 12, 40, 7, 3, 0], [20, 10, 56, 6, 2, 1]], np.int64)
    slot = {"an unread reference slot": ("ref", 15),
            "an unread event slot": ("hist", 10),
            "a read reference slot": ("ref", 25),
            "a read event slot": ("hist", 19)}.get(where)
    if slot is not None:
        pool, k = slot
        (ref if pool == "ref" else hist.reshape(-1))[k] = np.nan
    _order, descs, _b = ttiles.class_batches(
        *[da[:, k].astype(np.int32) for k in range(6)], np.arange(2),
        device_max_n=256)
    jobs, block_w, stage = ttiles.work_list(descs)
    args = (torch.from_numpy(ref), torch.from_numpy(hist),
            torch.from_numpy(descs), torch.from_numpy(jobs))
    kw = dict(block_w=block_w, stage=stage)
    plain = dtw_cuda.dtw_banded_round(*args, **kw)
    runtime.set_debug_nans(True)
    if raises:
        with pytest.raises(FloatingPointError,
                           match="^NaN in dtw_banded_round input$"):
            dtw_cuda.dtw_banded_round(*args, **kw)
    else:
        assert torch.equal(dtw_cuda.dtw_banded_round(*args, **kw), plain)
