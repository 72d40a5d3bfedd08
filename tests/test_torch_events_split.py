"""The CUDA event kernel's formulation of the peak machine,
``_peaks_split_plain`` (the short detector alone, then the long one from
its record, then an ordered compaction; each detector in one piece or in
chunks that run in rounds), against ``_peaks`` and, with the whole
detector built on it, against the golden detector, the native C detector
and the JAX device detector, on the CPU.

The chunked runs use the kernel's sizes (chunks of 15 samples, and of
the 17 that a row of 4000 samples gets) and others: 31, 7, and chunks of
one sample. Every chunk but a row's first starts from a guess, so the
rounds which run a chunk again from the end state of the one before it
are exercised by every case.

Peaks and counts are compared exactly; events against golden and native
bit for bit (NaN for NaN); against the JAX float32 detector at the
tolerance the JAX package holds it to against golden (see
``tests/test_torch_events.py``). The signals are those of
``tests/test_torch_events.py`` plus lengths 0, ``2*w2 - 1`` and ``2*w2``,
a constant signal (NaN z-norm on a one-event chunk aside, it has no
event) and a chunk cut so that the short detector masks the long one at
its last sample.
"""

import functools

import numpy as np
import pytest
import torch

from rawalign_tpu import config, native
from rawalign_tpu.golden import events as gevents
from rawalign_tpu.pore_model import synthetic_pore_model
from rawalign_tpu.signal import events as devents
from rawalign_tpu.testing import synth
from rawalign_tpu_torch.signal import events

torch.set_num_threads(1)

OPT = config.MappingOptions()
W1, W2 = OPT.window_length1, OPT.window_length2
KW = dict(w1=W1, w2=W2, threshold1=OPT.threshold1, threshold2=OPT.threshold2,
          peak_height=OPT.peak_height)


def _chunks(seed, n, L):
    """Synthetic read-signal chunks of varying length, plus one of noise
    (the signals of tests/test_torch_events.py)."""
    rng = np.random.default_rng(seed)
    pm = synthetic_pore_model(k=6, seed=seed)
    out = []
    for _ in range(n):
        seq = "".join(rng.choice(list("ACGT"), size=rng.integers(80, 600)))
        out.append(synth.simulate_read_signal(rng, seq, pm, noise_pa=1.5)[:L])
    out.append(rng.normal(95.0, 15.0, L).astype(np.float32))
    return out


def _batch(sigs, L):
    batch = np.zeros((len(sigs), L), np.float32)
    lens = np.zeros(len(sigs), np.int64)
    for i, s in enumerate(sigs):
        batch[i, : s.size] = s
        lens[i] = s.size
    return torch.from_numpy(batch), torch.from_numpy(lens)


def _peak_args(sigs, L):
    sig, lens = _batch(sigs, L)
    steps = int(lens.max())
    ps, pss = events._prefix_sums(sig, lens, steps)
    return (events._tstat(ps, pss, lens, W1), events._tstat(ps, pss, lens, W2),
            lens, steps, (events._f32(OPT.threshold1), events._f32(OPT.threshold2)),
            (W1, W2), events._f32(OPT.peak_height))


def _masked_at_the_end(sig):
    """``sig`` cut three samples after a short-detector peak above its
    threshold: that peak is the last nonzero t value of the cut chunk, so
    the short detector is inside it, and masks the long one, up to and at
    the last sample, where it fires."""
    args = _peak_args([sig], sig.size)
    t1 = args[0][0]
    peaks, n = events._peaks(*args)
    for p in peaks[0, : int(n[0])].tolist()[::-1]:
        if float(t1[p]) > OPT.threshold1 and 4 * W2 < p < sig.size - W1:
            return sig[: p + W1], p
    raise AssertionError("no short-detector peak above its threshold")


def _edge_signals():
    rng = np.random.default_rng(0)
    step = np.concatenate([np.full(500, 90.0), np.full(500, 110.0)])
    cut, _p = _masked_at_the_end(_chunks(3, 1, 4000)[0])
    return [
        np.zeros(0, np.float32),
        rng.normal(95.0, 10.0, 2 * W2 - 1).astype(np.float32),
        rng.normal(95.0, 10.0, 2 * W2).astype(np.float32),
        np.full(1000, 95.0, np.float32),
        step.astype(np.float32),
        rng.normal(95.0, 15.0, 2500).astype(np.float32),
        cut,
    ]


CASES = {"reads_4000": lambda: (_chunks(3, 6, 4000), 4000),
         "reads_997": lambda: (_chunks(4, 6, 997), 997),
         "edges": lambda: (_edge_signals(), 4000)}


MODES = {"whole": {}, "chunks": dict(chunk=15), "chunks_4000": dict(chunk=17),
         "wide_chunks": dict(chunk=31), "small_chunks": dict(chunk=7),
         "single_samples": dict(chunk=1)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_peaks_equal_peaks(case, mode):
    sigs, L = CASES[case]()
    args = _peak_args(sigs, L)
    peaks, n = events._peaks(*args)
    got_peaks, got_n = events._peaks_split_plain(*args, **MODES[mode])
    assert torch.equal(got_n, n)
    assert torch.equal(got_peaks, peaks)
    assert int(n.sum()) > 100


def test_chunks_run_again_until_each_started_right(monkeypatch):
    """A read's signal needs a few rounds after the first, far fewer than
    it has chunks: a state that is wrong at a chunk's start is right after
    the chunk's first fire. White noise needs more."""
    calls = []
    run = events._detector_run

    def counted(*a, **k):
        calls.append(a[0])
        return run(*a, **k)

    monkeypatch.setattr(events, "_detector_run", counted)
    sigs = _chunks(3, 2, 4000)
    n_chunks = -(-3999 // 17)
    rounds = []
    for sig in (sigs[:2], sigs[2:]):
        del calls[:]
        events._peaks_split_plain(*_peak_args(sig, 4000), chunk=17)
        rounds.append((calls.count(False), calls.count(True)))
    reads, noise = rounds  # (short detector, long detector)
    assert all(2 <= n <= 6 for n in reads), reads
    assert all(r <= n < n_chunks // 4 for r, n in zip(reads, noise)), noise


def test_short_detector_masks_the_long_one_at_the_last_sample():
    cut, p = _masked_at_the_end(_chunks(3, 1, 4000)[0])
    args = _peak_args([cut], cut.size)
    peaks, n = events._peaks(*args)
    for mode in MODES.values():
        got_peaks, got_n = events._peaks_split_plain(*args, **mode)
        assert torch.equal(got_n, n) and torch.equal(got_peaks, peaks)
    # the short detector's last peak fires at the last sample
    assert int(peaks[0, int(n[0]) - 1]) == p == cut.size - W1


@pytest.fixture
def split_detector(monkeypatch):
    """``detect_events_plain`` with the split peak machine, in the
    kernel's chunks, in place of ``_peaks``."""
    monkeypatch.setattr(events, "_peaks", functools.partial(
        events._peaks_split_plain, chunk=17))
    return events.detect_events_plain


@pytest.mark.parametrize("case,max_events", [
    ("reads_4000", 2048), ("reads_997", 2048), ("edges", 2048), ("edges", 32)])
def test_split_detector_matches_golden_and_native(split_detector, case,
                                                  max_events):
    if not native.events_available():
        pytest.skip("native host library not built")
    sigs, L = CASES[case]()
    sig, lens = _batch(sigs, L)
    res = split_detector(sig, lens.to(torch.int32), max_events=max_events, **KW)
    total = 0
    for i, s in enumerate(sigs):
        want = gevents.detect_events(s, OPT)
        if s.size:
            np.testing.assert_array_equal(native.detect_events(s, **KW), want)
        n = int(res.n_events[i])
        assert n == min(want.size, max_events), i
        assert int(res.n_dropped[i]) == max(want.size - max_events, 0), i
        np.testing.assert_array_equal(res.values[i, :n].numpy(),
                                      want[:max_events])
        assert not res.values[i, n:].any()
        total += want.size
    assert total > 400
    if case == "edges":
        assert [int(res.n_events[i]) for i in (0, 3, 4)] == [0, 0, 1]
        assert np.isnan(res.values[4, 0].item())  # one event: zero deviation


def test_split_detector_matches_jax_device_detector_within_its_tolerance(
        split_detector):
    sigs = _chunks(3, 6, 4000)
    sig, lens = _batch(sigs, 4000)
    res = split_detector(sig, lens.to(torch.int32), max_events=2048, **KW)
    jres = devents.detect_events_batch(sig.numpy(), lens.numpy().astype(np.int32),
                                       max_events=2048)
    n_equal = n_total = n_match = 0
    for i in range(len(sigs)):
        got = res.values[i, : int(res.n_events[i])].numpy()
        want = np.asarray(jres.values[i][: int(jres.n_events[i])])
        assert abs(got.size - want.size) <= 2, (i, got.size, want.size)
        if got.size == want.size:
            n_equal += 1
            n_total += got.size
            n_match += int(np.sum(np.abs(got - want) < 1e-4))
    assert n_equal >= len(sigs) // 2
    assert n_total > 400
    assert n_match >= 0.995 * n_total, f"{n_match}/{n_total} events match"
