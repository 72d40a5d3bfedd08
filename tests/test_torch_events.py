"""The port's event detector (plain PyTorch version) against the golden
detector, the native C detector and the JAX device detector, on the CPU.

Against golden and native the comparison is exact: the port keeps their
semantics (float32 prefix sums and t-statistics, the t quotient and the
z-norm in float64), so values, counts and NaNs are equal bit for bit
(``assert_array_equal`` treats NaN as equal to NaN).

Against the JAX device detector the tolerance is the one the JAX
package holds that detector to against golden
(``tests/test_events_device.py``): counts within 2, at least half the
rows with equal counts, and 99.5% of the events of those rows within
1e-4. The JAX detector is float32 throughout, and its XLA CPU arithmetic
has no bit pattern PyTorch can reproduce: ``a / sqrt(b)`` becomes
``a * rsqrt(b)``, row sums are reassociated, and denormals are flushed.
"""

import numpy as np
import pytest
import torch

from rawalign_tpu import config, native
from rawalign_tpu.golden import events as gevents
from rawalign_tpu.pore_model import synthetic_pore_model
from rawalign_tpu.signal import events as devents
from rawalign_tpu.testing import synth
from rawalign_tpu_torch.signal import events, events_cuda

torch.set_num_threads(1)

OPT = config.MappingOptions()
KW = dict(w1=OPT.window_length1, w2=OPT.window_length2,
          threshold1=OPT.threshold1, threshold2=OPT.threshold2,
          peak_height=OPT.peak_height)


def _chunks(seed, n, L):
    """Synthetic read-signal chunks of varying length, plus one of noise."""
    rng = np.random.default_rng(seed)
    pm = synthetic_pore_model(k=6, seed=seed)
    out = []
    for _ in range(n):
        seq = "".join(rng.choice(list("ACGT"), size=rng.integers(80, 600)))
        out.append(synth.simulate_read_signal(rng, seq, pm, noise_pa=1.5)[:L])
    out.append(rng.normal(95.0, 15.0, L).astype(np.float32))
    return out


def _port(sigs, L, max_events):
    batch = np.zeros((len(sigs), L), np.float32)
    lens = np.zeros(len(sigs), np.int32)
    for i, s in enumerate(sigs):
        batch[i, : s.size] = s
        lens[i] = s.size
    before = events_cuda.launches
    res = events.detect_events_batch(
        torch.from_numpy(batch), torch.from_numpy(lens), max_events=max_events,
        **KW)
    assert events_cuda.launches == before  # CPU tensors: the plain version
    return batch, lens, res


def _check_against_golden(sigs, res, max_events):
    for i, s in enumerate(sigs):
        want = gevents.detect_events(s, OPT)
        if s.size:
            np.testing.assert_array_equal(
                native.detect_events(s, **KW), want)
        n = int(res.n_events[i])
        assert n == min(want.size, max_events), i
        assert int(res.n_dropped[i]) == max(want.size - max_events, 0), i
        np.testing.assert_array_equal(res.values[i, :n].numpy(),
                                      want[:max_events])
        assert not res.values[i, n:].any()


@pytest.mark.parametrize("seed,L", [(3, 4000), (4, 997)])
def test_events_match_golden_and_native(seed, L):
    if not native.events_available():
        pytest.skip("native host library not built")
    sigs = _chunks(seed, 6, L)
    _batch, _lens, res = _port(sigs, L, 2048)
    assert int(res.n_events.sum()) > 400
    _check_against_golden(sigs, res, 2048)


def test_events_edge_cases_match_golden():
    """An empty chunk, a constant chunk, a one-event chunk (a clean step:
    its z-norm divides by a zero deviation, NaN in golden and C alike), a
    chunk too short for the long window, chunks whose events exceed
    ``max_events``, and rows of different lengths in one batch."""
    if not native.events_available():
        pytest.skip("native host library not built")
    rng = np.random.default_rng(0)
    step = np.concatenate([np.full(500, 90.0), np.full(500, 110.0)])
    sigs = [
        np.zeros(0, np.float32),
        np.full(1000, 95.0, np.float32),
        step.astype(np.float32),
        rng.normal(95.0, 10.0, 9).astype(np.float32),
        rng.normal(95.0, 15.0, 4000).astype(np.float32),
        rng.normal(95.0, 15.0, 2500).astype(np.float32),
    ]
    _batch, _lens, res = _port(sigs, 4000, 32)
    assert [int(n) for n in res.n_events[:4]] == [0, 0, 1, 0]
    assert np.isnan(res.values[2, 0].item())
    assert int(res.n_dropped[4]) > 0 and int(res.n_dropped[5]) > 0
    _check_against_golden(sigs, res, 32)


def test_events_match_jax_device_detector_within_its_tolerance():
    sigs = _chunks(3, 6, 4000)
    batch, lens, res = _port(sigs, 4000, 2048)
    jres = devents.detect_events_batch(batch, lens, max_events=2048)
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


def test_event_wrapper_refuses_other_devices():
    sig = torch.zeros((2, 100), device="meta")
    with pytest.raises(ValueError, match="device"):
        events_cuda.detect_events(
            sig, torch.zeros(2, dtype=torch.int32, device="meta"),
            max_events=8, **KW)
