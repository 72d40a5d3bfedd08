"""The port's sketching against the JAX package's (its CPU lax.scan
reference).

Every comparison is exact: the port does the same uint32 arithmetic
(as masked int64) and the same float32 comparisons, so no tolerance is
needed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rawalign_tpu.seeds import sketch as jsketch
from rawalign_tpu_torch.seeds import sketch as tsketch
from rawalign_tpu_torch.seeds import sketch_cuda

torch.set_num_threads(1)


def _bits(rng, n):
    """Random uint32 bit patterns: negative floats, NaNs, denormals and
    RI_MASK_SIGNAL's pattern included."""
    b = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    b[:4] = np.array(
        [0, 0x80000000, 0xFFFFFFFF, np.float32(3.402823466e32).view(np.uint32)],
        dtype=np.uint32,
    )
    return b


def test_hash64_u32_matches_jax():
    b = _bits(np.random.default_rng(0), 4096)
    want = np.asarray(jsketch.hash64_u32(jnp.asarray(b)))
    got = tsketch.hash64_u32(torch.from_numpy(b.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.max() >= 1 << 31  # the high half is exercised


@pytest.mark.parametrize("q,lq", [(9, 3), (8, 2), (12, 5)])
def test_quantize_u32_matches_jax(q, lq):
    v = _bits(np.random.default_rng(q), 4096).view(np.float32)
    assert (v < 0).any() and np.isnan(v).any()
    want = np.asarray(jsketch.quantize_u32(jnp.asarray(v), q, lq))
    got = tsketch.quantize_u32(torch.from_numpy(v.copy()), q, lq).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _events(rng, B, NE):
    """Normalized-event-like rows with runs of similar adjacent events
    (suppressed by the 0.3 rule) and masked-signal events."""
    ev = rng.normal(0.0, 1.0, (B, NE)).astype(np.float32)
    for b in range(B):
        for s in rng.integers(0, NE, size=NE // 8):
            ev[b, s : s + 4] = ev[b, s] + rng.uniform(-0.2, 0.2, 4)[
                : ev[b, s : s + 4].size
            ].astype(np.float32)
    ev[rng.random((B, NE)) < 0.02] = np.float32(3.402823466e32)
    return ev


@pytest.mark.parametrize("e", [5, 6, 7])
def test_sketch_events_batch_matches_jax(e):
    rng = np.random.default_rng(e)
    B, NE = 6, 96
    ev = _events(rng, B, NE)
    n_ev = np.array([0, 1, NE, NE // 2, e, NE - 3], dtype=np.int32)
    want = jsketch.sketch_events_batch(
        jnp.asarray(ev), jnp.asarray(n_ev), e=e, q=9, lq=3
    )
    got = tsketch.sketch_events_batch(
        torch.from_numpy(ev), torch.from_numpy(n_ev), e=e, q=9, lq=3
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(
        got.hashes.numpy(), np.asarray(want.hashes).astype(np.int64)
    )
    np.testing.assert_array_equal(got.qpos.numpy(), np.asarray(want.qpos))
    assert got.valid.numpy().any()


@pytest.mark.parametrize("e", [5, 6, 7])
def test_sketch_scan_state_matches_jax(e):
    """All five outputs of the scan (hashes, emit, newest, oldest, kept
    count), including the constant tail past max(n_events)."""
    rng = np.random.default_rng(100 + e)
    B, NE = 4, 80
    ev = _events(rng, B, NE)
    n_ev = np.array([50, 3, 0, 61], dtype=np.int32)
    want = jsketch._sketch_scan(jnp.asarray(ev), jnp.asarray(n_ev), e, 9, 3)
    got = sketch_cuda.sketch_scan(
        torch.from_numpy(ev), torch.from_numpy(n_ev), e=e, q=9, lq=3
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_cpu_scan_launches_no_kernel():
    before = sketch_cuda.launches
    ev = np.zeros((2, 8), np.float32)
    sketch_cuda.sketch_scan(
        torch.from_numpy(ev), torch.zeros(2, dtype=torch.int32), e=6, q=9, lq=3
    )
    assert sketch_cuda.launches == before


@pytest.mark.parametrize("w", [1, 3, 5])
@pytest.mark.parametrize("e", [5, 7])
def test_sketch_events_min_batch_matches_jax(w, e):
    """The minimizer window filter: hashes, positions (the oldest event of
    each seed's window) and the kept set, on rows with masked-signal
    events, runs of similar events, an empty row, a row shorter than
    ``e`` and a full row."""
    rng = np.random.default_rng(10 * w + e)
    B, NE = 6, 128
    ev = _events(rng, B, NE)
    n_ev = np.array([0, e - 1, NE, NE // 2, e + 2, NE - 3], dtype=np.int32)
    want = jsketch.sketch_events_min_batch(
        jnp.asarray(ev), jnp.asarray(n_ev), w=w, e=e, q=9, lq=3
    )
    got = tsketch.sketch_events_min_batch(
        torch.from_numpy(ev), torch.from_numpy(n_ev), w=w, e=e, q=9, lq=3
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(
        got.hashes.numpy(), np.asarray(want.hashes).astype(np.int64)
    )
    np.testing.assert_array_equal(got.qpos.numpy(), np.asarray(want.qpos))
    emitted = int((got.hashes != 0).sum())
    kept = int(got.valid.sum())
    assert 0 < kept <= emitted
    if w > 1:
        assert kept < emitted
    assert not got.valid[:2].any()  # nothing kept from fewer than e events
