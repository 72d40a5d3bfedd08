"""The CUDA sketch kernel's formulation, ``_sketch_scan_jump_plain`` (jump
pointers, the kept list by rank, elementwise outputs), against the plain
sequential scan ``_sketch_scan`` and, through it, the JAX scan
(``rawalign_tpu/seeds/sketch.py:_sketch_scan``), on the CPU.

All five outputs (hashes, emit, newest, oldest, kept count) are compared
exactly: both sides do the same float32 comparisons and the same uint32
arithmetic. The rows are the awkward ones: ``n_events`` of 0, 1,
``e - 1``, ``e`` and NE; event 0 masked; runs of masked events; a whole
row within 0.3 of its first event; NaN events; and seeds of 1, 5, 6, 7
and 16 events with ``(q, lq)`` that put ``quant_bit * e`` below, at and
above 32, where older codes fall off the top of the uint32 pack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rawalign_tpu.seeds import sketch as jsketch
from rawalign_tpu_torch.seeds import sketch

torch.set_num_threads(1)

MASK = np.float32(3.402823466e32)
B, NE = 8, 64
#: (e, q, lq): quant_bit * e = 5, 25, 30, 35, 32, 80, 42, 28
COMBOS = [(1, 9, 3), (5, 9, 3), (6, 9, 3), (7, 9, 3), (16, 9, 0), (16, 9, 3),
          (6, 12, 5), (7, 8, 2)]


def _rows(seed, e, mask0, nan, p_mask):
    """B rows: noisy levels with runs of similar events and masked events
    at rate ``p_mask``; row 1 lies within 0.3 of its first event, row 2
    has a run of masked events, with ``mask0`` rows 0 and 3 start masked,
    with ``nan`` rows 0 and 4 hold NaN events. n_events covers 0, 1,
    e - 1, e and NE."""
    rng = np.random.default_rng(seed)
    ev = rng.normal(0.0, 1.0, (B, NE)).astype(np.float32)
    for b in range(B):
        for s in rng.integers(0, NE, size=NE // 8):
            k = ev[b, s : s + 4].size
            ev[b, s : s + 4] = ev[b, s] + rng.uniform(-0.2, 0.2, k).astype(np.float32)
    ev[rng.random((B, NE)) < p_mask] = MASK
    ev[1] = ev[1, 0] if ev[1, 0] != MASK else np.float32(0.5)
    ev[1] += rng.uniform(-0.14, 0.14, NE).astype(np.float32)
    ev[2, 3:20] = MASK
    if mask0:
        ev[0, 0] = MASK
        ev[3, :3] = MASK
    if nan:
        ev[0, rng.integers(1, NE, 3)] = np.nan
        ev[4, 0] = np.nan
    n = np.array([NE, NE, NE, min(e, NE), max(e - 1, 0), 1, 0,
                  rng.integers(0, NE + 1)], dtype=np.int32)
    return ev, n


def _hold(ev, n, e, q, lq, jax_too=True):
    t_ev, t_n = torch.from_numpy(ev), torch.from_numpy(n)
    got = sketch._sketch_scan_jump_plain(t_ev, t_n, e, q, lq)
    want = sketch._sketch_scan(t_ev, t_n, e, q, lq)
    names = ("hashes", "emit", "newest", "oldest", "cnt")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, (g != w).nonzero()[:4])
    if jax_too:
        jwant = jsketch._sketch_scan(jnp.asarray(ev), jnp.asarray(n), e, q, lq)
        for name, g, w in zip(names, got, jwant):
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(w).astype(g.numpy().dtype), err_msg=name)
    return got


@pytest.mark.parametrize("e,q,lq", COMBOS)
@settings(max_examples=10, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**32 - 1), mask0=st.booleans(), nan=st.booleans(),
       p_mask=st.sampled_from([0.0, 0.02, 0.3, 0.9]))
def test_jump_equals_scan_and_jax(e, q, lq, seed, mask0, nan, p_mask):
    ev, n = _rows(seed, e, mask0, nan, p_mask)
    _hold(ev, n, e, q, lq)


@pytest.mark.parametrize("e,q,lq", COMBOS)
def test_jump_on_the_awkward_rows(e, q, lq):
    """One fixed batch per seed width, with what it exercises asserted:
    the similar row keeps one event, the masked start is skipped, seeds
    are emitted, and where the pack overflows the uint32 the oldest codes
    no longer reach the hash."""
    ev, n = _rows(e, e, True, True, 0.05)
    hashes, emit, _newest, oldest, cnt = _hold(ev, n, e, q, lq)
    assert int(cnt[1, -1]) == 1  # the whole row is similar to its first event
    assert int(cnt[0, 0]) == 0 and int(cnt[3, 2]) == 0  # masked starts
    assert int(cnt[6, -1]) == 0 and int(cnt[5, -1]) <= 1
    assert not emit[4].any()  # e - 1 events never fill a seed
    assert emit[2].any() and int(oldest[2][emit[2]].max()) > 0
    assert (hashes[~emit] == 0).all()


def test_jump_overflowing_pack_forgets_the_oldest_codes():
    """quant_bit * e = 80: only the 6 newest codes (shifts 0..25) and two
    bits of the 7th reach the uint32, so changing the oldest kept event of
    a seed does not change its hash, while with quant_bit * e = 30 it
    does."""
    rng = np.random.default_rng(5)
    row = np.arange(NE, dtype=np.float32) % 7 - 3.0
    row += rng.uniform(-0.01, 0.01, NE).astype(np.float32)
    ev = np.stack([row, row])
    ev[1, 0] = -ev[1, 0]  # flips the sign bit: another code, still kept
    n = np.full(2, NE, np.int32)
    wide = _hold(ev, n, 16, 9, 3, jax_too=False)
    assert wide[1][0, 15] and torch.equal(wide[0][0, 15], wide[0][1, 15])
    narrow = _hold(ev, n, 6, 9, 3, jax_too=False)
    assert narrow[1][0, 5] and not torch.equal(narrow[0][0, 5], narrow[0][1, 5])


@pytest.mark.parametrize("shape", [(0, 16), (3, 0), (1, 1), (2, 33)])
def test_jump_on_degenerate_shapes(shape):
    rng = np.random.default_rng(sum(shape))
    ev = rng.normal(0.0, 1.0, shape).astype(np.float32)
    n = np.full(shape[0], shape[1], np.int32)
    _hold(ev, n, 6, 9, 3, jax_too=False)
