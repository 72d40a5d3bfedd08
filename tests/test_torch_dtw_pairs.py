"""The port's non-indexed DTW dispatch (``map/tiles.py``: ``dtw_submit``,
``dtw_collect``, ``dtw_banded_pairs``, ``prepare_tiles`` and
``dtw_banded``) against the JAX package's (its Pallas kernel in
interpret mode, as ``tests/test_dtw_device.py`` runs it), the native
library and the golden engine's DTW.

Every comparison on finite inputs is exact: the plain one-launch round
(the CUDA kernel's formulation, which the wrapper runs for CPU tensors)
computes each cell on the same float32 operands in the same order as
all three references.
"""

import numpy as np
import pytest
import torch

from rawalign_tpu.golden import dtw as gdtw
from rawalign_tpu.map import tiles as jtiles
from rawalign_tpu_torch import native
from rawalign_tpu_torch.map import tiles

torch.set_num_threads(1)

#: tests/test_dtw_device.py's shapes: read side x reference side
SHAPES = [(1, 1), (4, 4), (10, 7), (7, 10), (30, 30), (30, 17), (17, 30),
          (64, 40), (40, 64), (200, 30), (30, 200), (128, 128), (200, 190)]


@pytest.fixture(autouse=True)
def _need_native():
    if not native.available():
        pytest.skip("native host library not built")


def _rand(rng, n):
    return rng.normal(0.0, 1.0, size=n).astype(np.float32)


def _pairs(seed, shapes=SHAPES, radii=(1, 2, 5, 12)):
    rng = np.random.default_rng(seed)
    pairs = []
    for al, bl in shapes:
        for r in radii:
            for excl in (False, True):
                if excl and al == 1 and bl == 1:
                    continue
                pairs.append((_rand(rng, al), _rand(rng, bl), r, excl))
    return pairs


def _golden(pairs):
    return np.array([gdtw.dtw_global_slantedbanded_antidiagonalwise(a, b, r, x)
                     for a, b, r, x in pairs], np.float32)


@pytest.mark.parametrize("seed", range(2))
def test_prepare_tiles_equals_the_jax_arrays(seed):
    pairs = _pairs(seed)
    got, want = tiles.prepare_tiles(pairs), jtiles.prepare_tiles(pairs)
    for f in ("a2", "b2", "a_len", "b_len", "radius", "exclude_last",
              "a_last", "b_last", "d00"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert (got.dpw, got.max_n, got.n_tiles) == (want.dpw, want.max_n,
                                                 want.n_tiles)


@pytest.mark.parametrize("seed", range(2))
def test_pairs_equal_jax_native_and_golden(seed):
    pairs = _pairs(seed)
    kw = dict(device_max_n=256, device_max_b=256)
    got = tiles.dtw_banded_pairs(pairs, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == (len(pairs),)
    np.testing.assert_array_equal(got, jtiles.dtw_banded_pairs(pairs, **kw))
    np.testing.assert_array_equal(got, native.dtw_banded_batch(pairs))
    np.testing.assert_array_equal(got, _golden(pairs))


def test_dtw_banded_on_prepared_tiles_equals_jax_and_native():
    pairs = _pairs(7)
    got = tiles.dtw_banded(tiles.prepare_tiles(pairs), device="cpu")
    np.testing.assert_array_equal(
        got, jtiles.dtw_banded(jtiles.prepare_tiles(pairs)))
    np.testing.assert_array_equal(got, native.dtw_banded_batch(pairs))


def test_production_band_fracs():
    """Radii as the mapper computes them, 10% of the read side, with
    exclude_last (tests/test_dtw_device.py's second case)."""
    rng = np.random.default_rng(99)
    pairs = []
    for al in (20, 45, 80, 150, 400):
        for stretch in (0.7, 1.0, 1.4):
            bl = max(1, int(al * stretch))
            pairs.append((_rand(rng, al), _rand(rng, bl), max(1, int(al * 0.10)),
                          True))
    got = tiles.dtw_banded_pairs(pairs, device="cpu", device_max_n=1024,
                                 device_max_b=1024)
    np.testing.assert_array_equal(got, native.dtw_banded_batch(pairs))
    np.testing.assert_array_equal(got, _golden(pairs))


def test_split_across_device_max_n_keeps_input_order():
    """Pairs past device_max_n / device_max_b run in the native library;
    the costs come back in input order, equal to an all-device call."""
    pairs = _pairs(3)
    pend = tiles.dtw_submit(pairs, device="cpu", device_max_n=40,
                            device_max_b=20)
    assert pend.small_idx.size and pend.large_idx.size
    n = np.array([max(a.size, b.size) for a, b, _, _ in pairs])
    m = np.array([min(a.size, b.size) for a, b, _, _ in pairs])
    np.testing.assert_array_equal(pend.large_idx,
                                  np.nonzero((n > 40) | (m > 20))[0])
    got = tiles.dtw_collect(pend)
    np.testing.assert_array_equal(
        got, tiles.dtw_banded_pairs(pairs, device="cpu", device_max_n=256,
                                    device_max_b=256))
    np.testing.assert_array_equal(got, native.dtw_banded_batch(pairs))


def test_swapped_pairs_cost_the_same():
    """A pair and its swap make the same tile (a is the longer side either
    way) when they share the radius; ties keep the read side as a."""
    rng = np.random.default_rng(5)
    pairs = [(_rand(rng, al), _rand(rng, bl), r, x)
             for al, bl in ((30, 17), (9, 40), (25, 25)) for r in (2, 6)
             for x in (False, True)]
    swapped = [(b, a, r, x) for a, b, r, x in pairs]
    got = tiles.dtw_banded_pairs(pairs + swapped, device="cpu")
    k = len(pairs)
    same = [a.size != b.size for a, b, _, _ in pairs]
    np.testing.assert_array_equal(got[:k][same], got[k:][same])
    np.testing.assert_array_equal(got, native.dtw_banded_batch(pairs + swapped))


def test_exclude_last_is_applied_by_the_kernel():
    rng = np.random.default_rng(6)
    base = [(_rand(rng, al), _rand(rng, bl), 4, False)
            for al, bl in ((12, 9), (40, 33), (7, 19))]
    excl = [(a, b, r, True) for a, b, r, _ in base]
    got = tiles.dtw_banded_pairs(base + excl, device="cpu")
    assert (got[:3] != got[3:]).all()
    np.testing.assert_array_equal(got, native.dtw_banded_batch(base + excl))
    np.testing.assert_array_equal(got, jtiles.dtw_banded_pairs(base + excl))


def test_empty_and_one_by_one():
    assert tiles.dtw_banded_pairs([], device="cpu").shape == (0,)
    assert jtiles.dtw_banded_pairs([]).shape == (0,)
    rng = np.random.default_rng(8)
    ones = [(_rand(rng, 1), _rand(rng, 1), r, False) for r in (1, 3)]
    got = tiles.dtw_banded_pairs(ones, device="cpu")
    np.testing.assert_array_equal(got, np.abs(
        np.array([a[0] - b[0] for a, b, _, _ in ones], np.float32)))
    np.testing.assert_array_equal(got, native.dtw_banded_batch(ones))
    np.testing.assert_array_equal(
        tiles.dtw_banded(tiles.prepare_tiles(ones), device="cpu"), got)


def test_the_card_is_required_for_cuda():
    """device="cuda" launches the kernel or raises; no CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs it")
    pairs = _pairs(0, shapes=[(5, 4)], radii=(2,))
    with pytest.raises(RuntimeError, match="cuda"):
        tiles.dtw_banded_pairs(pairs)
    with pytest.raises(RuntimeError, match="cuda"):
        tiles.dtw_banded(tiles.prepare_tiles(pairs))
