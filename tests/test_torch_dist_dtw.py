"""The sharded DTW round (``map/tiles.py:dtw_submit_indexed(mesh=)``, the
counterpart of the JAX package's ``dtw_banded_multi_indexed_sharded``)
against the one-card round, through the wrapper's CPU path on logical
ranks: the tiles dealt over 1, 2, 4 and 8 ranks longest first, one
launch a rank with tiles. Costs must be bit-identical (a tile's cost does
not depend on the other tiles of its launch)."""

import numpy as np
import pytest
import torch

from rawalign_tpu_torch.map import tiles as ttiles
from rawalign_tpu_torch.parallel import mesh as pmesh
from test_torch_dtw import LREF, _native_costs, _pools, _random_tiles

torch.set_num_threads(1)

CPU = torch.device("cpu")
#: the device cap of these rounds: longer tiles run in the native library
CAP = 128


def _submit(ref, hist, da, mesh=None):
    flat = np.concatenate([ref, hist.reshape(-1)])
    ref_t = torch.from_numpy(ref)
    pend = ttiles.dtw_submit_indexed(
        *(da[:, k].astype(np.int32) for k in range(6)),
        ref_t if mesh is None else {dev: ref_t for dev in mesh.distinct},
        torch.from_numpy(hist), ref, device_max_n=CAP, device_max_b=CAP,
        ev_fetch=lambda i, n: flat[LREF + i : LREF + i + n], mesh=mesh,
    )
    return ttiles.dtw_collect(pend), pend


@pytest.fixture
def launches(monkeypatch):
    """Every run_round call (one kernel launch on a card), by the number
    of tiles it takes."""
    calls = []
    run_round = ttiles.run_round

    def counted(ref, hist, descs):
        calls.append(descs.shape[1])
        return run_round(ref, hist, descs)

    monkeypatch.setattr(ttiles, "run_round", counted)
    return calls


@pytest.mark.parametrize("n_tiles", [3, 60])
@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
def test_sharded_round_equals_one_card_round(ranks, n_tiles, launches):
    rng = np.random.default_rng(ranks * 100 + n_tiles)
    ref, hist = _pools(rng)
    da = _random_tiles(rng, n_tiles, max_len=200)
    want, pend1 = _submit(ref, hist, da)
    assert launches == [pend1.small_idx.size]
    mesh = pmesh.make_mesh(1, ranks, devices=[CPU] * ranks)
    launches.clear()
    got, pend = _submit(ref, hist, da, mesh)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, _native_costs(ref, hist, da))
    # tiles above the cap went to the native library, the rest over the
    # ranks: one launch a rank with tiles, none for a rank without
    n_small = int(((da[:, 1] <= CAP) & (da[:, 3] <= CAP)).sum())
    assert pend.large_idx.size == n_tiles - n_small
    assert sorted(pend.small_idx.tolist()) == sorted(pend1.small_idx.tolist())
    assert len(launches) == min(ranks, n_small)
    assert sum(launches) == n_small
    if n_tiles == 60:
        assert pend.large_idx.size > 0


def test_deal_is_longest_first_round_robin():
    n = np.array([5, 40, 3, 40, 12, 7, 1], np.int32)
    parts = ttiles.deal(n, 3)
    assert [p.tolist() for p in parts] == [[1, 5, 6], [3, 0], [4, 2]]
    # each rank's longest tile is among the R longest
    assert [int(n[p].max()) for p in parts] == [40, 40, 12]
    assert [p.tolist() for p in ttiles.deal(n[:2], 4)] == [[1], [0], [], []]


def test_sharded_round_on_a_2d_mesh_with_fewer_tiles_than_ranks(launches):
    """A (2, 2) mesh with a round of fewer tiles than ranks: the last
    rank has none and launches nothing."""
    rng = np.random.default_rng(5)
    ref, hist = _pools(rng)
    da = _random_tiles(rng, 3, max_len=100)
    want, _ = _submit(ref, hist, da)
    mesh = pmesh.make_mesh(2, 2, devices=[CPU] * 4)
    launches.clear()
    got, pend = _submit(ref, hist, da, mesh)
    np.testing.assert_array_equal(got, want)
    assert launches == [1, 1, 1]
    assert pend.large_idx.size == 0
