"""The one-launch formulation of the banded DTW (``map/dtw.py:
dtw_banded_round``, what ``csrc/dtw_banded.cu`` computes): every tile of
a round at its own band width, in the work-list order of
``map/tiles.py:work_list``, with the reference's edge cases dropped.

It is held to the per-class plain version (``dtw_banded_indexed``, the
JAX kernel's formulation at the class band width ``dpw``), to
``native.dtw_banded_batch`` and to the JAX package's
``dtw_banded_multi_indexed`` in interpret mode, on tiles made from a
seed. Every comparison is exact (``torch.equal``, NaN for NaN).
"""

import numpy as np
import pytest
import torch

from rawalign_tpu import native
from rawalign_tpu.map import tiles as jtiles
from rawalign_tpu_torch.map import dtw as tdtw
from rawalign_tpu_torch.map import dtw_cuda
from rawalign_tpu_torch.map import tiles as ttiles
from test_torch_dtw import HMAX, LREF, _native_costs, _pools, _random_tiles

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _need_native():
    if not native.available():
        pytest.skip("native host library not built")


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _mixed_tiles(rng, n_tiles):
    """Random tiles plus the awkward ones: in one size class a tile of a
    wide band beside tiles of R = 1 (R far below the class's dpw), 1x1
    tiles with and without exclude_last, and equal lengths."""
    da = _random_tiles(rng, n_tiles)
    ev = LREF + HMAX
    extra = [
        (0, 200, ev, 100, 100, 1),   # R = 200: dpw 256 for class 256
        (300, 200, ev, 199, 1, 0),   # R = 2 in the same class
        (600, 180, ev + 5, 180, 1, 1),  # R = 1
        (900, 1, ev + 9, 1, 1, 1), (901, 1, ev + 9, 1, 4, 0),
        (ev + 20, 64, 1000, 64, 6, 1), (ev + 30, 65, 1100, 65, 7, 0),
    ]
    return np.concatenate([da, np.asarray(extra, np.int64)])


def _classed(da, device_max_n=256):
    """(order, descs in class order, class batches) as the dispatch
    builds them."""
    cols = [da[:, k].astype(np.int32) for k in range(6)]
    return ttiles.class_batches(*cols, np.arange(da.shape[0]),
                                device_max_n=device_max_n)


def _per_class(ref, hist, descs, batches):
    d = torch.from_numpy(descs)
    return torch.cat([
        tdtw.dtw_banded_indexed(ref, hist, d[:, c.start : c.start + c.count],
                                dpw=c.dpw)
        for c in batches
    ])


def _round(ref, hist, descs, **kw):
    """The round through the wrapper on CPU tensors: the plain
    formulation in the work list's order."""
    jobs, block_w, stage = ttiles.work_list(descs, **kw)
    return dtw_cuda.dtw_banded_round(ref, hist, torch.from_numpy(descs),
                                     torch.from_numpy(jobs), block_w=block_w,
                                     stage=stage)


@pytest.mark.parametrize("seed", range(3))
def test_round_matches_per_class_plain_and_native(seed):
    rng = np.random.default_rng(100 + seed)
    ref, hist = _pools(rng)
    da = _mixed_tiles(rng, 150)
    order, descs, batches = _classed(da)
    tr, th = torch.from_numpy(ref), torch.from_numpy(hist)
    got = _round(tr, th, descs)
    assert torch.equal(got, _per_class(tr, th, descs, batches))
    assert torch.equal(got, torch.from_numpy(_native_costs(ref, hist, da[order])))
    R = ttiles._widened_radius(da[:, 1], da[:, 3], da[:, 4])
    assert set(R % 2) == {0, 1} and set(da[:, 5]) == {0, 1}
    # tiles whose band is a small part of their class's
    w = np.maximum(descs[6], descs[7]) + 2
    dpw = np.concatenate([np.full(c.count, c.dpw) for c in batches])
    assert (w * 8 <= dpw).any()


@pytest.mark.parametrize("pad", [-1, 1, 5])
def test_any_band_width_from_max_lp_ls_plus_one_gives_the_same_costs(pad):
    rng = np.random.default_rng(7)
    ref, hist = _pools(rng)
    _order, descs, _b = _classed(_mixed_tiles(rng, 60))
    tr, th, d = torch.from_numpy(ref), torch.from_numpy(hist), torch.from_numpy(descs)
    assert torch.equal(tdtw.dtw_banded_round(tr, th, d, pad=pad),
                       tdtw.dtw_banded_round(tr, th, d))


@pytest.mark.parametrize("side", ["short", "long"])
def test_nan_events(side):
    """A NaN event (a z-norm of zero deviation). On the shorter side the
    NaN cells form a column, which fminf, torch.fmin and the native
    twin's ternaries all step over: the three agree. On the longer side
    the native twin carries NaN down the rows where fminf drops it, so
    the round is held to the per-class plain version alone there (the
    JAX package's jnp.minimum carries NaN everywhere)."""
    rng = np.random.default_rng(11)
    ref, hist = _pools(rng)
    da = _random_tiles(rng, 120, max_len=120)
    flat = hist.reshape(-1)
    for a_base, n, b_base, m, _r, _x in da[::3]:
        base, ln = (b_base, m) if side == "short" else (a_base, n)
        pos = base + int(rng.integers(0, ln))
        if pos >= LREF:
            flat[pos - LREF] = np.nan
        else:
            ref[pos] = np.nan
    order, descs, batches = _classed(da)
    tr, th = torch.from_numpy(ref), torch.from_numpy(hist)
    got = _round(tr, th, descs)
    assert _same(got, _per_class(tr, th, descs, batches))
    pool = np.concatenate([ref, flat])
    nan_in = [np.isnan(pool[a : a + n]).any() for a, n in da[order][:, :2]]
    nan_in_b = [np.isnan(pool[b : b + m]).any() for b, m in da[order][:, 2:4]]
    # tiles share the pools: a NaN put on one tile's shorter side may lie
    # on another's longer side
    short = torch.from_numpy(~np.asarray(nan_in) & np.asarray(nan_in_b))
    if side == "short":
        assert short.sum() >= 5 and (got[short] == np.float32(1e10)).any()
        want = torch.from_numpy(_native_costs(ref, hist, da[order]))
        keep = torch.from_numpy(~np.asarray(nan_in))
        assert _same(got[keep], want[keep])
    else:
        assert sum(nan_in) >= 20


def test_round_matches_pallas_interpret():
    import jax

    rng = np.random.default_rng(9)
    ref, hist = _pools(rng)
    da = _mixed_tiles(rng, 40)
    pend = jtiles.dtw_submit_indexed(
        *(da[:, k].astype(np.int32) for k in range(6)),
        jax.device_put(ref), np.zeros(0, np.float32), ref,
        device_max_n=256, device_max_b=256, ev_dev=jax.device_put(hist),
    )
    want = jtiles.dtw_collect(pend)
    order, descs, _b = _classed(da)
    got = np.zeros(da.shape[0], np.float32)
    got[order] = _round(torch.from_numpy(ref), torch.from_numpy(hist), descs).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("warp_max_slots", [0, 32, 64, 128, 256])
def test_work_list(warp_max_slots):
    """Every tile once; a warp tile's band fits its K lanes' slots, a
    block tile's does not fit any allowed K; jobs longest first; the
    cost of every tile in column order whatever the cut-off."""
    rng = np.random.default_rng(13)
    ref, hist = _pools(rng)
    da = np.concatenate([_mixed_tiles(rng, 100),
                         np.asarray([(0, 300, LREF, 150, 300, 1)], np.int64)])
    _order, descs, batches = _classed(da, device_max_n=2048)
    jobs, block_w, stage = ttiles.work_list(descs, warp_max_slots=warp_max_slots)
    top = 32 * max(dtw_cuda.WARP_K)  # the widest warp tile
    assert jobs.dtype == np.int32 and jobs.shape[1] == 1 + dtw_cuda.JOB_WARPS
    tiles = jobs[:, 1:].reshape(-1)
    assert sorted(tiles[tiles >= 0].tolist()) == list(range(descs.shape[1]))
    w = np.maximum(descs[6], descs[7]) + 2
    n = descs[2]
    lead = n[jobs[:, 1]]
    assert (np.diff(lead) <= 0).all()
    for kind, *ts in jobs.tolist():
        ts = [t for t in ts if t >= 0]
        if kind == 0:
            assert len(ts) == 1 and w[ts[0]] > min(warp_max_slots, top)
            assert w[ts[0]] <= block_w
        else:
            assert kind in dtw_cuda.WARP_K and 32 * kind <= warp_max_slots
            assert all(w[t] <= 32 * kind and (kind == 1 or w[t] > 16 * kind)
                       for t in ts)
            assert list(n[ts]) == sorted(n[ts], reverse=True)
    assert block_w == (int(w[w > min(warp_max_slots, top)].max())
                       if (w > min(warp_max_slots, top)).any() else 0)
    warp_tiles = w <= min(warp_max_slots, top)
    assert stage == (int((n + descs[5])[warp_tiles].max()) if warp_tiles.any() else 0)
    tr, th = torch.from_numpy(ref), torch.from_numpy(hist)
    got = _round(tr, th, descs, warp_max_slots=warp_max_slots)
    assert torch.equal(got, _per_class(tr, th, descs, batches))


def test_work_list_order_leaves_the_output_order():
    rng = np.random.default_rng(17)
    ref, hist = _pools(rng)
    _order, descs, _b = _classed(_mixed_tiles(rng, 50))
    tr, th, d = torch.from_numpy(ref), torch.from_numpy(hist), torch.from_numpy(descs)
    plain = tdtw.dtw_banded_round(tr, th, d)
    T = descs.shape[1]
    for order in (np.arange(T)[::-1].copy(), rng.permutation(T)):
        assert torch.equal(tdtw.dtw_banded_round(tr, th, d, order=order), plain)
    assert torch.equal(_round(tr, th, descs), plain)
