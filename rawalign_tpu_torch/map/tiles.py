"""DTW tile dispatch in descriptor form (port of rawalign_tpu/map/tiles.py).

The sparse border constraint turns every chain into many small (a, b)
DTW problems ("tiles", rmap.cpp:248-293); the native round tail emits
them as rows (a_base, a_len, b_base, b_len, radius, exclude_last) with
``a`` the longer side and bases into ``[reference pool | event
history]``. This module splits them by size exactly as the JAX engine
does: tiles with a side above ``device_max_n``/``device_max_b`` run in
the native host library on a worker thread, the rest are grouped into
power-of-two size classes split by R parity, one descriptor column each
(the JAX package's layout, so the plain per-class version and the JAX
classing can be held to it). The whole round is then one launch of the
banded DTW kernel (``map/dtw_cuda.py``) over a work list
(:func:`work_list`): each tile at its own band width, the longest tiles
first. The descriptors and the work list cross to the device in one
upload; the reference pool and the event history already live there.

The JAX package padded every class to a power-of-two multiple of 128
tiles with dummy 1x1 tiles to keep TPU compile shapes few; the CUDA
kernel has no compile shapes, so nothing is padded.

Over a mesh of devices (``parallel/mesh.py``; the JAX package's
``dtw_banded_multi_indexed_sharded``, which splits every class's tile axis
over all devices) the round's small tiles are dealt to the ranks longest
first (:func:`deal`), so each rank's slice holds about the same longest
tile and the round costs about its longest tile, and each rank with
tiles makes one launch on its own device (:func:`run_round_sharded`).
A tile's cost does not depend on the other tiles of its launch, so the
costs are bit-identical to the one-launch round.

The non-indexed dispatch (:func:`dtw_submit`, :func:`dtw_banded_pairs`;
the JAX package's ``dtw_banded_multi``) takes raw (read, reference,
radius, exclude_last) pairs: the small ones are laid out in one flat
pool, ``[every a side | every b side]`` after the swap that makes ``a``
the longer, with one descriptor column each, and run in one launch of
the same kernel; the large ones run in the native library. The kernel
applies ``exclude_last`` itself. :func:`prepare_tiles` and
:class:`TileBatch` are the JAX package's pre-shifted panels, copied as
they are; :func:`dtw_banded` reads a batch's tiles by descriptor from
its own two panels. The TPU kernel's operand layout (reversed,
transposed panels) and its host-side ``exclude_last`` correction are
not ported: this kernel reads neither.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np
import torch

from rawalign_tpu_torch import native, runtime
from rawalign_tpu_torch.map import dtw_cuda


def _pow2_at_least(x: int, lo: int) -> int:
    """Smallest power of two >= max(x, lo)."""
    p = lo
    while p < x:
        p *= 2
    return p


def _widened_radius(a_len, b_len, radius) -> np.ndarray:
    """R = r + ceil((n - m) r / n), the slope-widened band (dtw.cpp:294-300)."""
    n64 = np.maximum(a_len.astype(np.int64), 1)
    r64 = radius.astype(np.int64)
    return r64 + ((n64 - b_len.astype(np.int64)) * r64 + n64 - 1) // n64


def _desc_array(a_base, a_len, b_base, b_len, radius, excl, *,
                dpw: int) -> np.ndarray:
    """The (9, T) int32 descriptors of one class batch. Rows: a_base,
    off_a, n, b_base, off_b, m, lp, ls, excl (off_a/off_b are the JAX
    kernel's panel offsets, kept so the layout is the JAX package's)."""
    T = a_base.size
    R = _widened_radius(a_len, b_len, radius)
    lp = R + np.where(R % 2 == 0, 1, 0)
    ls = R + np.where(R % 2 == 1, 1, 0)
    half_lp = lp // 2
    d = np.zeros((9, T), dtype=np.int32)
    d[0] = a_base
    d[1] = (dpw - 1) - half_lp
    d[2] = a_len
    d[3] = b_base
    d[4] = half_lp + 1
    d[5] = b_len
    d[6] = lp
    d[7] = ls
    d[8] = excl
    return d


@dataclasses.dataclass
class ClassBatch:
    start: int  # first position in the class-ordered small-tile list
    count: int
    dpw: int
    max_n: int  # pow2 size class (the a side is at most this long)


def class_batches(a_base, a_len, b_base, b_len, radius, excl, small_idx, *,
                  device_max_n: int):
    """Order ``small_idx`` by (pow2 size class, R parity) as the JAX
    dispatch does. Returns (ordered small_idx, (9, N) int32 descriptors
    in that order, [ClassBatch, ...])."""
    if small_idx.size == 0:
        return small_idx, np.zeros((9, 0), np.int32), []
    # pow2 size classes (32, 64, ..., pow2 >= device_max_n)
    cls = np.full(small_idx.size, 32, np.int64)
    p = 64
    top = _pow2_at_least(device_max_n, 32)
    while p <= top:
        cls[a_len[small_idx] > p // 2] = p
        p *= 2
    R_all = _widened_radius(a_len[small_idx], b_len[small_idx], radius[small_idx])
    key = cls * 2 + (R_all % 2 == 0)
    order = np.argsort(key, kind="stable")
    small_idx = small_idx[order]
    cls = cls[order]
    key = key[order]
    bounds = np.nonzero(np.diff(key))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [small_idx.size]])
    descs, batches = [], []
    for s0, s1 in zip(starts, ends):
        sel = small_idx[s0:s1]
        R = _widened_radius(a_len[sel], b_len[sel], radius[sel])
        dpw = _pow2_at_least(int(R.max(initial=1)) + 3, 16)
        descs.append(_desc_array(
            a_base[sel], a_len[sel], b_base[sel], b_len[sel], radius[sel],
            excl[sel], dpw=dpw,
        ))
        batches.append(ClassBatch(int(s0), int(s1 - s0), dpw, int(cls[s0])))
    return small_idx, np.concatenate(descs, axis=1), batches


def work_list(descs: np.ndarray, *,
              warp_max_slots: int = dtw_cuda.WARP_MAX_SLOTS):
    """The kernel's work list for the (9, T) descriptors of a round.

    Returns (jobs, block_w, stage): ``jobs`` (J, 1 + JOB_WARPS) int32,
    one row per thread block of the launch, ``[K, t_0, .., t_7]`` for a
    block whose warp w runs tile t_w (-1: none) with K slots a lane, or
    ``[0, t, -1, ..]`` for a block that runs tile t alone; ``block_w``
    the widest band among the latter and ``stage`` the most n + m among
    the former (0 if none). A tile of W = max(lp, ls) + 2 band slots
    takes the least K of ``WARP_K`` with 32 K >= W, if 32 K <=
    ``warp_max_slots`` and its sequences fit a warp's share of shared
    memory, else a block. Tiles are ordered by n, longest first (one
    stable argsort), grouped by K in that order, and the jobs ordered by
    their first (longest) tile, so the longest wavefronts start in the
    launch's first wave."""
    T = descs.shape[1]
    width = np.maximum(descs[6], descs[7]).astype(np.int64) + 2
    seqs = descs[2].astype(np.int64) + descs[5]
    kind = np.zeros(T, np.int64)  # 0: a block
    for k in reversed(dtw_cuda.WARP_K):
        if 32 * k <= warp_max_slots:
            kind[(width <= 32 * k) & (seqs <= dtw_cuda.STAGE_MAX)] = k
    by_n = np.argsort(-descs[2].astype(np.int64), kind="stable")
    W = dtw_cuda.JOB_WARPS
    rows, lead = [], []
    for k in (0,) + dtw_cuda.WARP_K:
        sel = by_n[kind[by_n] == k]
        if not sel.size:
            continue
        if k == 0:  # one tile a block
            grid = np.full((sel.size, W), -1, np.int64)
            grid[:, 0] = sel
        else:  # W tiles a block, the last block padded with -1
            grid = np.full(-(-sel.size // W) * W, -1, np.int64)
            grid[: sel.size] = sel
            grid = grid.reshape(-1, W)
        rows.append(np.concatenate([np.full((grid.shape[0], 1), k), grid], axis=1))
        lead.append(descs[2][grid[:, 0]])
    if not rows:
        return np.zeros((0, 1 + W), np.int32), 0, 0
    jobs = np.concatenate(rows)
    jobs = jobs[np.argsort(-np.concatenate(lead).astype(np.int64), kind="stable")]
    blocks = kind == 0
    block_w = int(width[blocks].max()) if blocks.any() else 0
    stage = int(seqs[~blocks].max()) if (~blocks).any() else 0
    return jobs.astype(np.int32), block_w, stage


def run_round(ref_dev: torch.Tensor, hist_dev: torch.Tensor,
              descs: np.ndarray) -> torch.Tensor:
    """Costs of a round's (9, N) descriptors in column order: the
    descriptors and the work list in one upload, one kernel launch."""
    jobs, block_w, stage = work_list(descs)
    flat = runtime.put(np.concatenate([descs.reshape(-1), jobs.reshape(-1)]),
                       ref_dev.device)
    n9 = descs.size
    return dtw_cuda.dtw_banded_round(
        ref_dev, hist_dev, flat[:n9].view(descs.shape),
        flat[n9:].view(jobs.shape), block_w=block_w, stage=stage,
    )


def deal(n: np.ndarray, ranks: int) -> list[np.ndarray]:
    """The columns of each rank: the tiles ordered by ``n`` (their longer
    side), longest first (one stable argsort), and tile k of that order
    to rank k mod ``ranks``."""
    by_n = np.argsort(-n.astype(np.int64), kind="stable")
    return [by_n[r::ranks] for r in range(ranks)]


def run_round_sharded(mesh, ref_devs: dict, hist_dev: torch.Tensor,
                      descs: np.ndarray) -> tuple[np.ndarray, torch.Tensor]:
    """A round's (9, N) descriptors dealt over ``mesh``'s ranks
    (:func:`deal`), one :func:`run_round` launch per rank with tiles on
    its device against its copy of the reference pool (``ref_devs``: one
    per distinct device) and of ``hist_dev`` (copied once to each other
    distinct device that runs tiles). Returns (columns, costs): the
    costs, gathered onto the mesh's first device, of descriptor columns
    ``columns``, in that order."""
    first = mesh.ranks[0]
    hists = {hist_dev.device: hist_dev}
    cols, outs = [], []
    for dev, sel in zip(mesh.ranks, deal(descs[2], mesh.size)):
        if not sel.size:
            continue  # fewer tiles than ranks: this rank launches nothing
        if dev not in hists:
            hists[dev] = hist_dev.to(dev, non_blocking=True)
        costs = run_round(ref_devs[dev], hists[dev],
                          np.ascontiguousarray(descs[:, sel]))
        outs.append(costs.to(first, non_blocking=True))
        cols.append(sel)
    return np.concatenate(cols), torch.cat(outs)


@dataclasses.dataclass
class PendingDtw:
    n: int
    small_idx: np.ndarray
    small_costs: runtime.PendingFetch | None
    large_idx: np.ndarray
    large_costs: concurrent.futures.Future | None


@runtime.spanned("host.dtw_native")
def _dtw_native(pairs) -> np.ndarray:
    """The oversized tiles' costs in the native library, on a worker."""
    return native.dtw_banded_batch(pairs)


def dtw_submit_indexed(
    a_base: np.ndarray,
    a_len: np.ndarray,
    b_base: np.ndarray,
    b_len: np.ndarray,
    radius: np.ndarray,
    excl: np.ndarray,
    ref_dev: torch.Tensor,
    hist_dev: torch.Tensor,
    ref_host: np.ndarray,
    *,
    device_max_n: int,
    device_max_b: int,
    ev_fetch=None,
    mesh=None,
) -> PendingDtw:
    """Dispatch one round's tiles; collect with :func:`dtw_collect`.

    Bases index ``[ref | hist.ravel()]``, where ``hist_dev`` is the event
    history (B, hmax) or a 1-D uploaded event pool. ``ev_fetch(idx, ln)``
    returns ``ln`` of its values at flat index ``idx`` on the host (for
    the oversized tiles the native library runs). With ``mesh``, the
    small tiles are dealt over its ranks (:func:`run_round_sharded`) and
    ``ref_dev`` maps each distinct device of the mesh to its copy of the
    reference pool."""
    N = a_base.size
    small = (a_len <= device_max_n) & (b_len <= device_max_b)
    small_idx, descs, batches = class_batches(
        a_base, a_len, b_base, b_len, radius, excl, np.nonzero(small)[0],
        device_max_n=device_max_n,
    )
    small_costs = None
    if batches and mesh is None:
        small_costs = runtime.fetch_async(run_round(ref_dev, hist_dev, descs))
    elif batches:
        cols, costs = run_round_sharded(mesh, ref_dev, hist_dev, descs)
        small_idx = small_idx[cols]
        small_costs = runtime.fetch_async(costs)
    large_idx = np.nonzero(~small)[0]
    large_costs = None
    if large_idx.size:
        lref = ref_host.size

        def window(base, ln):
            if base < lref:
                return ref_host[base : base + ln]
            return ev_fetch(base - lref, ln)

        sub = [
            (window(int(a_base[i]), int(a_len[i])),
             window(int(b_base[i]), int(b_len[i])),
             int(radius[i]), bool(excl[i]))
            for i in large_idx
        ]
        # the native batch overlaps the in-flight device classes
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        large_costs = pool.submit(_dtw_native, sub)
        pool.shutdown(wait=False)
    return PendingDtw(N, small_idx, small_costs, large_idx, large_costs)


def dtw_collect(pending: PendingDtw) -> np.ndarray:
    """Wait for both halves and return costs in input order."""
    out = np.zeros(pending.n, dtype=np.float32)
    if pending.small_costs is not None:
        out[pending.small_idx] = pending.small_costs.result()
    if pending.large_costs is not None:
        out[pending.large_idx] = pending.large_costs.result()
    return out


# ---- the non-indexed dispatch ------------------------------------------


def _run_pool(pool: np.ndarray, descs: np.ndarray, dev: torch.device
              ) -> torch.Tensor:
    """Costs of the (9, T) descriptors over the flat value ``pool``: one
    :func:`run_round` launch, the pool in place of the reference pool and
    no event history."""
    return run_round(runtime.put(pool, dev),
                     torch.zeros(0, dtype=torch.float32, device=dev), descs)


def pairs_descs(pairs) -> tuple[np.ndarray, np.ndarray]:
    """(pool, (9, T) descriptors) of raw (read, reference, radius,
    exclude_last) pairs: each pair swapped so ``a`` is the longer side
    (dtw.cpp:283-292; the radius stays the read side's, rmap.cpp:276),
    the pool every a side then every b side."""
    T = len(pairs)
    a, b = [], []
    for p in pairs:
        r, f = (np.asarray(x, np.float32).ravel() for x in p[:2])
        a.append(f if f.size > r.size else r)
        b.append(r if f.size > r.size else f)
    a_len = np.fromiter((x.size for x in a), np.int64, T)
    b_len = np.fromiter((x.size for x in b), np.int64, T)
    a_base = np.cumsum(a_len) - a_len
    b_base = int(a_len.sum()) + np.cumsum(b_len) - b_len
    radius = np.fromiter((p[2] for p in pairs), np.int64, T)
    excl = np.fromiter((bool(p[3]) for p in pairs), np.int64, T)
    R = _widened_radius(a_len, b_len, radius)
    dpw = _pow2_at_least(int(R.max(initial=1)) + 3, 16)
    descs = _desc_array(a_base, a_len, b_base, b_len, radius, excl, dpw=dpw)
    return np.concatenate(a + b), descs


def dtw_submit(
    pairs: list[tuple[np.ndarray, np.ndarray, int, bool]],
    *,
    device: str | torch.device = "cuda",
    device_max_n: int = 128,
    device_max_b: int = 128,
) -> PendingDtw:
    """Dispatch raw (read, reference, radius, exclude_last) pairs;
    collect with :func:`dtw_collect`. Pairs whose longer side is at most
    ``device_max_n`` and shorter side at most ``device_max_b`` run on
    ``device`` in one launch; the rest in ``native.dtw_banded_batch`` on
    a worker thread while the launch runs."""
    dev = runtime.device(device)
    sizes = [(np.size(p[0]), np.size(p[1])) for p in pairs]
    small = np.fromiter((max(r, f) <= device_max_n and min(r, f) <= device_max_b
                         for r, f in sizes), bool, len(pairs))
    small_idx = np.nonzero(small)[0]
    large_idx = np.nonzero(~small)[0]
    small_costs = large_costs = None
    if small_idx.size:
        pool, descs = pairs_descs([pairs[i] for i in small_idx])
        small_costs = runtime.fetch_async(_run_pool(pool, descs, dev))
    if large_idx.size:
        sub = [pairs[i] for i in large_idx]
        worker = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        large_costs = worker.submit(_dtw_native, sub)
        worker.shutdown(wait=False)
    return PendingDtw(len(pairs), small_idx, small_costs, large_idx, large_costs)


def dtw_banded_pairs(
    pairs: list[tuple[np.ndarray, np.ndarray, int, bool]], **kw
) -> np.ndarray:
    """(T,) float32 costs of raw pairs, in input order: :func:`dtw_submit`
    and :func:`dtw_collect`."""
    if not pairs:
        return np.zeros(0, dtype=np.float32)
    return dtw_collect(dtw_submit(pairs, **kw))


@dataclasses.dataclass
class TileBatch:
    a2: np.ndarray  # (T, max_n + dpw) pre-shifted longer sequences
    b2: np.ndarray  # (T, LB2) pre-shifted shorter sequences
    a_len: np.ndarray
    b_len: np.ndarray
    radius: np.ndarray
    exclude_last: np.ndarray
    a_last: np.ndarray
    b_last: np.ndarray
    d00: np.ndarray
    dpw: int
    max_n: int

    @property
    def n_tiles(self) -> int:
        return self.a2.shape[0]


def prepare_tiles(
    pairs: list[tuple[np.ndarray, np.ndarray, int, bool]],
    *,
    lane_align: int = 8,
) -> TileBatch:
    """pairs: (read_region, ref_region, band_radius, exclude_last).

    Swaps each pair so a is the longer sequence; the band radius is
    computed by the caller from the READ region length before swapping
    (rmap.cpp:276).
    """
    T = len(pairs)
    sizes_r = np.fromiter((p[0].size for p in pairs), np.int64, T)
    sizes_f = np.fromiter((p[1].size for p in pairs), np.int64, T)
    swap = sizes_f > sizes_r
    a_len = np.where(swap, sizes_f, sizes_r).astype(np.int32)
    b_len = np.where(swap, sizes_r, sizes_f).astype(np.int32)
    radius = np.fromiter((p[2] for p in pairs), np.int32, T)
    excl = np.fromiter((p[3] for p in pairs), bool, T)

    n64 = np.maximum(a_len.astype(np.int64), 1)
    m64 = b_len.astype(np.int64)
    r64 = radius.astype(np.int64)
    R = r64 + ((n64 - m64) * r64 + n64 - 1) // n64
    lp = R + np.where(R % 2 == 0, 1, 0)
    half_lp = (lp // 2).astype(np.int64)

    # panel widths in powers of two, as the JAX package sizes them (its
    # compiled shapes); the values sit where its kernel reads them
    dpw = _pow2_at_least(int(R.max(initial=1)) + 3, 16)
    max_n = _pow2_at_least(int(a_len.max(initial=1)), 32)
    lb2 = _pow2_at_least(int((m64 + half_lp + 1 + dpw).max(initial=1)), 32)

    # flat value pools + one vectorized scatter per panel (a Python loop
    # over tens of thousands of tiny tiles dominated mapping wall time)
    a_flat = (
        np.concatenate(
            [np.asarray(p[1] if sw else p[0], np.float32) for p, sw in zip(pairs, swap)]
        )
        if T
        else np.zeros(0, np.float32)
    )
    b_flat = (
        np.concatenate(
            [np.asarray(p[0] if sw else p[1], np.float32) for p, sw in zip(pairs, swap)]
        )
        if T
        else np.zeros(0, np.float32)
    )
    al64 = a_len.astype(np.int64)
    bl64 = b_len.astype(np.int64)
    a_starts = np.concatenate([[0], np.cumsum(al64)[:-1]])
    b_starts = np.concatenate([[0], np.cumsum(bl64)[:-1]])
    rows_a = np.repeat(np.arange(T, dtype=np.int64), al64)
    intra_a = np.arange(a_flat.size, dtype=np.int64) - np.repeat(a_starts, al64)
    rows_b = np.repeat(np.arange(T, dtype=np.int64), bl64)
    intra_b = np.arange(b_flat.size, dtype=np.int64) - np.repeat(b_starts, bl64)

    a2 = np.zeros((T, max_n + dpw), dtype=np.float32)
    b2 = np.zeros((T, lb2), dtype=np.float32)
    # A2[t, x] = a[t, x - (dpw-1) + half_lp[t]]; offsets always in-range
    # by construction (dpw >= R+3 > half_lp; widths sized to fit)
    off_a = (dpw - 1) - half_lp
    a2[rows_a, np.repeat(off_a, al64) + intra_a] = a_flat
    # B2[t, x] = b[t, x - half_lp[t] - 1]
    b2[rows_b, np.repeat(half_lp + 1, bl64) + intra_b] = b_flat

    a_last = np.zeros(T, dtype=np.float32)
    b_last = np.zeros(T, dtype=np.float32)
    d00 = np.zeros(T, dtype=np.float32)
    ok = (al64 > 0) & (bl64 > 0)
    if T and a_flat.size and b_flat.size:
        a_first = np.where(ok, a_flat[np.minimum(a_starts, a_flat.size - 1)], 0)
        b_first = np.where(ok, b_flat[np.minimum(b_starts, b_flat.size - 1)], 0)
        a_last = np.where(
            ok, a_flat[np.minimum(a_starts + al64 - 1, a_flat.size - 1)], 0
        ).astype(np.float32)
        b_last = np.where(
            ok, b_flat[np.minimum(b_starts + bl64 - 1, b_flat.size - 1)], 0
        ).astype(np.float32)
        d00 = np.abs(a_first - b_first).astype(np.float32)
        d00[~ok] = 0.0
    return TileBatch(
        a2=a2,
        b2=b2,
        a_len=a_len,
        b_len=b_len,
        radius=radius,
        exclude_last=excl,
        a_last=a_last,
        b_last=b_last,
        d00=d00,
        dpw=dpw,
        max_n=max_n,
    )


def dtw_banded(batch: TileBatch, *, device: str | torch.device = "cuda"
               ) -> np.ndarray:
    """(T,) float32 costs of a :class:`TileBatch`, in one launch: each
    tile read by descriptor from the batch's own panels, pooled as
    ``[a2 | b2]`` (a2's row t holds a from column (dpw - 1) - half_lp[t],
    b2's from half_lp[t] + 1)."""
    dev = runtime.device(device)
    T = batch.n_tiles
    if T == 0:
        return np.zeros(0, dtype=np.float32)
    a_len = batch.a_len.astype(np.int64)
    b_len = batch.b_len.astype(np.int64)
    R = _widened_radius(a_len, b_len, batch.radius)
    half_lp = (R + np.where(R % 2 == 0, 1, 0)) // 2
    t = np.arange(T, dtype=np.int64)
    a_base = t * batch.a2.shape[1] + (batch.dpw - 1) - half_lp
    b_base = batch.a2.size + t * batch.b2.shape[1] + half_lp + 1
    descs = _desc_array(a_base, a_len, b_base, b_len, batch.radius,
                        batch.exclude_last, dpw=batch.dpw)
    pool = np.concatenate([batch.a2.reshape(-1), batch.b2.reshape(-1)])
    return runtime.fetch(_run_pool(pool, descs, dev))
