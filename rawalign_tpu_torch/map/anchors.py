"""Copy of rawalign_tpu/map/anchors.py for the port, with
:func:`expand_block`, the expansion of a block of a round's rows.

Batched host-side anchor expansion + sort for the mapping engine.

The engine downloads per-seed (lo, count, qpos) bounds from stage1 and
expands them into anchors against the host copy of the index value
table (the real hit lists are tiny — hundreds per read — so this stays
on the host; see the division-of-labor note in map/engine.py). This
module is the batched replacement of the engine's original per-read
loop: ONE np.repeat/gather/lexsort pass over the whole round instead of
~10 small numpy calls per read (per-call overhead dominated at typical
batch sizes).

Ordering contract (must match the per-read loop bit-for-bit, since the
anchor order feeds the chaining DP and its stable tie-breaks):
  * within a read: hit anchors in seed order (then hit order within a
    seed), followed by carried anchors in their given order
    (rmap.cpp:343-362 re-injection);
  * the final order is np.lexsort((qpos, tpos, seg)) per read — stable,
    so ties keep the order above;
  * over-budget reads keep the ``A`` anchors whose parent seeds have
    the smallest occurrence count (stable in sorted position): the
    occ-ranked adaptive drop documented in map/engine.py.
"""

from __future__ import annotations

import numpy as np


def expand_round(
    h_lo, h_qpos, h_count, live, offsets, carried_lists,
    val_id, val_ps, A, seg_b, tgt_b, qry_b, n_anch,
) -> tuple[int, int, int]:
    """Dispatch: native C when built (one pass, no temp churn — the
    2-vCPU host's lexsort made this the biggest host phase), else the
    vectorized numpy twin below. tests/test_anchors.py pins the two
    bit-identical."""
    from rawalign_tpu_torch import native

    if native.expand_round_available():
        return native.expand_round(
            h_lo, h_qpos, h_count, live, offsets, carried_lists,
            val_id, val_ps, A, seg_b, tgt_b, qry_b, n_anch,
        )
    return expand_round_numpy(
        h_lo, h_qpos, h_count, live, offsets, carried_lists,
        val_id, val_ps, A, seg_b, tgt_b, qry_b, n_anch,
    )


#: the segment of an empty anchor slot: beyond every real segment, so the
#: chain DP never links it
SENTINEL_SEG = 0x7FFFFFFF


def expand_block(
    lo, hi, h_lo, h_qpos, h_count, live, offsets, carried_lists,
    val_id, val_ps, A, seg_b, tgt_b, qry_b, n_anch,
) -> tuple[int, int, int]:
    """:func:`expand_round` on rows ``lo .. hi`` of a round, arguments
    as there (``carried_lists`` keyed by the round's rows), in place in
    those rows of the (B, A) outputs, which it first fills with the
    sentinel segment and zeros. A row's anchors depend on that row's
    inputs alone, so disjoint blocks may run on several threads; the
    round's (max_used, max_true, dropped) are the blocks' max, max and
    sum."""
    r = slice(lo, hi)
    seg_b[r] = SENTINEL_SEG
    tgt_b[r] = 0
    qry_b[r] = 0
    return expand_round(
        h_lo[r], h_qpos[r], h_count[r], live[r], offsets[r],
        {i - lo: c for i, c in carried_lists.items() if lo <= i < hi},
        val_id, val_ps, A, seg_b[r], tgt_b[r], qry_b[r], n_anch[r],
    )


def expand_round_numpy(
    h_lo: np.ndarray,  # (B, NS) int32 global lo bounds
    h_qpos: np.ndarray,  # (B, NS) int32 seed query positions
    h_count: np.ndarray,  # (B, NS) int32 per-seed hit counts (occ-capped)
    live: np.ndarray,  # (B,) bool — rows to expand
    offsets: np.ndarray,  # (B,) int64 per-read event offset
    carried_lists: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]],
    val_id: np.ndarray,  # index value table (host)
    val_ps: np.ndarray,
    A: int,  # anchor budget
    seg_b: np.ndarray,  # (B, A) int32 out, pre-filled with the sentinel
    tgt_b: np.ndarray,  # (B, A) int32 out (zeros)
    qry_b: np.ndarray,  # (B, A) int32 out (zeros)
    n_anch: np.ndarray,  # (B,) int32 out (zeros)
) -> tuple[int, int, int]:
    """Expand + merge + sort + budget-cap every live row of one round.

    Returns (max_used, max_true, anchors_dropped).
    """
    B, NS = h_count.shape
    rows_live = np.nonzero(live)[0]
    if rows_live.size == 0:
        return 0, 0, 0

    cnt = h_count[rows_live]
    sel_r, sel_s = np.nonzero(cnt)  # row-major: grouped by read
    reps = cnt[sel_r, sel_s].astype(np.int64)
    total_hits = int(reps.sum())
    if total_hits:
        starts = h_lo[rows_live][sel_r, sel_s].astype(np.int64)
        base = np.repeat(starts, reps)
        offs = np.arange(total_hits, dtype=np.int64) - np.repeat(
            np.cumsum(reps) - reps, reps
        )
        hidx = base + offs
        tid = val_id[hidx].astype(np.int64)
        ps = val_ps[hidx]
        tpos_h = ((ps >> np.uint32(1)) & np.uint32(0x7FFFFFFF)).astype(
            np.int64
        )
        seg_h = tid * 2 + (ps & np.uint32(1)).astype(np.int64)
        row_h = np.repeat(rows_live[sel_r], reps)
        qpos_h = (
            np.repeat(h_qpos[rows_live][sel_r, sel_s].astype(np.int64), reps)
            + offsets[row_h]
        )
        occ_h = np.repeat(reps, reps)
    else:
        seg_h = tpos_h = qpos_h = occ_h = np.zeros(0, np.int64)
        row_h = np.zeros(0, np.int64)

    if carried_lists:
        rs, ss, ts, qs = [], [], [], []
        for i in sorted(carried_lists):
            if not live[i]:
                continue
            cs, ct, cq = carried_lists[i]
            rs.append(np.full(cs.size, i, np.int64))
            ss.append(cs)
            ts.append(ct)
            qs.append(cq)
        if rs:
            row_c = np.concatenate(rs)
            seg_c = np.concatenate(ss)
            tpos_c = np.concatenate(ts)
            qpos_c = np.concatenate(qs)
            row = np.concatenate([row_h, row_c])
            seg = np.concatenate([seg_h, seg_c])
            tpos = np.concatenate([tpos_h, tpos_c])
            qpos = np.concatenate([qpos_h, qpos_c])
            # carried anchors rank occ 0: always kept under pressure
            occ = np.concatenate([occ_h, np.zeros(row_c.size, np.int64)])
        else:
            row, seg, tpos, qpos, occ = row_h, seg_h, tpos_h, qpos_h, occ_h
    else:
        row, seg, tpos, qpos, occ = row_h, seg_h, tpos_h, qpos_h, occ_h

    if row.size == 0:
        return 0, 0, 0

    # one stable sort for the whole round; within a row, ties keep the
    # hits-then-carried input order (all hit anchors precede all carried
    # anchors in the concatenation, and both are row-grouped)
    order = np.lexsort((qpos, tpos, seg, row))
    row = row[order]
    seg = seg[order]
    tpos = tpos[order]
    qpos = qpos[order]
    occ = occ[order]

    # row boundaries in the sorted (row-major) layout
    bounds = np.searchsorted(row, np.arange(B + 1, dtype=np.int64))
    totals = np.diff(bounds)
    max_true = int(totals.max()) if totals.size else 0
    dropped = 0
    if max_true > A:
        # per-row occ-ranked drop, only for the (rare) over-budget rows
        keep = np.ones(row.size, dtype=bool)
        for i in np.nonzero(totals > A)[0]:
            s0, s1 = bounds[i], bounds[i + 1]
            m = s1 - s0
            dropped += int(m - A)
            keep_rank = np.argsort(occ[s0:s1], kind="stable")[:A]
            keep_rank.sort()
            mask = np.zeros(m, dtype=bool)
            mask[keep_rank] = True
            keep[s0:s1] = mask
        row = row[keep]
        seg = seg[keep]
        tpos = tpos[keep]
        qpos = qpos[keep]
        bounds = np.searchsorted(row, np.arange(B + 1, dtype=np.int64))
        totals = np.diff(bounds)

    col = np.arange(row.size, dtype=np.int64) - bounds[row]
    seg_b[row, col] = seg
    tgt_b[row, col] = tpos
    qry_b[row, col] = qpos
    n_anch[:] = totals.astype(np.int32)
    max_used = int(totals.max()) if totals.size else 0
    return max_used, max_true, dropped
