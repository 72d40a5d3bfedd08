"""Copy of rawalign_tpu/map/postprocess.py for the port.

Host-side chain post-processing for the batched engine.

The device chaining DP returns per-anchor scores and predecessors; this
module performs the cheap, pointer-chasing parts the reference also does
serially: end-candidate selection (rmap.cpp:486-505), traceback
(rmap.cpp:130-173), and the DTW branch-and-bound replay that reproduces
align_chain's early-abandon bookkeeping (rmap.cpp:181-313) from
batch-precomputed part costs.
"""

from __future__ import annotations

import numpy as np

from rawalign_tpu_torch.config import (
    BorderConstraint,
    FillMethod,
    MappingFlag,
    MappingOptions,
)
from rawalign_tpu_torch.golden.chain import Chain


def chains_from_dp(
    seg: np.ndarray,
    target: np.ndarray,
    query: np.ndarray,
    scores: np.ndarray,
    preds: np.ndarray,
    n: int,
    opt: MappingOptions,
) -> list[Chain]:
    """Candidate selection + traceback from device DP results.

    Arrays are the read's sorted anchors (segment-major); ``seg`` encodes
    target*2+strand so ascending segment order matches the reference's
    (target, strand) loop nest (rmap.cpp:430-431).
    """
    chains: list[Chain] = []
    if n == 0:
        return chains
    scores = scores[:n]
    preds = preds[:n]
    seg = seg[:n]
    target = target[:n]
    query = query[:n]
    running = np.maximum.accumulate(scores)
    disable = bool(opt.flag & MappingFlag.DISABLE_CHAININGSCORE_FILTERING)
    if disable:
        cand_mask = np.ones(n, dtype=bool)
    else:
        cand_mask = (scores >= opt.min_chaining_score) & (
            scores > running / 2
        )
    used = np.zeros(n, dtype=bool)
    # segment boundaries
    boundaries = np.nonzero(np.diff(seg))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    for s0, s1 in zip(starts, ends):
        idxs = np.nonzero(cand_mask[s0:s1])[0] + s0
        if idxs.size == 0:
            continue
        # sort by (score desc, index desc) (rmap.cpp:175-179,496)
        order = sorted(idxs, key=lambda i: (scores[i], i), reverse=True)
        seg_max = running[s1 - 1]  # max over all anchors up to this segment
        for rank, end_idx in enumerate(order):
            if rank >= opt.num_best_chains:
                break
            _traceback_one(
                end_idx, seg, target, query, scores, preds, used, opt, chains
            )
            if not disable and scores[end_idx] < seg_max / 2:
                break
    return chains


def _traceback_one(
    end_idx, seg, target, query, scores, preds, used, opt, chains
) -> None:
    if used[end_idx]:
        return
    anchor_list = [(int(target[end_idx]), int(query[end_idx]))]
    stop_at_used = False
    start = end_idx
    if preds[start] != start and used[preds[start]]:
        stop_at_used = True
    used[start] = True
    while preds[start] != start and not used[preds[start]]:
        start = preds[start]
        anchor_list.append((int(target[start]), int(query[start])))
        if preds[start] != start and used[preds[start]]:
            stop_at_used = True
        used[start] = True
    if len(anchor_list) >= opt.min_num_anchors:
        score = float(scores[end_idx])
        if stop_at_used:
            score -= float(scores[preds[start]])
        s = int(seg[end_idx])
        chains.append(
            Chain(
                chaining_score=score,
                alignment_score=0.0,
                reference_sequence_index=s >> 1,
                start_position=int(target[start]),
                end_position=int(target[end_idx]),
                n_anchors=len(anchor_list),
                mapq=0,
                strand=s & 1,
                anchors=np.asarray(anchor_list, dtype=np.uint32),
            )
        )


def chains_from_dp_fast(
    seg: np.ndarray,
    target: np.ndarray,
    query: np.ndarray,
    scores: np.ndarray,
    preds: np.ndarray,
    n: int,
    opt: MappingOptions,
) -> list[Chain]:
    """``chains_from_dp`` with the candidate selection + traceback in C
    (native.chains_from_dp_raw) and vectorized Chain assembly. Identical
    chain set, order, scores and anchors (tests/test_native.py pins
    equality); the Python version remains the readable reference."""
    from rawalign_tpu_torch import native

    if n == 0:
        return []
    aidx, off, eidx, sc = native.chains_from_dp_raw(
        seg, target, query, scores, preds, n,
        min_chaining_score=opt.min_chaining_score,
        num_best_chains=opt.num_best_chains,
        min_num_anchors=opt.min_num_anchors,
        disable_filter=bool(
            opt.flag & MappingFlag.DISABLE_CHAININGSCORE_FILTERING
        ),
    )
    chains: list[Chain] = []
    tgt_u = target.astype(np.uint32, copy=False)
    qry_u = query.astype(np.uint32, copy=False)
    for k in range(eidx.size):
        idxs = aidx[off[k] : off[k + 1]]
        e = int(eidx[k])
        s = int(seg[e])
        anchors = np.column_stack((tgt_u[idxs], qry_u[idxs]))
        chains.append(
            Chain(
                chaining_score=float(sc[k]),
                alignment_score=0.0,
                reference_sequence_index=s >> 1,
                start_position=int(target[idxs[-1]]),
                end_position=int(target[e]),
                n_anchors=idxs.size,
                mapq=0,
                strand=s & 1,
                anchors=anchors,
            )
        )
    return chains


def build_chain_tiles(
    chain: Chain, ref_events: np.ndarray, read_events: np.ndarray,
    opt: MappingOptions,
):
    """DTW tiles for one chain: list of (read_region, ref_region, radius,
    exclude_last) per align_chain (rmap.cpp:192-300)."""
    tiles = []
    if opt.dtw_border_constraint == BorderConstraint.GLOBAL:
        sa = chain.anchors[chain.n_anchors - 1]
        ea = chain.anchors[0]
        t0, q0, t1, q1 = int(sa[0]), int(sa[1]), int(ea[0]), int(ea[1])
        read_r = read_events[q0 : q1 + 1]
        ref_r = ref_events[t0 : t1 + 1]
        radius = _radius(read_r.size, opt)
        tiles.append((read_r, ref_r, radius, False))
    elif opt.dtw_border_constraint == BorderConstraint.SPARSE:
        parts = chain.n_anchors - 1
        for part in range(parts):
            sa = chain.anchors[parts - part]
            ea = chain.anchors[parts - part - 1]
            t0, q0, t1, q1 = int(sa[0]), int(sa[1]), int(ea[0]), int(ea[1])
            read_r = read_events[q0 : q1 + 1]
            ref_r = ref_events[t0 : t1 + 1]
            radius = _radius(read_r.size, opt)
            tiles.append((read_r, ref_r, radius, part != parts - 1))
    else:
        raise ValueError("invalid border constraint")
    return tiles


def build_chain_tile_descs(
    chain: Chain, ref_base: int, ev_base: int, opt: MappingOptions
) -> list[tuple[int, int, int, int, int, int]]:
    """Descriptor form of build_chain_tiles for the indexed device
    dispatch: per tile (a_base, a_len, b_base, b_len, radius, excl) with
    the a side already the LONGER sequence (dtw.cpp:283-292) and bases
    absolute indices into the combined [ref_cat | ev_cat] value pool.
    The band radius comes from the READ region length before swapping
    (rmap.cpp:276)."""
    rows = []

    def add(t0, q0, t1, q1, excl):
        ql = q1 - q0 + 1
        tl = t1 - t0 + 1
        radius = _radius(ql, opt)
        if tl > ql:
            rows.append(
                (ref_base + t0, tl, ev_base + q0, ql, radius, int(excl))
            )
        else:
            rows.append(
                (ev_base + q0, ql, ref_base + t0, tl, radius, int(excl))
            )

    if opt.dtw_border_constraint == BorderConstraint.GLOBAL:
        sa = chain.anchors[chain.n_anchors - 1]
        ea = chain.anchors[0]
        add(int(sa[0]), int(sa[1]), int(ea[0]), int(ea[1]), 0)
    elif opt.dtw_border_constraint == BorderConstraint.SPARSE:
        parts = chain.n_anchors - 1
        for part in range(parts):
            sa = chain.anchors[parts - part]
            ea = chain.anchors[parts - part - 1]
            add(
                int(sa[0]),
                int(sa[1]),
                int(ea[0]),
                int(ea[1]),
                part != parts - 1,
            )
    else:
        raise ValueError("invalid border constraint")
    return rows


def build_chain_tile_descs_vec(
    chain: Chain, ref_base: int, ev_base: int, opt: MappingOptions
) -> np.ndarray:
    """Vectorized ``build_chain_tile_descs``: one (parts, 6) int64 array
    per chain instead of a Python loop over anchor pairs (chains carry
    up to hundreds of anchors; this is the engine's per-round host hot
    loop). Row-identical to the scalar version (pinned in
    tests/test_native.py)."""
    a = chain.anchors.astype(np.int64)
    if opt.dtw_border_constraint == BorderConstraint.GLOBAL:
        return np.asarray(
            build_chain_tile_descs(chain, ref_base, ev_base, opt),
            dtype=np.int64,
        ).reshape(-1, 6)
    if opt.dtw_border_constraint != BorderConstraint.SPARSE:
        raise ValueError("invalid border constraint")
    parts = chain.n_anchors - 1
    if parts <= 0:
        return np.zeros((0, 6), dtype=np.int64)
    # part p: sa = anchors[parts - p], ea = anchors[parts - p - 1]
    sa = a[1:][::-1]
    ea = a[:-1][::-1]
    t0, q0 = sa[:, 0], sa[:, 1]
    t1, q1 = ea[:, 0], ea[:, 1]
    ql = q1 - q0 + 1
    tl = t1 - t0 + 1
    if opt.dtw_fill_method == FillMethod.FULL:
        radius = np.maximum(1, ql)
    else:
        radius = np.maximum(
            1, (ql * opt.dtw_band_radius_frac).astype(np.int64)
        )
    excl = np.ones(parts, dtype=np.int64)
    excl[-1] = 0  # the last part keeps its final element (rmap.cpp:298)
    swap = tl > ql
    rows = np.empty((parts, 6), dtype=np.int64)
    rows[:, 0] = np.where(swap, ref_base + t0, ev_base + q0)
    rows[:, 1] = np.where(swap, tl, ql)
    rows[:, 2] = np.where(swap, ev_base + q0, ref_base + t0)
    rows[:, 3] = np.where(swap, ql, tl)
    rows[:, 4] = radius
    rows[:, 5] = excl
    return rows


def _radius(read_size: int, opt: MappingOptions) -> int:
    if opt.dtw_fill_method == FillMethod.FULL:
        # cover the whole matrix: the slanted band with radius >= |b|
        # degenerates to the full DP, reproducing DTW_global
        return max(1, read_size)
    return max(1, int(read_size * opt.dtw_band_radius_frac))


def bnb_replay(
    chains: list[Chain],
    part_costs: list[np.ndarray],
    opt: MappingOptions,
) -> list[Chain]:
    """Replay align_chain's branch-and-bound over precomputed part costs
    (rmap.cpp:243-280,509-530). chains must be sorted by chaining score
    descending (the caller's responsibility, rmap.cpp:512). Sets
    alignment_score on every chain and returns the surviving list."""
    post: list[Chain] = []
    best_found = 0.0
    for chain, costs in zip(chains, part_costs):
        sa = chain.anchors[chain.n_anchors - 1]
        ea = chain.anchors[0]
        read_size = int(ea[1]) - int(sa[1]) + 1
        current_max = np.float32(read_size) * np.float32(opt.dtw_match_bonus)
        abandoned = False
        dtw_cost = np.float32(0.0)
        num_aligned = 0
        if opt.dtw_border_constraint == BorderConstraint.GLOBAL:
            if current_max < best_found:
                abandoned = True
            else:
                dtw_cost = np.float32(costs[0])
                num_aligned = read_size
        else:
            # vectorized replay of the scalar per-part loop, bit-identical:
            # ufunc.accumulate applies float32 ops in the same sequential
            # order as `current_max -= sub` / `dtw_cost += sub`, and the
            # per-part num_aligned deltas telescope (anchors are uints)
            parts = chain.n_anchors - 1
            subs = np.asarray(costs, dtype=np.float32)[:parts]
            if parts:
                cm = np.subtract.accumulate(
                    np.concatenate([np.float32([current_max]), subs])
                )
                # the scalar loop checks before each part, so with fewer
                # costs than parts the check after the last available
                # subtraction still runs before the out-of-range index
                if np.any(cm[: min(parts, subs.size + 1)] < best_found):
                    abandoned = True
                elif subs.size < parts:
                    raise IndexError(
                        f"{subs.size} part costs for {parts} chain parts"
                    )
                else:
                    dtw_cost = np.add.accumulate(subs)[-1]
                    num_aligned = read_size - 1 + parts
        if abandoned:
            chain.alignment_score = -1e10
            continue
        chain.alignment_score = float(
            np.float32(num_aligned) * np.float32(opt.dtw_match_bonus) - dtw_cost
        )
        if opt.flag & MappingFlag.DTW_LOG_SCORES:
            import sys

            # rmap.cpp:308-312 (only for chains not early-abandoned)
            print(
                f"chaining_score={chain.chaining_score:f} "
                f"alignment_score={chain.alignment_score:f}",
                file=sys.stderr,
            )
        if chain.alignment_score >= opt.dtw_min_score:
            if chain.alignment_score > best_found:
                best_found = chain.alignment_score
            post.append(chain)
    return post
