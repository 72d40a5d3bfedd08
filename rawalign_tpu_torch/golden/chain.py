"""Copy of rawalign_tpu/golden/chain.py for the port.

Chaining + chain evaluation golden model (reference: src/rmap.cpp).

Covers: anchor collection from seed hits, the chaining DP with skip
counter and gap gates (rmap.cpp:427-507), chain traceback
(rmap.cpp:130-173), DTW chain evaluation with branch-and-bound early
abandon (align_chain, rmap.cpp:181-313), primary-chain selection
(rmap.cpp:90-128) and MAPQ (rmap.cpp:65-88).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np

from rawalign_tpu_torch.config import (
    BorderConstraint,
    FillMethod,
    MappingFlag,
    MappingOptions,
)
from rawalign_tpu_torch.golden import dtw as gdtw
from rawalign_tpu_torch.golden import sketch as gsketch


@dataclasses.dataclass
class Chain:
    chaining_score: float
    alignment_score: float
    reference_sequence_index: int
    start_position: int
    end_position: int
    n_anchors: int
    mapq: int
    strand: int
    # anchors[i] = (target_position, query_position); ordered end->start as
    # produced by the right-to-left traceback (rmap.cpp:130-173).
    anchors: np.ndarray
    dtw: Optional[gdtw.DtwResult] = None

    def sort_key_desc(self):
        """Key tuple for std::greater ordering (rmap.h:41-45)."""
        return (
            self.alignment_score,
            self.chaining_score,
            self.n_anchors,
            self.strand,
            self.reference_sequence_index,
            self.start_position,
            self.end_position,
        )


def collect_anchors(
    index,
    chunk_events: np.ndarray,
    chunk_start: int,
    previous_chains: list[Chain],
    opt: MappingOptions,
) -> tuple[dict[tuple[int, int], list[tuple[int, int]]], int]:
    """Seed the chunk events and gather anchors per (strand, target)
    (rmap.cpp:343-401). Anchors from chains surviving previous chunks are
    re-injected first, then sorted together with the new ones. Returns
    (anchors, chunk_seed_hits) — the hit count feeds --log-num-anchors
    (rmap.cpp:371,381)."""
    io = index.opt
    anchors: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for ch in previous_chains:
        key = (ch.strand, ch.reference_sequence_index)
        anchors.setdefault(key, []).extend(
            (int(t), int(q)) for t, q in ch.anchors
        )
    seeds = gsketch.sketch(
        chunk_events, 0, 0, io.w, io.e, io.n, io.q, io.lq, io.k
    )
    mask31 = (1 << 31) - 1
    chunk_seed_hits = 0
    for x, y in seeds:
        hashval = int(x) >> gsketch.RI_HASH_SHIFT
        pi = (int(y) & 0xFFFFFFFF) >> gsketch.RI_POS_SHIFT
        hits = index.get(hashval)
        chunk_seed_hits += len(hits)
        for keyval in hits:
            keyval = int(keyval)
            t_ind = keyval >> gsketch.RI_ID_SHIFT
            target_pos = ((keyval >> gsketch.RI_POS_SHIFT) & 0xFFFFFFFF) & mask31
            strand = keyval & 1
            anchors.setdefault((strand, t_ind), []).append(
                (target_pos, pi + chunk_start)
            )
    for key in anchors:
        anchors[key].sort()  # (target_position, query_position), rmap.h:24-26
    return anchors, chunk_seed_hits


def chain_anchors(
    anchors: list[tuple[int, int]],
    strand: int,
    t_ind: int,
    e: int,
    opt: MappingOptions,
    max_chaining_score: float,
    chains: list[Chain],
) -> float:
    """Chaining DP + traceback for one (strand, target) anchor list
    (rmap.cpp:427-507). Appends chains; returns updated global max score.

    The running ``max_chaining_score`` is shared across all (strand,
    target) pairs of one gen_chains call, as in the reference.
    """
    n = len(anchors)
    if n == 0:
        return max_chaining_score
    scores = np.zeros(n, dtype=np.float32)
    preds = np.arange(n, dtype=np.int64)
    end_candidates: list[tuple[float, int]] = []
    band = opt.chaining_band_length
    for ai in range(n):
        scores[ai] = np.float32(e)  # distance_coefficient * e (rmap.cpp:441-442)
        ct, cq = anchors[ai]
        start = ai - band if ai > band else 0
        num_skips = 0
        for pj in range(ai - 1, start - 1, -1):
            pt, pq = anchors[pj]
            if pq == cq or pt == ct:
                continue
            if pt + opt.max_target_gap_length < ct:
                break
            tdiff = ct - pt
            qdiff = cq - pq
            if qdiff < 0:
                continue
            current = np.float32(0.0)
            matching = np.float32(min(min(tdiff, qdiff), e))
            gap_length = abs(tdiff - qdiff)
            gap_scale = (
                np.float32(qdiff) / np.float32(tdiff) if tdiff > 0 else np.float32(1.0)
            )
            if gap_length < opt.max_gap_length and 0.75 < gap_scale < 5:
                current = scores[pj] + matching
            if current > scores[ai]:
                scores[ai] = current
                preds[ai] = pj
                num_skips -= 1
            else:
                num_skips += 1
                if num_skips > opt.max_num_skips:
                    break
        if scores[ai] > max_chaining_score:
            max_chaining_score = float(scores[ai])
        if (opt.flag & MappingFlag.DISABLE_CHAININGSCORE_FILTERING) or (
            scores[ai] >= opt.min_chaining_score
            and scores[ai] > max_chaining_score / 2
        ):
            end_candidates.append((float(scores[ai]), ai))

    # sort by (score desc, index desc) (rmap.cpp:175-179,496)
    end_candidates.sort(key=lambda p: (p[0], p[1]), reverse=True)
    used = np.zeros(n, dtype=bool)
    for rank, (_, end_idx) in enumerate(end_candidates):
        if rank >= opt.num_best_chains:
            break
        _traceback(
            anchors, strand, t_ind, end_idx, scores, preds, used, opt, chains
        )
        if not (opt.flag & MappingFlag.DISABLE_CHAININGSCORE_FILTERING):
            if scores[end_idx] < max_chaining_score / 2:
                break
    return max_chaining_score


def _traceback(
    anchors,
    strand,
    t_ind,
    end_idx,
    scores,
    preds,
    used,
    opt: MappingOptions,
    chains: list[Chain],
) -> None:
    """traceback_chains (rmap.cpp:130-173)."""
    if used[end_idx]:
        return
    chain_anchor_list = [anchors[end_idx]]
    stop_at_used = False
    start = end_idx
    if preds[start] != start and used[preds[start]]:
        stop_at_used = True
    used[start] = True
    while preds[start] != start and not used[preds[start]]:
        start = preds[start]
        chain_anchor_list.append(anchors[start])
        if preds[start] != start and used[preds[start]]:
            stop_at_used = True
        used[start] = True
    if len(chain_anchor_list) >= opt.min_num_anchors:
        score = float(scores[end_idx])
        if stop_at_used:
            score -= float(scores[preds[start]])
        chains.append(
            Chain(
                chaining_score=score,
                alignment_score=0.0,
                reference_sequence_index=t_ind,
                start_position=anchors[start][0],
                end_position=anchors[end_idx][0],
                n_anchors=len(chain_anchor_list),
                mapq=0,
                strand=strand,
                anchors=np.asarray(chain_anchor_list, dtype=np.uint32),
            )
        )


def align_chain(
    chain: Chain,
    index,
    read_events: np.ndarray,
    opt: MappingOptions,
    cigar: bool = False,
    min_score: float = -1e10,
) -> None:
    """DTW evaluation of one chain (align_chain, rmap.cpp:181-313)."""
    ref_events = index.signals[chain.strand][chain.reference_sequence_index]
    dtw_cost = np.float32(0.0)
    num_aligned = 0
    if opt.dtw_border_constraint == BorderConstraint.GLOBAL:
        start_anchor = chain.anchors[chain.n_anchors - 1]
        end_anchor = chain.anchors[0]
        t0, q0 = int(start_anchor[0]), int(start_anchor[1])
        t1, q1 = int(end_anchor[0]), int(end_anchor[1])
        ref_region = ref_events[t0 : t1 + 1]
        read_region = read_events[q0 : q1 + 1]
        read_size = q1 - q0 + 1
        if not cigar:
            max_attainable = np.float32(read_size) * np.float32(opt.dtw_match_bonus)
            if max_attainable < min_score:
                chain.alignment_score = -1e10
                return
            if opt.dtw_fill_method == FillMethod.FULL:
                dtw_cost = np.float32(gdtw.dtw_global(read_region, ref_region))
            else:
                band = max(1, int(read_size * opt.dtw_band_radius_frac))
                dtw_cost = np.float32(
                    gdtw.dtw_global_slantedbanded_antidiagonalwise(
                        read_region, ref_region, band
                    )
                )
        else:
            res = gdtw.dtw_global_tb(read_region, ref_region)
            dtw_cost = np.float32(res.cost)
            for el in res.alignment:
                el.i += q0
                el.j += t0
            chain.dtw = res
        num_aligned = read_size
    elif opt.dtw_border_constraint == BorderConstraint.SPARSE:
        parts = chain.n_anchors - 1
        alignment: list[gdtw.AlignmentElement] = []
        cs = chain.anchors[chain.n_anchors - 1]
        ce = chain.anchors[0]
        chain_read_size = int(ce[1]) - int(cs[1]) + 1
        current_max = np.float32(chain_read_size) * np.float32(opt.dtw_match_bonus)
        for part in range(parts):
            start_anchor = chain.anchors[parts - part]
            end_anchor = chain.anchors[parts - part - 1]
            t0, q0 = int(start_anchor[0]), int(start_anchor[1])
            t1, q1 = int(end_anchor[0]), int(end_anchor[1])
            ref_region = ref_events[t0 : t1 + 1]
            read_region = read_events[q0 : q1 + 1]
            read_size = q1 - q0 + 1
            if not cigar:
                if current_max < min_score:
                    chain.alignment_score = -1e10
                    return
                exclude_last = part != parts - 1
                if opt.dtw_fill_method == FillMethod.FULL:
                    sub = np.float32(
                        gdtw.dtw_global(read_region, ref_region, exclude_last)
                    )
                else:
                    band = max(1, int(read_size * opt.dtw_band_radius_frac))
                    sub = np.float32(
                        gdtw.dtw_global_slantedbanded_antidiagonalwise(
                            read_region, ref_region, band, exclude_last
                        )
                    )
                dtw_cost += sub
                current_max -= sub
            else:
                sub_res = gdtw.dtw_global_tb(read_region, ref_region)
                for el in sub_res.alignment:
                    alignment.append(
                        gdtw.AlignmentElement(el.i + q0, el.j + t0, el.difference)
                    )
                dtw_cost += np.float32(sub_res.cost)
            num_aligned += read_size
        if cigar:
            chain.dtw = gdtw.DtwResult(float(dtw_cost), alignment)
    else:
        raise ValueError("invalid border constraint")

    chain.alignment_score = float(
        np.float32(num_aligned) * np.float32(opt.dtw_match_bonus) - dtw_cost
    )

    if opt.flag & MappingFlag.DTW_LOG_SCORES:
        # rmap.cpp:308-312 (only reached when not early-abandoned)
        print(
            f"chaining_score={chain.chaining_score:f} "
            f"alignment_score={chain.alignment_score:f}",
            file=sys.stderr,
        )


def gen_primary_chains(chains: list[Chain], opt: MappingOptions) -> list[Chain]:
    """Primary chain selection by score + overlap (rmap.cpp:90-128)."""
    chains = sorted(chains, key=Chain.sort_key_desc, reverse=True)
    primary = [chains[0]]
    use_aln = bool(opt.flag & MappingFlag.DTW_EVALUATE_CHAINS)
    for ci in range(1, len(chains)):
        c = chains[ci]
        ref_score = primary[-1].alignment_score if use_aln else primary[-1].chaining_score
        c_score = c.alignment_score if use_aln else c.chaining_score
        if c_score < ref_score / 3:
            break
        is_primary = True
        for p in primary:
            if c.reference_sequence_index == p.reference_sequence_index:
                if max(c.start_position, p.start_position) <= min(
                    c.end_position, p.end_position
                ):
                    is_primary = False
                    break
        if is_primary:
            primary.append(c)
    return primary


def comp_mapq(chains: list[Chain], opt: MappingOptions) -> None:
    """MAPQ from best/second score ratio, capped at 60 (rmap.cpp:65-88)."""
    if len(chains) == 1:
        chains[0].mapq = 60
        return
    from rawalign_tpu_torch.golden.engine import c_fdiv

    if opt.flag & MappingFlag.DTW_EVALUATE_CHAINS:
        ratio = c_fdiv(chains[1].alignment_score, chains[0].alignment_score)
    else:
        ratio = c_fdiv(chains[1].chaining_score, chains[0].chaining_score)
    # C casts the float to int before clamping (rmap.cpp:74-86); on x86
    # inf/nan convert to INT_MIN, which clamps to 0
    v = 40.0 * (1.0 - ratio)
    mapq = 0 if (v != v or v < 0) else (60 if v > 60 else int(v))
    chains[0].mapq = mapq


def log_anchors(
    anchors_by_key: dict,
    read_name: str,
    seq_names: list[str],
    n_seq: int,
) -> None:
    """--log-anchors emission (rmap.cpp:403-416): every (target, strand)
    pair of the sorted anchor table, including empty ones."""
    for t_ind in range(n_seq):
        for strand in (0, 1):
            lst = anchors_by_key.get((strand, t_ind), [])
            astr = "".join(f"({q},{t})" for t, q in lst)
            print(
                f"readname={read_name} refname={seq_names[t_ind]} "
                f"strand={strand} anchors={astr}",
                file=sys.stderr,
            )


def log_num_anchors(
    read_name: str, chunk_start: int, l_chunk_events: int, n_hits: int
) -> None:
    """--log-num-anchors emission (rmap.cpp:418-425)."""
    print(
        f"readname={read_name} "
        f"pos=[{chunk_start},{chunk_start + l_chunk_events - 1}] "
        f"num_anchors={n_hits}",
        file=sys.stderr,
    )


def gen_chains(
    index,
    chunk_events: np.ndarray,
    chunk_start: int,
    read_events: np.ndarray,
    previous_chains: list[Chain],
    opt: MappingOptions,
    read_name: str = "",
) -> list[Chain]:
    """Full per-chunk seeding + chaining + DTW pipeline
    (gen_chains, rmap.cpp:315-542). Returns the new chain list."""
    anchors_by_key, chunk_seed_hits = collect_anchors(
        index, chunk_events, chunk_start, previous_chains, opt
    )
    if opt.flag & MappingFlag.LOG_ANCHORS:
        log_anchors(anchors_by_key, read_name, index.seq_names, index.n_seq)
    if opt.flag & MappingFlag.LOG_NUM_ANCHORS:
        log_num_anchors(
            read_name, chunk_start, chunk_events.size, chunk_seed_hits
        )
    chains: list[Chain] = []
    max_score = 0.0
    e = index.opt.e
    for t_ind in range(index.n_seq):
        for strand in (0, 1):
            lst = anchors_by_key.get((strand, t_ind), [])
            max_score = chain_anchors(
                lst, strand, t_ind, e, opt, max_score, chains
            )

    if opt.flag & (MappingFlag.DTW_EVALUATE_CHAINS | MappingFlag.DTW_LOG_SCORES):
        chains.sort(key=lambda c: c.chaining_score, reverse=True)
        post: list[Chain] = []
        best_found = 0.0
        for ch in chains:
            align_chain(ch, index, read_events, opt, False, best_found)
            if ch.alignment_score >= opt.dtw_min_score:
                if ch.alignment_score > best_found:
                    best_found = ch.alignment_score
                post.append(ch)
        if opt.flag & MappingFlag.DTW_EVALUATE_CHAINS:
            chains = post

    if chains:
        chains = gen_primary_chains(chains, opt)
        comp_mapq(chains, opt)
    return chains
