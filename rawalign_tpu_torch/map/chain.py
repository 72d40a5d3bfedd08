"""Batched chaining DP (port of rawalign_tpu/map/chain.py).

The reference's chaining DP (rmap.cpp:427-507) over one read's anchors,
flattened into one array sorted by (segment = target*2+strand,
target_pos, query_pos): anchor i looks back over at most ``window``
predecessors j = i-1, i-2, ... of its own segment, skipping same-query
or same-target pairs and pairs with a negative query step, stopping at
the first target gap beyond ``max_target_gap`` and once more than
``max_skips`` predecessors in a row fail to improve the score. The
first maximum in distance order wins ties.

:func:`chain_dp_plain` is the JAX package's ``lax.scan`` step by step:
one anchor per step, the window a vector axis, the serial early exits
prefix sums and prefix maxima over it. It equals the JAX scan and the
native C loop (``native.chain_dp``) bit for bit. The CUDA kernel's own
formulations, held to it by the tests: :func:`chain_runs` and
:func:`chain_dp_runs_plain` (its split of a row into independent runs
and jobs) and :func:`chain_dp_scan_plain` (its step: the window record,
then slot 1 last). ``map/chain_cuda.py`` holds the CUDA kernel and the
wrapper that picks between it and :func:`chain_dp_plain` by the
tensor's device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = float(np.float32(-3e38))


class ChainScores(NamedTuple):
    scores: torch.Tensor  # (B, A) float32 chaining scores
    preds: torch.Tensor  # (B, A) int32 predecessor index (== i for none)


def chain_dp_plain(
    seg: torch.Tensor,
    target: torch.Tensor,
    query: torch.Tensor,
    n_anchors: torch.Tensor,
    *,
    window: int,
    e: int,
    max_gap: int,
    max_target_gap: int,
    max_skips: int,
) -> ChainScores:
    """Plain PyTorch chaining DP. ``seg``, ``target``, ``query`` (B, A)
    int32 sorted per row; ``n_anchors`` (B,) int32. Slots at and past a
    row's ``n_anchors`` get score 0 and pred = their own index."""
    B, A = seg.shape
    dev = seg.device
    init = float(e)
    ar = torch.arange(A, dtype=torch.int32, device=dev)
    n = n_anchors.to(torch.int64)
    steps = min(A, int(n.max())) if B and A else 0
    f = torch.zeros((B, A), dtype=torch.float32, device=dev)
    preds = ar.expand(B, A).clone()
    for i in range(steps):
        lo = max(i - window, 0)
        if lo == i:
            f[:, i] = init
            continue
        # predecessors j = i-1 .. lo; axis position d-1 is distance d
        ws = seg[:, lo:i].flip(1)
        wt = target[:, lo:i].flip(1)
        wq = query[:, lo:i].flip(1)
        wf = f[:, lo:i].flip(1)
        cs = seg[:, i : i + 1]
        ct = target[:, i : i + 1]
        cq = query[:, i : i + 1]
        seg_ok = ws == cs
        cont = seg_ok & ((wq == cq) | (wt == ct))  # rmap.cpp:456-457
        brk_gap = seg_ok & ~cont & (wt + max_target_gap < ct)  # :458
        qdiff = cq - wq
        tdiff = ct - wt
        cont2 = seg_ok & ~cont & ~brk_gap & (qdiff < 0)  # :465
        # every slot at or past the first target-gap break is dead
        dead = brk_gap.to(torch.int32).cumsum(1) > 0
        processed = seg_ok & ~cont & ~cont2 & ~dead
        matching = torch.minimum(tdiff, qdiff).clamp(max=e)
        gap_len = (tdiff - qdiff).abs()
        gap_scale = torch.where(
            tdiff > 0, qdiff.to(torch.float32) / tdiff.to(torch.float32), 1.0
        )
        gates = (gap_len < max_gap) & (gap_scale < 5.0) & (gap_scale > 0.75)
        cand = torch.where(gates, wf + matching.to(torch.float32), 0.0)  # :472-474
        cand = torch.where(processed, cand, NEG)
        # running best before each slot: max(init, exclusive prefix max)
        cmax = cand.cummax(1).values
        running = torch.cat(
            [torch.full((B, 1), NEG, device=dev), cmax[:, :-1]], dim=1
        ).clamp(min=init)
        improved = processed & (cand > running)  # :476
        # skip counter: +1 per processed non-improving slot, -1 per
        # improvement; the loop stops AFTER the slot that pushes it past
        # max_skips (rmap.cpp:479-483)
        delta = torch.where(processed, torch.where(improved, -1, 1), 0)
        skips = delta.cumsum(1)
        brk = (processed & ~improved & (skips > max_skips)).to(torch.int32)
        alive = processed & ((brk.cumsum(1) - brk) == 0)
        best, best_at = torch.where(alive, cand, NEG).max(dim=1)  # first max
        f[:, i] = best.clamp(min=init)
        preds[:, i] = torch.where(best > init, i - 1 - best_at, i).to(torch.int32)
    inside = ar[None, :] < n[:, None]
    return ChainScores(
        scores=torch.where(inside, f, 0.0),
        preds=torch.where(inside, preds, ar[None, :]),
    )


#: lanes of a warp: the CUDA kernel's chunk of window slots
LANES = 32
#: slabs the CUDA kernel cuts a row into: at most this many jobs a row
#: (``RA_JOBS`` in ``csrc/chain_dp.cu``)
JOBS = 1024
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def chain_runs(seg: torch.Tensor, target: torch.Tensor,
               n_anchors: torch.Tensor, *, max_target_gap: int,
               slabs: int | None = None) -> list[torch.Tensor]:
    """Per row, the starts (int64, ascending, the first 0) of its
    independent runs, as the CUDA kernel finds them: a run starts where
    the segment changes or, inside one segment, where
    ``t[k] + max_target_gap < t[k+1]``. No slot before a run's start ever
    adds a candidate to or counts against an anchor of the run (the
    argument is in ``csrc/chain_dp.cu``'s header), so each run's DP with
    its windows clipped at its start gives the row's result. That needs
    the row non-decreasing in (segment, target) and every
    ``t + max_target_gap`` inside int32: a row that fails either is one
    run. A row of no anchors has no run. With ``slabs``, the kernel's
    jobs instead: the row cut into ``slabs`` slabs of equal anchor count,
    a job starting at the first run start of each slab that has one."""
    A = seg.shape[1]
    s, t = seg.to(torch.int64), target.to(torch.int64)
    n = n_anchors.to(torch.int64).clamp(0, A)
    out = []
    for b in range(seg.shape[0]):
        m = int(n[b])
        sb, tb = s[b, :m], t[b, :m]
        tg = tb + max_target_gap
        ordered = bool(((sb[1:] > sb[:-1])
                        | ((sb[1:] == sb[:-1]) & (tb[1:] >= tb[:-1]))).all())
        fits = bool(((tg >= INT32_MIN) & (tg <= INT32_MAX)).all())
        brk = (sb[1:] != sb[:-1]) | (tg[:-1] < tb[1:])
        if not (ordered and fits):
            brk = torch.zeros_like(brk)
        starts = torch.cat([torch.zeros(min(m, 1), dtype=torch.int64,
                                        device=seg.device),
                            brk.nonzero()[:, 0] + 1])
        if slabs is not None:
            slab = starts * slabs // max(m, 1)
            starts = starts[torch.cat([slab[:1] >= 0, slab[1:] != slab[:-1]])]
        out.append(starts)
    return out


def chain_dp_runs_plain(
    seg: torch.Tensor,
    target: torch.Tensor,
    query: torch.Tensor,
    n_anchors: torch.Tensor,
    *,
    window: int,
    e: int,
    max_gap: int,
    max_target_gap: int,
    max_skips: int,
    slabs: int | None = None,
) -> ChainScores:
    """:func:`chain_dp_plain` run by run, as the CUDA kernel splits the
    rows (:func:`chain_runs`; with ``slabs``, by the kernel's jobs): every
    run of every row becomes a row of its own, starting at slot 0, so its
    windows stop at the run's start; one :func:`chain_dp_plain` call takes
    them all and its scores and predecessors (shifted by the run's start)
    go back to their slots. Equal to :func:`chain_dp_plain` bit for bit."""
    B, A = seg.shape
    dev = seg.device
    n = n_anchors.to(torch.int64).clamp(0, A)
    rows, lo, ln = [], [], []
    for b, st in enumerate(chain_runs(seg, target, n_anchors,
                                      max_target_gap=max_target_gap,
                                      slabs=slabs)):
        rows.append(torch.full_like(st, b))
        lo.append(st)
        ln.append(torch.cat([st[1:], n[b : b + 1]]) - st)
    rows, lo, ln = torch.cat(rows), torch.cat(lo), torch.cat(ln)
    ar = torch.arange(A, dtype=torch.int32, device=dev)
    scores = torch.zeros((B, A), dtype=torch.float32, device=dev)
    preds = ar.expand(B, A).clone()
    if rows.numel():
        L = torch.arange(int(ln.max()), device=dev)
        at = (lo[:, None] + L[None, :]).clamp(max=A - 1)
        dp = chain_dp_plain(
            *(x[rows[:, None], at].contiguous() for x in (seg, target, query)),
            ln.to(torch.int32), window=window, e=e, max_gap=max_gap,
            max_target_gap=max_target_gap, max_skips=max_skips,
        )
        live = L[None, :] < ln[:, None]
        r, c = rows[:, None].expand_as(at)[live], at[live]
        scores[r, c] = dp.scores[live]
        preds[r, c] = (dp.preds + lo[:, None])[live].to(torch.int32)
    return ChainScores(scores=scores, preds=preds)


#: candidates a window record holds (``RA_CANDS`` in ``csrc/chain_dp.cu``)
CANDS = 4


def chain_dp_scan_plain(
    seg: torch.Tensor,
    target: torch.Tensor,
    query: torch.Tensor,
    n_anchors: torch.Tensor,
    *,
    window: int,
    e: int,
    max_gap: int,
    max_target_gap: int,
    max_skips: int,
    visited: torch.Tensor | None = None,
    paths: torch.Tensor | None = None,
) -> ChainScores:
    """The CUDA kernel's step in plain PyTorch, with the same result as
    :func:`chain_dp_plain` (the kernel's split of a row into runs is
    :func:`chain_dp_runs_plain`'s; here the window is the row's).

    Each anchor i is resolved in two parts, as the kernel does it.
    (a) What reads no score of anchor i-1. The window pass (the kernel's
    first launch): every slot's processed flag, gates and matching, the
    target-gap break, the prefix counts P_d of processed slots and C_d of
    candidate slots (processed slots that pass the gates, or every
    processed slot when init < 0: no other can ever improve), stopping at
    the first processed non-candidate slot with P_d - 2 C_d >
    ``max_skips``, where the loop breaks whatever the scores; its record
    holds up to ``CANDS`` candidates (d, P_d, matching, gated), or marks
    the anchor complex (more candidates, a field beyond its byte, or a
    candidate with P_d > ``max_skips``, which could meet a skip break).
    Then the candidates of slots d >= 2, from scores at least two steps
    old, and their max A over init. (b) What waits for f[i-1]: slot 1's
    candidate c1. No candidate of a record meets a skip break, so the
    result is the first maximum over init and the candidates in distance
    order, max(A, c1); a complex anchor walks its window in chunks of
    ``LANES`` slots with a running max and a skip count carried from
    chunk to chunk, the predecessor the last improvement before the first
    break.

    ``visited`` (B,) int64, if given, gains the predecessor slots the
    reference's serial loop visits in each row (every slot up to and
    including the one it breaks at): the work the data needs, which
    ``chip_smoke.py`` turns into the kernel's bound. ``paths`` (2,)
    int64, if given, gains the anchors (with a predecessor slot) resolved
    by the max and across the lanes."""
    B, A = seg.shape
    dev = seg.device
    init = float(e)
    lanes = torch.arange(LANES, device=dev)
    ar = torch.arange(A, dtype=torch.int32, device=dev)
    n = n_anchors.to(torch.int64)
    steps = min(A, int(n.max())) if B and A else 0
    f = torch.zeros((B, A), dtype=torch.float32, device=dev)
    preds = ar.expand(B, A).clone()
    rows = torch.arange(B, device=dev)
    neg = torch.full((B, 1), NEG, device=dev)

    def first(mask):  # the first set position; the width when none
        w = mask.shape[1]
        return torch.where(mask.any(1), mask.to(torch.int32).argmax(1), w)

    for i in range(steps):
        nwin = min(window, i)
        if nwin == 0:  # no predecessor: init, and itself
            f[:, i] = init
            continue
        cs, ct, cq = seg[:, i : i + 1], target[:, i : i + 1], query[:, i : i + 1]
        # ---- (a) the window pass: slots d = 1 .. nwin, no score read
        d = torch.arange(1, nwin + 1, device=dev)
        j = i - d
        wt, wq = target[:, j], query[:, j]
        seg_ok = seg[:, j] == cs
        cont = seg_ok & ((wq == cq) | (wt == ct))  # rmap.cpp:456-457
        brk = seg_ok & ~cont & (wt + max_target_gap < ct)  # :458
        qdiff = cq - wq
        tdiff = ct - wt
        gap_at = first(brk)  # slots at and past the first break are dead
        proc = (seg_ok & ~cont & ~brk & (qdiff >= 0)  # :465
                & (d[None, :] <= gap_at[:, None]))
        match = torch.minimum(tdiff, qdiff).clamp(max=e)
        gap_len = (tdiff - qdiff).abs()
        gap_scale = torch.where(
            tdiff > 0, qdiff.to(torch.float32) / tdiff.to(torch.float32), 1.0
        )
        gates = (gap_len < max_gap) & (gap_scale < 5.0) & (gap_scale > 0.75)
        cand = proc & (gates | (init < 0))
        P = proc.cumsum(1)
        sure_at = first(proc & ~cand & (P - 2 * cand.cumsum(1) > max_skips))
        cand &= d[None, :] <= sure_at[:, None]
        wide = cand & ((d[None, :] > 255) | (P > 255) | (match < -128)
                       | (match > 127))
        complex_ = ((cand.sum(1) > CANDS) | wide.any(1)
                    | (cand & (P > max_skips)).any(1))
        # the record: the candidates in distance order, as (d, P, m, g)
        at = torch.where(cand, d - 1, nwin).topk(
            min(CANDS, nwin), largest=False, sorted=True).values
        at = torch.cat([at, at.new_full((B, CANDS - at.shape[1]), nwin)], 1)
        has = at < nwin
        at = at.clamp(max=nwin - 1)
        rd = torch.where(has, at + 1, 0)
        rp = torch.where(has, P.gather(1, at), 0)
        rm = torch.where(has, match.gather(1, at), 0)
        rg = has & gates.gather(1, at)
        # candidates of slots d >= 2 (scores two steps old), their max A
        v = torch.where(rg, f[rows[:, None], (i - rd).clamp(min=0)]
                        + rm.to(torch.float32), 0.0)
        live = (rd > 0) & ~complex_[:, None]
        A2 = torch.where(live & (rd >= 2), v, NEG)
        A = A2.max(1).values.clamp(min=init)
        dA = torch.where(A > init, rd[rows, (A2 == A[:, None]).to(torch.int32)
                                      .argmax(1)], 0)
        s1 = live[:, 0] & (rd[:, 0] == 1)
        # ---- (b) f[i-1] arrives
        f1 = f[:, i - 1] if i else torch.zeros(B, device=dev)
        c1 = torch.where(rg[:, 0], f1 + rm[:, 0].to(torch.float32), 0.0)
        best = torch.where(s1, torch.maximum(A, c1), A)
        pred = torch.where(s1 & (c1 > init) & (c1 >= A), i - 1,
                           torch.where(A > init, i - dA, i))
        if paths is not None:
            on = i < n
            paths += torch.stack([(~complex_ & on).sum(),
                                  (complex_ & on).sum()])
        if visited is not None:
            # the improvements among the candidates; past the last one the
            # count runs on without improving to the skip break
            val = torch.where(rd == 1, c1[:, None], v)
            run = torch.where(live, val, NEG).cummax(1).values
            ahead = torch.cat([torch.full((B, 1), init, device=dev),
                               run[:, :-1].clamp(min=init)], 1)
            imp = (live & (val > ahead)).sum(1)
            skip_at = first(proc & (P == (max_skips + 1 + 2 * imp)[:, None]))
            stop = torch.minimum(gap_at, skip_at)
            seen = torch.where(stop < nwin, stop + 1, nwin)
            visited += torch.where(~complex_ & (i < n), seen, 0)
        # ---- complex anchors: the window in chunks across the lanes
        live_rows = complex_.clone()
        cb = torch.full((B,), init, device=dev)
        cp = torch.full((B,), i, dtype=torch.int64, device=dev)
        carry_max = torch.full((B,), init, device=dev)
        carry_skips = torch.zeros(B, dtype=torch.int64, device=dev)
        for k in range((nwin + LANES - 1) // LANES):
            if not live_rows.any():
                break
            sl = k * LANES + lanes  # slot index d - 1
            ok = sl < nwin
            sl = sl.clamp(max=max(nwin - 1, 0))
            processed = proc[:, sl] & ok[None, :] & live_rows[:, None]
            first_gap = first(brk[:, sl] & ok[None, :] & live_rows[:, None])
            cv = torch.where(gates[:, sl],
                             f[rows[:, None], j[sl][None, :].expand(B, -1)]
                             + match[:, sl].to(torch.float32), 0.0)
            cv = torch.where(processed, cv, NEG)
            incl = cv.cummax(1).values
            running = torch.maximum(torch.cat([neg, incl[:, :-1]], 1),
                                    carry_max[:, None])
            improved = processed & (cv > running)  # :476
            delta = torch.where(processed, torch.where(improved, -1, 1), 0)
            skips = carry_skips[:, None] + delta.cumsum(1)
            first_skip = first(processed & ~improved & (skips > max_skips))
            kept = improved & (lanes[None, :] <= first_skip[:, None])
            last = LANES - 1 - kept.flip(1).to(torch.int32).argmax(1)
            has = kept.any(1)
            cb = torch.where(has, cv[rows, last], cb)
            cp = torch.where(has, i - (k * LANES + last + 1), cp)
            carry_max = torch.maximum(carry_max, incl[:, -1])
            carry_skips = skips[:, -1]
            if visited is not None:
                stop = torch.minimum(first_gap, first_skip)
                seen = torch.where(stop < LANES, stop + 1,
                                   min(LANES, nwin - k * LANES))
                visited += torch.where(live_rows & (i < n), seen, 0)
            live_rows &= (first_gap == LANES) & (first_skip == LANES)
        best = torch.where(complex_, cb, best)
        pred = torch.where(complex_, cp, pred)
        f[:, i] = best
        preds[:, i] = pred.to(torch.int32)
    inside = ar[None, :] < n[:, None]
    return ChainScores(
        scores=torch.where(inside, f, 0.0),
        preds=torch.where(inside, preds, ar[None, :]),
    )


def chain_dp_batch(
    seg: torch.Tensor,
    target: torch.Tensor,
    query: torch.Tensor,
    n_anchors: torch.Tensor,
    *,
    window: int = 64,
    e: int = 6,
    max_gap: int = 2000,
    max_target_gap: int = 5000,
    max_skips: int = 25,
) -> ChainScores:
    """Runs the CUDA kernel for CUDA tensors and the plain version for
    CPU tensors."""
    from rawalign_tpu_torch.map import chain_cuda

    return chain_cuda.chain_dp(
        seg, target, query, n_anchors, window=window, e=e, max_gap=max_gap,
        max_target_gap=max_target_gap, max_skips=max_skips,
    )
