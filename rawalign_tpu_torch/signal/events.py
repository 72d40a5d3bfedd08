"""Batched event detection (port of rawalign_tpu/signal/events.py).

Segments each read's raw signal chunk into events, with the semantics of
the golden detector (``rawalign_tpu/golden/events.py``, revent.c:22-188)
and its native C twin (``native.detect_events``) bit for bit:

* float32 prefix sums and sums of squares, accumulated sequentially, the
  square rounded before the add (revent.c:22-32);
* two-window t-statistics ``t = f32(|double(dm)| / sqrt(double(cv/w)))``
  with ``cv`` clamped at FLT_MIN before the division by ``w``, zero
  outside ``w <= i <= len - w`` and everywhere when ``len < 2w`` or
  ``w < 2`` (revent.c:34-75);
* the two-detector peak state machine (revent.c:77-138);
* float32 event means between consecutive peaks (revent.c:140-163);
* z-normalisation with sequential double sums, each square rounded to
  float32 first (revent.c:164-184).

The JAX package computes this in float32 only, because a TPU has no
float64; the port has float64 on both the CPU and the card, so it keeps
the reference's semantics and its events equal the hybrid path's.

Every chunk is normalised over all of its events and then capped at
``max_events``: ``n_dropped = max(total - max_events, 0)``, as the
hybrid path caps the native detector's output.

The sequential axes (samples, and events in the z-norm sums) are
explicit loops vectorised over the batch, so this plain version gives
the same bits on the CPU and on the card. ``signal/events_cuda.py``
holds the CUDA kernel and the wrapper that picks between the two by
the tensor's device. :func:`_peaks_split_plain` is the kernel's
formulation of the peak machine (one detector at a time, then an
ordered compaction) in plain PyTorch; no mapping path calls it, the
tests hold it to :func:`_peaks`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FLT_MAX = float(np.finfo(np.float32).max)
FLT_MIN = float(np.finfo(np.float32).tiny)


class EventBatch(NamedTuple):
    values: torch.Tensor  # (B, max_events) float32 normalised events, 0-padded
    n_events: torch.Tensor  # (B,) int32 events kept
    n_dropped: torch.Tensor  # (B,) int32 events beyond max_events


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the C code receives it."""
    return float(np.float32(x))


def _prefix_sums(sig: torch.Tensor, length: torch.Tensor, steps: int):
    """(ps, pss), each (B, L+1) float32, accumulated sample by sample."""
    B, L = sig.shape
    idx = torch.arange(L, device=sig.device)
    s = torch.where(idx < length[:, None], sig, 0.0)
    sq = s * s
    ps = torch.zeros((B, L + 1), dtype=torch.float32, device=sig.device)
    pss = torch.zeros_like(ps)
    a = ps[:, 0].clone()
    b = a.clone()
    for i in range(steps):
        a = a + s[:, i]
        b = b + sq[:, i]
        ps[:, i + 1] = a
        pss[:, i + 1] = b
    ps[:, steps + 1 :] = a[:, None]
    pss[:, steps + 1 :] = b[:, None]
    return ps, pss


def _tstat(ps: torch.Tensor, pss: torch.Tensor, length: torch.Tensor,
           w: int) -> torch.Tensor:
    """(B, L) float32 t-statistics (``tstat_fill`` of the native library)."""
    B, L1 = ps.shape
    L = L1 - 1
    t = torch.zeros((B, L), dtype=torch.float32, device=ps.device)
    if w < 2 or L < 2 * w:
        return t
    i = torch.arange(w, L - w + 1, device=ps.device)
    sum1 = ps[:, i] - ps[:, i - w]
    sumsq1 = pss[:, i] - pss[:, i - w]
    sum2 = ps[:, i + w] - ps[:, i]
    sumsq2 = pss[:, i + w] - pss[:, i]
    # a tensor, not a Python number: PyTorch's CUDA division by a CPU
    # scalar multiplies by its reciprocal, which is not IEEE division
    w32 = torch.full((), float(w), dtype=torch.float32, device=ps.device)
    mean1 = sum1 / w32
    mean2 = sum2 / w32
    cv0 = sumsq1 / w32 - mean1 * mean1 + sumsq2 / w32 - mean2 * mean2
    cv = torch.where(cv0 > FLT_MIN, cv0, FLT_MIN)
    q = cv / w32
    tv = ((mean2 - mean1).double().abs() / q.double().sqrt()).float()
    ok = (i[None, :] <= length[:, None] - w) & (length[:, None] >= 2 * w)
    t[:, w : L - w + 1] = torch.where(ok, tv, 0.0)
    return t


def _peaks(t1: torch.Tensor, t2: torch.Tensor, length: torch.Tensor,
           steps: int, thresholds, windows, peak_height: float):
    """The two-detector peak machine (``ra_gen_peaks``), one sample per
    step for the whole batch; column 0 of the state is the short
    detector, column 1 the long one. Returns (peaks (B, 2*steps) int64
    in emission order, -1 padded; n_peaks (B,) int64)."""
    B = t1.shape[0]
    dev = t1.device
    t = torch.stack([t1[:, :steps], t2[:, :steps]], dim=2)
    live = torch.arange(steps, device=dev)[None, :] < length[:, None]
    thr = torch.tensor(thresholds, dtype=torch.float32, device=dev)
    half = torch.tensor([w // 2 for w in windows], device=dev)
    masked = torch.zeros((B, 2), dtype=torch.int64, device=dev)
    pos = torch.full((B, 2), -1, dtype=torch.int64, device=dev)
    val = torch.full((B, 2), FLT_MAX, dtype=torch.float32, device=dev)
    valid = torch.zeros((B, 2), dtype=torch.bool, device=dev)
    emitted = torch.full((B, steps, 2), -1, dtype=torch.int64, device=dev)
    long_only = torch.tensor([False, True], device=dev)
    for i in range(steps):
        cv = t[:, i]
        li = live[:, i, None]
        # The short detector steps first: if it is inside a peak whose
        # value (after this sample) exceeds its threshold, it masks the
        # long detector up to its peak + w1 and resets it before the
        # long detector sees this sample. Decided here from the short
        # detector's state alone (column 0 of ``dom`` before the mask),
        # so both detectors then step together.
        up = cv > val
        dom = (li & (masked < i) & (pos >= 0)
               & (torch.where(up, cv, val) > thr))[:, :1] & long_only
        masked = torch.where(
            dom, torch.where(up, i, pos)[:, :1] + windows[0], masked)
        pos = torch.where(dom, -1, pos)
        val = torch.where(dom, FLT_MAX, val)
        valid &= ~dom

        act = li & (masked < i)
        idle = pos < 0
        busy = act & ~idle
        deeper = cv < val
        rise = (cv - val) > peak_height
        up = cv > val
        # no peak recorded: follow the minimum, start a peak once the
        # value rises peak_height above it; inside a peak: follow the max
        val = torch.where(act & torch.where(idle, deeper | rise, up), cv, val)
        pos = torch.where(act & torch.where(idle, ~deeper & rise, up), i, pos)
        valid |= busy & ((val - cv) > peak_height) & (val > thr)
        fire = busy & valid & ((i - pos) > half)
        emitted[:, i] = torch.where(fire, pos, -1)
        pos = torch.where(fire, -1, pos)
        val = torch.where(fire, cv, val)
        valid &= ~fire
    flat = emitted.reshape(B, 2 * steps)
    present = flat >= 0
    order = torch.sort((~present).to(torch.int32), dim=1, stable=True).indices
    return flat.gather(1, order), present.sum(dim=1)


def _peak_step(pos, val, valid, act, i, cv, thr: float, half: int,
               peak_height: float):
    """One sample (``i``: its index, a number or a tensor) of one detector
    in select form, for every lane. Returns (fired peak or -1, pos, val,
    valid, npos, nval): ``npos`` and ``nval`` are the peak position and
    value after the update and before the fire."""
    idle = pos < 0
    up = cv > val
    deeper = cv < val
    rise = (cv - val) > peak_height
    # no peak: follow the minimum, start a peak once the value rises
    # peak_height above it; inside a peak: follow the maximum
    take = act & torch.where(idle, deeper | rise, up)
    mark = act & torch.where(idle, ~deeper & rise, up)
    nval = torch.where(take, cv, val)
    npos = torch.where(mark, i, pos)
    busy = act & ~idle
    valid = valid | (busy & ((nval - cv) > peak_height) & (nval > thr))
    fire = busy & valid & ((i - npos) > half)
    return (torch.where(fire, npos, -1), torch.where(fire, -1, npos),
            torch.where(fire, cv, nval), valid & ~fire, npos, nval)


def _detector_run(long: bool, state, first, n: int, stop, t, record, length,
                  thr: float, half: int, peak_height: float, w1: int):
    """``n`` samples of one detector on (B, C) lanes: lane (b, c) steps
    samples ``first[c] .. first[c] + n - 1`` of row b, those in
    ``[1, stop[c])`` and below the row's length. ``state`` is (pos, val,
    valid, masked), each (B, C); it leaves as the state before sample
    ``stop`` (a mask that has ended is forgotten, so that equal behaviour
    is equal state). The long detector reads ``record`` (B, steps): where
    the short one masked it, it starts over before it sees the sample.
    Returns (state, peaks fired (B, C, n) or -1, the short detector's
    record of these samples (B, C, n))."""
    pos, val, valid, masked = state
    B, C = pos.shape
    fired = torch.full((B, C, n), -1, dtype=torch.int64, device=t.device)
    rec = torch.full((B, C, n), -1, dtype=torch.int64, device=t.device)
    for k in range(n):
        i = (first + k)[None, :]
        on = (i >= 1) & (i < stop[None, :]) & (i < length[:, None])
        at = i.clamp(0, t.shape[1] - 1).expand(B, C)
        cv = t.gather(1, at)
        act = on
        if long:
            r = record.gather(1, at)
            dom = on & (r >= 0)
            masked = torch.where(dom, r, masked)
            pos = torch.where(dom, -1, pos)
            val = torch.where(dom, FLT_MAX, val)
            valid = valid & ~dom
            act = on & (masked < i)
        inside = on & (pos >= 0)
        fired[:, :, k], pos, val, valid, npos, nval = _peak_step(
            pos, val, valid, act, i, cv, thr, half, peak_height)
        if not long:
            rec[:, :, k] = torch.where(inside & (nval > thr), npos + w1, -1)
    masked = torch.where(masked >= stop[None, :], masked, -1)
    return (pos, val, valid, masked), fired, rec


def _same_state(a, b) -> torch.Tensor:
    """Lanes whose two states are equal bit for bit."""
    return ((a[0] == b[0]) & (a[1].view(torch.int32) == b[1].view(torch.int32))
            & (a[2] == b[2]) & (a[3] == b[3]))


def _detector_chunks(long: bool, t, record, length, steps: int, chunk: int,
                     thr: float, half: int, peak_height: float, w1: int):
    """One detector over samples 1 .. steps-1 in chunks of ``chunk``
    samples, as the CUDA kernel runs it. Every chunk is a lane. In the
    first round every chunk runs from the start state, which is right for
    the first chunk only. While any chunk did not start from the state
    the chunk before it ended in, all such chunks run again, each from
    that state (the first of them then started right, so the rounds end).
    Returns (peaks fired per sample (B, steps) or -1, record (B, steps))."""
    B = t.shape[0]
    dev = t.device
    fired_row = torch.full((B, steps), -1, dtype=torch.int64, device=dev)
    rec_row = fired_row.clone()
    if steps < 2:
        return fired_row, rec_row
    C = -(-(steps - 1) // chunk)
    lo = 1 + torch.arange(C, device=dev) * chunk
    hi = (lo + chunk).clamp(max=steps)
    args = (t, record, length, thr, half, peak_height, w1)
    begun = (torch.full((B, C), -1, dtype=torch.int64, device=dev),
             torch.full((B, C), FLT_MAX, dtype=torch.float32, device=dev),
             torch.zeros((B, C), dtype=torch.bool, device=dev),
             torch.full((B, C), -1, dtype=torch.int64, device=dev))
    ended, fired, rec = _detector_run(long, begun, lo, chunk, hi, *args)
    while True:
        before = tuple(torch.cat([b[:, :1], e[:, :-1]], dim=1)
                       for b, e in zip(begun, ended))
        # a row has no chunks past its length
        wrong = ~_same_state(begun, before) & (lo[None, :] < length[:, None])
        if not bool(wrong.any()):
            break
        again, fired_a, rec_a = _detector_run(long, before, lo, chunk, hi, *args)
        begun = tuple(torch.where(wrong, x, y) for x, y in zip(before, begun))
        ended = tuple(torch.where(wrong, x, y) for x, y in zip(again, ended))
        fired = torch.where(wrong[:, :, None], fired_a, fired)
        rec = torch.where(wrong[:, :, None], rec_a, rec)
    fired_row[:, 1:] = fired.reshape(B, C * chunk)[:, : steps - 1]
    rec_row[:, 1:] = rec.reshape(B, C * chunk)[:, : steps - 1]
    return fired_row, rec_row


def _peaks_split_plain(t1: torch.Tensor, t2: torch.Tensor,
                       length: torch.Tensor, steps: int, thresholds, windows,
                       peak_height: float, chunk: int | None = None):
    """The outputs of :func:`_peaks`, one detector at a time, as the CUDA
    kernel runs them. The short detector never reads the long one's
    state: it runs alone and records, per sample, the end of the mask it
    lays on the long detector (its peak + w1 while it is inside a peak
    above its threshold, else -1). The long detector then runs from that
    record alone. Both skip sample 0 (their mask ends start at 0). Each
    leaves its peak at the sample where it fires; the list in emission
    order (sample order, the short detector first at one sample) is a
    prefix count over the two rows. With ``chunk``, each detector runs in
    chunks of that many samples, in rounds (:func:`_detector_chunks`);
    without, in one piece."""
    B = t1.shape[0]
    dev = t1.device
    chunk = chunk or max(steps, 1)
    short, record = _detector_chunks(
        False, t1[:, :steps], None, length, steps, chunk,
        thresholds[0], windows[0] // 2, peak_height, windows[0])
    long, _ = _detector_chunks(
        True, t2[:, :steps], record, length, steps, chunk,
        thresholds[1], windows[1] // 2, peak_height, windows[0])
    flat = torch.stack([short, long], dim=2).reshape(B, 2 * steps)
    present = flat >= 0
    n_peaks = present.sum(dim=1)
    rank = torch.where(present, present.cumsum(dim=1) - 1, 2 * steps)
    peaks = torch.full((B, 2 * steps + 1), -1, dtype=torch.int64, device=dev)
    peaks.scatter_(1, rank, flat)
    return peaks[:, : 2 * steps], n_peaks


def _event_means(peaks: torch.Tensor, n_peaks: torch.Tensor,
                 ps: torch.Tensor, length: torch.Tensor):
    """(events (B, P) float32 un-normalised, n_ev (B,) int64): event k <
    n_ev-1 spans peaks k-1 (or 0) to k; the last runs to the chunk end."""
    B, P = peaks.shape
    dev = peaks.device
    k = torch.arange(P, device=dev)
    interior = (k[None, :] >= 1) & (peaks > 0) & (peaks < length[:, None])
    n_ev = torch.where(n_peaks > 0, 1 + interior.sum(dim=1), 0)
    # ends[k] = peaks[k] for k < n_ev-1 and the chunk length at k = n_ev-1
    last = (n_ev - 1)[:, None]
    ends = torch.where(k[None, :] == last, length[:, None].to(torch.int64),
                       peaks.clamp(min=0))
    starts = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int64, device=dev), ends[:, :-1]],
        dim=1,
    )
    inside = k[None, :] < n_ev[:, None]
    ends = torch.where(inside, ends, 0)
    starts = torch.where(inside, starts, 0)
    ev = (ps.gather(1, ends) - ps.gather(1, starts)) / (
        ends.to(torch.float32) - starts.to(torch.float32)
    )
    return torch.where(inside, ev, 0.0), n_ev


def _znorm(ev: torch.Tensor, n_ev: torch.Tensor) -> torch.Tensor:
    """z-normalise each row's first n_ev events (revent.c:164-184):
    sequential double sums, each square rounded to float32 first."""
    B, P = ev.shape
    s = torch.zeros(B, dtype=torch.float64, device=ev.device)
    s2 = torch.zeros_like(s)
    sq = ev * ev
    steps = int(n_ev.max()) if B else 0
    for j in range(steps):
        m = j < n_ev
        s = torch.where(m, s + ev[:, j].double(), s)
        s2 = torch.where(m, s2 + sq[:, j].double(), s2)
    n = n_ev.to(torch.float64)
    mean = s / n
    mm = mean * mean
    std = (s2 / n - mm).sqrt()
    out = ((ev.double() - mean[:, None]) / std[:, None]).float()
    inside = torch.arange(P, device=ev.device)[None, :] < n_ev[:, None]
    return torch.where(inside, out, 0.0)


def detect_events_plain(
    sig: torch.Tensor,
    length: torch.Tensor,
    *,
    w1: int,
    w2: int,
    threshold1: float,
    threshold2: float,
    peak_height: float,
    max_events: int,
) -> EventBatch:
    """Plain PyTorch detector. ``sig`` (B, L) float32 chunks (samples past
    a row's length are ignored), ``length`` (B,) int32, clamped to
    ``[0, L]``."""
    sig = sig.to(torch.float32)
    B, L = sig.shape
    length = length.to(torch.int64).clamp(0, L)
    steps = min(L, int(length.max())) if B and L else 0
    values = torch.zeros((B, max_events), dtype=torch.float32, device=sig.device)
    if steps == 0:
        zero = torch.zeros(B, dtype=torch.int32, device=sig.device)
        return EventBatch(values=values, n_events=zero, n_dropped=zero.clone())
    ps, pss = _prefix_sums(sig, length, steps)
    t1 = _tstat(ps, pss, length, w1)
    t2 = _tstat(ps, pss, length, w2)
    peaks, n_peaks = _peaks(
        t1, t2, length, steps, (_f32(threshold1), _f32(threshold2)),
        (w1, w2), _f32(peak_height),
    )
    ev, n_ev = _event_means(peaks, n_peaks, ps, length)
    ev = _znorm(ev, n_ev)
    keep = min(max_events, ev.shape[1])
    values[:, :keep] = ev[:, :keep]
    return EventBatch(
        values=values,
        n_events=n_ev.clamp(max=max_events).to(torch.int32),
        n_dropped=(n_ev - max_events).clamp(min=0).to(torch.int32),
    )


def detect_events_batch(
    sig: torch.Tensor,
    length: torch.Tensor,
    *,
    w1: int = 3,
    w2: int = 6,
    threshold1: float = 4.30265,
    threshold2: float = 2.57058,
    peak_height: float = 1.0,
    max_events: int = 2048,
) -> EventBatch:
    """Batched detect_events (revent.c:190-210). Runs the CUDA kernel for
    CUDA tensors and the plain version for CPU tensors."""
    from rawalign_tpu_torch.signal import events_cuda

    return events_cuda.detect_events(
        sig, length, w1=w1, w2=w2, threshold1=threshold1,
        threshold2=threshold2, peak_height=peak_height, max_events=max_events,
    )
