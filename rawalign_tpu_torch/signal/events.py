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
the tensor's device.
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
