"""Copy of rawalign_tpu/golden/events.py for the port.

Event detection golden model (reference: src/revent.c).

Segmentation of a raw signal chunk into events (per-event mean current),
Scrappie/Sigmap style: prefix sums -> two-window Student-t statistics ->
dual-detector peak finding with masking -> event means between peaks ->
per-chunk z-normalization.

Float semantics follow the C code: float32 prefix sums and t-stats,
float64 accumulators for the event mean/stddev (revent.c:143,179-180).
"""

from __future__ import annotations

import numpy as np

FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)


def prefix_sums(sig: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(prefix_sum, prefix_sum_square), each length len(sig)+1, float32
    sequential accumulation (revent.c:22-32)."""
    sig = np.asarray(sig, dtype=np.float32)
    ps = np.zeros(sig.size + 1, dtype=np.float32)
    pss = np.zeros(sig.size + 1, dtype=np.float32)
    np.cumsum(sig, dtype=np.float32, out=ps[1:])
    np.cumsum(sig * sig, dtype=np.float32, out=pss[1:])
    return ps, pss


def tstat(ps: np.ndarray, pss: np.ndarray, s_len: int, w: int) -> np.ndarray:
    """Two-sample t-statistic with equal windows of length w on both sides
    (revent.c:34-75). Output length s_len+1 with zeroed boundaries."""
    t = np.zeros(s_len + 1, dtype=np.float32)
    if s_len < 2 * w or w < 2:
        return t
    i = np.arange(w, s_len - w + 1)
    sum1 = ps[i].copy()
    sumsq1 = pss[i].copy()
    gt = i > w
    sum1[gt] -= ps[i - w][gt]
    sumsq1[gt] -= pss[i - w][gt]
    sum2 = ps[i + w] - ps[i]
    sumsq2 = pss[i + w] - pss[i]
    w32 = np.float32(w)
    mean1 = sum1 / w32
    mean2 = sum2 / w32
    combined_var = sumsq1 / w32 - mean1 * mean1 + sumsq2 / w32 - mean2 * mean2
    combined_var = np.maximum(combined_var, FLT_MIN)
    delta_mean = mean2 - mean1
    # C: fabs(delta)/sqrt(var/w) with double sqrt, result stored to float.
    t[i] = (
        np.abs(delta_mean.astype(np.float64))
        / np.sqrt((combined_var / w32).astype(np.float64))
    ).astype(np.float32)
    # boundary fudge (revent.c:48,72)
    t[s_len - w + 1 : s_len + 1] = 0.0
    return t


def gen_peaks(
    t1: np.ndarray,
    t2: np.ndarray,
    s_len: int,
    threshold1: float,
    threshold2: float,
    w1: int,
    w2: int,
    peak_height: float,
) -> np.ndarray:
    """Dual-detector peak finding (revent.c:77-138). Returns peak positions.

    Detector 0 (short, window w1) dominates detector 1 (long, window w2):
    when the short detector is going to fire, the long detector is masked
    past the short peak and fully reset.
    """
    peak_height = np.float32(peak_height)
    # state per detector: masked_to, peak_pos, peak_value, valid_peak
    sig = [np.asarray(t1, dtype=np.float32), np.asarray(t2, dtype=np.float32)]
    threshold = [np.float32(threshold1), np.float32(threshold2)]
    window = [w1, w2]
    masked_to = [0, 0]
    peak_pos = [-1, -1]
    peak_value = [FLT_MAX, FLT_MAX]
    valid_peak = [False, False]
    peaks: list[int] = []

    for i in range(s_len):
        for k in (0, 1):
            if masked_to[k] >= i:
                # Note: this skips i==0 for both detectors (masked_to starts
                # at 0 and the comparison is >=), matching revent.c:91.
                continue
            current_value = sig[k][i]
            if peak_pos[k] == -1:
                if current_value < peak_value[k]:
                    peak_value[k] = current_value
                elif current_value - peak_value[k] > peak_height:
                    peak_value[k] = current_value
                    peak_pos[k] = i
            else:
                if current_value > peak_value[k]:
                    peak_value[k] = current_value
                    peak_pos[k] = i
                if k == 0 and peak_value[0] > threshold[0]:
                    masked_to[1] = peak_pos[0] + window[0]
                    peak_pos[1] = -1
                    peak_value[1] = FLT_MAX
                    valid_peak[1] = False
                if (
                    peak_value[k] - current_value > peak_height
                    and peak_value[k] > threshold[k]
                ):
                    valid_peak[k] = True
                if valid_peak[k] and (i - peak_pos[k]) > window[k] // 2:
                    peaks.append(peak_pos[k])
                    peak_pos[k] = -1
                    peak_value[k] = current_value
                    valid_peak[k] = False
    return np.asarray(peaks, dtype=np.uint32)


def gen_events(
    peaks: np.ndarray, ps: np.ndarray, s_len: int
) -> np.ndarray | None:
    """Event means between consecutive peaks + final segment, z-normalized
    over the chunk (revent.c:140-188)."""
    peaks = np.asarray(peaks)
    if peaks.size == 0:
        return None
    n_ev = 1 + int(np.sum((peaks[1:] > 0) & (peaks[1:] < s_len)))
    events = np.zeros(n_ev, dtype=np.float32)
    l_prefixsum = np.float32(0.0)
    l_peak = np.float32(0.0)
    for pi in range(n_ev - 1):
        p = int(peaks[pi])
        events[pi] = (ps[p] - l_prefixsum) / (np.float32(p) - l_peak)
        l_prefixsum = ps[p]
        l_peak = np.float32(p)
    events[n_ev - 1] = (ps[s_len] - l_prefixsum) / (np.float32(s_len) - l_peak)

    # Bit-parity with revent.c:164-175 requires TWO details: (1) C
    # squares `events[pi]*events[pi]` in FLOAT (both operands float32,
    # one rounding) before the double accumulation; (2) sum/sum2
    # accumulate SEQUENTIALLY in double (numpy's pairwise np.sum rounds
    # differently). Either alone shifts every normalized event by 1-2
    # ulp.
    s = 0.0
    s2 = 0.0
    for v in events:
        s += float(v)
        s2 += float(np.float32(v) * np.float32(v))
    mean = s / n_ev
    std = np.sqrt(s2 / n_ev - mean * mean)
    return ((events.astype(np.float64) - mean) / std).astype(np.float32)


def detect_events_fast(sig: np.ndarray, opt) -> np.ndarray:
    """``detect_events`` with the two sequential loops (peak finding,
    event means) in the native C library — output-identical (the C
    functions replicate the float semantics; tests/test_native.py).
    Falls back to the pure-Python detector without the library. This is
    the engine's host-stage1 event detector (map/engine.py
    stage1_impl="host")."""
    from rawalign_tpu_torch import native

    if not native.events_available():
        return detect_events(sig, opt)
    return native.detect_events(
        sig,
        w1=opt.window_length1,
        w2=opt.window_length2,
        threshold1=opt.threshold1,
        threshold2=opt.threshold2,
        peak_height=opt.peak_height,
    )


def detect_events(sig: np.ndarray, opt) -> np.ndarray:
    """The whole detector (revent.c:190-210). opt needs window_length1/2, threshold1/2,
    peak_height. Returns float32 normalized event means (possibly empty)."""
    sig = np.asarray(sig, dtype=np.float32)
    s_len = sig.size
    if s_len == 0:
        return np.zeros(0, dtype=np.float32)
    ps, pss = prefix_sums(sig)
    t1 = tstat(ps, pss, s_len, opt.window_length1)
    t2 = tstat(ps, pss, s_len, opt.window_length2)
    peaks = gen_peaks(
        t1,
        t2,
        s_len,
        opt.threshold1,
        opt.threshold2,
        opt.window_length1,
        opt.window_length2,
        opt.peak_height,
    )
    if peaks.size == 0:
        return np.zeros(0, dtype=np.float32)
    ev = gen_events(peaks, ps, s_len)
    return ev if ev is not None else np.zeros(0, dtype=np.float32)
