"""Copy of rawalign_tpu/golden/sketch.py for the port.

Sketching golden model (reference: src/rsketch.c).

Turns a stream of z-normalized event values into seeds:

1. adjacent-similar suppression: drop event i if |s[i] - s[last_kept]| <
   LAST_SIG_DIFF (=0.3) (rsketch.c:172,243);
2. quantization: reinterpret the float32 bits, keep the top 2 bits and lq
   bits taken from just below the top q bits:
   ``sig>>30<<lq | ((sig>>(32-q)) & (2^lq - 1))`` (rsketch.c:178);
3. pack the last e quantized values into a rolling integer (lq+2 bits
   each) (rsketch.c:182);
4. hash with the invertible Thomas-Wang-style hash64 masked to 32 bits
   (rsketch.c:6-15);
5. emit seeds ``x = hash << 6 | span``, ``y = id << 32 | pos << 1 | strand``
   (rsketch.h:39-44). In plain mode pos is the NEWEST event of the window
   (rsketch.c:251-264); in minimizer mode pos is the OLDEST event and a
   minimap2-style w-window minimum filter selects seeds (rsketch.c:146-221).
"""

from __future__ import annotations

import numpy as np

LAST_SIG_DIFF = np.float32(0.3)
RI_MASK_SIGNAL = np.float32(3.402823466e32)
RI_HASH_SHIFT = 6
RI_ID_SHIFT = 32
RI_POS_SHIFT = 1

_M32 = np.uint64(0xFFFFFFFF)
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def hash64(key: int, mask: int = 0xFFFFFFFF) -> int:
    """Invertible integer hash (rsketch.c:6-15), pure-Python ints."""
    m64 = (1 << 64) - 1
    key = ((~key & m64) + ((key << 21) & m64)) & mask
    key = key ^ (key >> 24)
    key = (key + ((key << 3) & m64) + ((key << 8) & m64)) & mask
    key = key ^ (key >> 14)
    key = (key + ((key << 2) & m64) + ((key << 4) & m64)) & mask
    key = key ^ (key >> 28)
    key = (key + ((key << 31) & m64)) & mask
    return key


def hash64_np(key: np.ndarray, mask: np.uint64) -> np.ndarray:
    """Vectorized hash64 over uint64 arrays."""
    key = key.astype(np.uint64)
    with np.errstate(over="ignore"):
        key = ((~key) + (key << np.uint64(21))) & mask
        key = key ^ (key >> np.uint64(24))
        key = (key + (key << np.uint64(3)) + (key << np.uint64(8))) & mask
        key = key ^ (key >> np.uint64(14))
        key = (key + (key << np.uint64(2)) + (key << np.uint64(4))) & mask
        key = key ^ (key >> np.uint64(28))
        key = (key + (key << np.uint64(31))) & mask
    return key


def quantize(values: np.ndarray, q: int, lq: int) -> np.ndarray:
    """Bit-level quantization of float32 values (rsketch.c:177-178)."""
    bits = np.asarray(values, dtype=np.float32).view(np.uint32)
    mask_lq = np.uint32((1 << lq) - 1)
    return ((bits >> np.uint32(30)) << np.uint32(lq)) | (
        (bits >> np.uint32(32 - q)) & mask_lq
    )


def keep_mask(values: np.ndarray, check_mask_signal: bool = False) -> np.ndarray:
    """Sequential adjacent-similar suppression (rsketch.c:243).

    Event i (i>0) is dropped when |s[i] - s[last_kept]| < 0.3; index 0 is
    always kept. In plain (non-minimizer) mode, values equal to
    RI_MASK_SIGNAL are also dropped.
    """
    values = np.asarray(values, dtype=np.float32)
    keep = np.zeros(values.size, dtype=bool)
    last = 0
    for i in range(values.size):
        if i > 0 and abs(float(values[i]) - float(values[last])) < float(LAST_SIG_DIFF):
            continue
        if check_mask_signal and values[i] == RI_MASK_SIGNAL:
            continue
        keep[i] = True
        last = i
    return keep


def sketch_reg(
    values: np.ndarray, sid: int, strand: int, e: int, q: int, lq: int, k: int
) -> np.ndarray:
    """Plain (every-event) sketching (rsketch.c:223-274).

    Returns an (n, 2) uint64 array of (x, y) seed pairs.
    """
    values = np.asarray(values, dtype=np.float32)
    span = np.uint64(k + e - 1)
    quant_bit = lq + 2
    mask_events = (1 << (quant_bit * e)) - 1
    keep = keep_mask(values, check_mask_signal=True)
    idx = np.nonzero(keep)[0]
    if idx.size == 0:
        return np.zeros((0, 2), dtype=np.uint64)
    tq = quantize(values[idx], q, lq).astype(np.uint64)

    # rolling packed value over kept events
    n = idx.size
    packed = np.zeros(n, dtype=np.uint64)
    acc = np.uint64(0)
    qb = np.uint64(quant_bit)
    me = np.uint64(mask_events)
    for t in range(n):
        acc = ((acc << qb) | tq[t]) & me
        packed[t] = acc

    h = hash64_np(packed, _M32)
    x = (h << np.uint64(RI_HASH_SHIFT)) | span
    y = (
        (np.uint64(sid) << np.uint64(RI_ID_SHIFT))
        | (idx.astype(np.uint64) << np.uint64(RI_POS_SHIFT))
        | np.uint64(strand)
    )
    # Only windows with e kept events are emitted (rsketch.c:262).
    out = np.stack([x[e - 1 :], y[e - 1 :]], axis=1)
    return out


def sketch_min(
    values: np.ndarray,
    sid: int,
    strand: int,
    w: int,
    e: int,
    q: int,
    lq: int,
    k: int,
) -> np.ndarray:
    """Minimizer-window sketching (rsketch.c:146-221), faithful state
    machine replica including the identical-minimum emission rules."""
    values = np.asarray(values, dtype=np.float32)
    assert values.size > 0 and 0 < w < 256 and 0 < e <= 10
    span = np.uint64(6 + e - 1)  # note: hardcoded 6, rsketch.c:152
    quant_bit = lq + 2
    mask_events = (1 << (quant_bit * e)) - 1
    U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

    buf = np.full((w, 2), U64MAX, dtype=np.uint64)
    sig_buf = np.zeros((e, 2), dtype=np.uint64)
    out: list[tuple[int, int]] = []
    mn = np.array([U64MAX, U64MAX], dtype=np.uint64)
    min_pos = 0
    buf_pos = 0
    sig_buf_pos = 0
    sig_buf_full = False
    l = 0
    last = 0
    acc = 0
    first = True
    for i in range(values.size):
        if not first and abs(float(values[i]) - float(values[last])) < float(
            LAST_SIG_DIFF
        ):
            continue
        first = False
        l += 1
        last = i
        tq = int(quantize(values[i : i + 1], q, lq)[0])
        acc = ((acc << quant_bit) | tq) & mask_events

        sig_buf[sig_buf_pos, 1] = (
            (np.uint64(sid) << np.uint64(RI_ID_SHIFT))
            | (np.uint64(i) << np.uint64(RI_POS_SHIFT))
            | np.uint64(strand)
        )
        sig_buf_pos += 1
        if sig_buf_pos == e:
            sig_buf_full = True
            sig_buf_pos = 0
        sig_buf[sig_buf_pos, 0] = np.uint64(
            (hash64(acc, 0xFFFFFFFF) << RI_HASH_SHIFT)
        ) | span

        if not sig_buf_full:
            continue

        info = sig_buf[sig_buf_pos].copy()
        buf[buf_pos] = info
        if l == w + e - 1 and mn[0] != U64MAX:
            for j in range(buf_pos + 1, w):
                if mn[0] == buf[j, 0] and buf[j, 1] != mn[1]:
                    out.append((int(buf[j, 0]), int(buf[j, 1])))
            for j in range(buf_pos):
                if mn[0] == buf[j, 0] and buf[j, 1] != mn[1]:
                    out.append((int(buf[j, 0]), int(buf[j, 1])))
        if info[0] <= mn[0]:
            if l >= w + e and mn[0] != U64MAX:
                out.append((int(mn[0]), int(mn[1])))
            mn = info.copy()
            min_pos = buf_pos
        elif buf_pos == min_pos:
            if l >= w + e - 1 and mn[0] != U64MAX:
                out.append((int(mn[0]), int(mn[1])))
            mn = np.array([U64MAX, U64MAX], dtype=np.uint64)
            for j in range(buf_pos + 1, w):
                if mn[0] >= buf[j, 0]:
                    mn = buf[j].copy()
                    min_pos = j
            for j in range(buf_pos + 1):
                if mn[0] >= buf[j, 0]:
                    mn = buf[j].copy()
                    min_pos = j
            if l >= w + e - 1 and mn[0] != U64MAX:
                for j in range(buf_pos + 1, w):
                    if mn[0] == buf[j, 0] and mn[1] != buf[j, 1]:
                        out.append((int(buf[j, 0]), int(buf[j, 1])))
                for j in range(buf_pos + 1):
                    if mn[0] == buf[j, 0] and mn[1] != buf[j, 1]:
                        out.append((int(buf[j, 0]), int(buf[j, 1])))
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
    if mn[0] != U64MAX:
        out.append((int(mn[0]), int(mn[1])))
    return np.asarray(out, dtype=np.uint64).reshape(-1, 2)


def sketch(
    values: np.ndarray,
    sid: int,
    strand: int,
    w: int,
    e: int,
    n: int,
    q: int,
    lq: int,
    k: int,
) -> np.ndarray:
    """Dispatch (rsketch.c:276-284). BLEND (n>0) is disabled upstream."""
    assert 1 < e < 10
    if w:
        return sketch_min(values, sid, strand, w, e, q, lq, k)
    return sketch_reg(values, sid, strand, e, q, lq, k)
