"""Batched event sketching (port of rawalign_tpu/seeds/sketch.py).

Plain-mode seeds (the reference's ri_sketch_reg, rsketch.c:223-274):
adjacent-similar events are skipped, kept events' quantized codes are
packed into a rolling accumulator, and once ``e`` events are packed
every kept event emits ``hash64(pack)`` at its own position.

The reference hashes with hash64 masked to 32 bits, which reads only the
low 32 bits of the pack, so all of it is uint32 arithmetic. PyTorch on
the CPU supports few uint32 operations, so the plain version here works
in int64 on values kept in ``[0, 2**32)``: every shift and add is masked
with ``& 0xFFFFFFFF``, which wraps exactly as uint32 does. Hashes leave
this module as int64 tensors holding those uint32 values.

Minimizer seeds (``w > 0``, :func:`sketch_events_min_batch`) run the
same scan and then the minimizer window filter, in the JAX package's set
semantics.

:func:`_sketch_scan` is the plain PyTorch version of the sequential scan
(the JAX package's ``lax.scan``); ``seeds/sketch_cuda.py`` holds the CUDA
kernel and the wrapper that picks between the two by the tensor's
device. :func:`_sketch_scan_jump_plain` is the kernel's formulation of
the same function (jump pointers, the kept list by rank, then
elementwise outputs) in plain PyTorch; no mapping path calls it, the
tests hold it to :func:`_sketch_scan`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LAST_SIG_DIFF = np.float32(0.3)
RI_MASK_SIGNAL = np.float32(3.402823466e32)
M32 = 0xFFFFFFFF


class SeedBatch(NamedTuple):
    hashes: torch.Tensor  # (B, NE) int64 holding uint32 seed hashes
    qpos: torch.Tensor  # (B, NE) int64 event index of the seed
    valid: torch.Tensor  # (B, NE) bool


def hash64_u32(key: torch.Tensor) -> torch.Tensor:
    """hash64 masked to 32 bits (rsketch.c:6-15). ``key``: int64 in
    ``[0, 2**32)``; result likewise."""
    key = key.to(torch.int64) & M32
    key = ((~key & M32) + ((key << 21) & M32)) & M32
    key = key ^ (key >> 24)
    key = (key + ((key << 3) & M32) + ((key << 8) & M32)) & M32
    key = key ^ (key >> 14)
    key = (key + ((key << 2) & M32) + ((key << 4) & M32)) & M32
    key = key ^ (key >> 28)
    key = (key + ((key << 31) & M32)) & M32
    return key


def quantize_u32(values: torch.Tensor, q: int, lq: int) -> torch.Tensor:
    """Bit-level quantization (rsketch.c:178): the top 2 bits of the
    float's encoding next to ``lq`` bits from below its top ``q`` bits.
    Returns int64 codes."""
    bits = values.to(torch.float32).contiguous().view(torch.int32)
    bits = bits.to(torch.int64) & M32
    return ((bits >> 30) << lq) | ((bits >> (32 - q)) & ((1 << lq) - 1))


def _sketch_scan(events: torch.Tensor, n_events: torch.Tensor, e: int,
                 q: int, lq: int):
    """Plain version of the scan: (hashes, emit, newest, oldest, cnt),
    each (B, NE). ``hashes`` is 0 where nothing is emitted; ``newest``
    is the slot index, ``oldest`` the kept position e-1 keeps earlier
    and ``cnt`` the running kept count (rsketch.c:184-190,253).

    Only the first ``max(n_events)`` slots are stepped: past a row's
    ``n_events`` nothing is kept, so its state is constant and the tail
    columns repeat the last state."""
    B, NE = events.shape
    dev = events.device
    quant_bit = lq + 2
    nbits = quant_bit * e
    mask = (1 << nbits) - 1 if nbits < 32 else M32
    ev = events.to(torch.float32)
    tq = quantize_u32(ev, q, lq)
    n_ev = n_events.to(torch.int64)
    thr = torch.tensor(LAST_SIG_DIFF, device=dev)
    mask_sig = torch.tensor(RI_MASK_SIGNAL, device=dev)
    # C semantics (rsketch.c:243): index 0 bypasses the similarity
    # check; the comparison value starts at event 0 whether or not it
    # was kept, and updates only on keeps
    last = ev[:, 0].clone() if NE else torch.zeros(B, device=dev)
    acc = torch.zeros(B, dtype=torch.int64, device=dev)
    cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    ring = torch.zeros((B, e), dtype=torch.int32, device=dev)
    acc_all = torch.empty((B, NE), dtype=torch.int64, device=dev)
    emit = torch.zeros((B, NE), dtype=torch.bool, device=dev)
    oldest = torch.empty((B, NE), dtype=torch.int32, device=dev)
    cnts = torch.empty((B, NE), dtype=torch.int32, device=dev)
    steps = min(NE, int(n_ev.max())) if B and NE else 0
    for i in range(steps):
        val = ev[:, i]
        keep = (i < n_ev) & (val != mask_sig)
        if i:
            keep &= ~((val - last).abs() < thr)
        last = torch.where(keep, val, last)
        acc = torch.where(keep, ((acc << quant_bit) | tq[:, i]) & mask, acc)
        cnt = cnt + keep.to(torch.int32)
        shifted = torch.cat(
            [ring[:, 1:], torch.full((B, 1), i, dtype=torch.int32, device=dev)],
            dim=1,
        )
        ring = torch.where(keep[:, None], shifted, ring)
        acc_all[:, i] = acc
        emit[:, i] = keep & (cnt >= e)
        oldest[:, i] = ring[:, 0]
        cnts[:, i] = cnt
    acc_all[:, steps:] = acc[:, None]
    oldest[:, steps:] = ring[:, :1]
    cnts[:, steps:] = cnt[:, None]
    hashes = torch.where(emit, hash64_u32(acc_all), 0)
    newest = torch.arange(NE, device=dev).expand(B, NE)
    return hashes, emit, newest, oldest, cnts


def _sketch_scan_jump_plain(events: torch.Tensor, n_events: torch.Tensor,
                            e: int, q: int, lq: int):
    """The outputs of :func:`_sketch_scan` without a step per slot, as the
    CUDA kernel computes them. Which events are kept is the only
    recurrence: ``nxt[j]`` is the first event after ``j`` that is kept
    when ``j`` is the last kept one, and the kept list is the orbit of
    the first non-masked event under ``nxt``. Rank ``r`` of the list is
    reached by the binary digits of ``r`` over the doubled pointers
    ``nxt^(2^k)``; count, ring, pack and hash of every slot then follow
    from the list. Node ``NE`` stands for "none"."""
    B, NE = events.shape
    dev = events.device
    quant_bit = lq + 2
    nbits = quant_bit * e
    mask = (1 << nbits) - 1 if nbits < 32 else M32
    ev = events.to(torch.float32)
    tq = quantize_u32(ev, q, lq)
    n = n_events.to(torch.int64).clamp(0, NE)
    slot = torch.arange(NE, device=dev)
    newest = slot.expand(B, NE)
    if B == 0 or NE == 0:
        z = torch.zeros((B, NE), dtype=torch.int32, device=dev)
        return (z.to(torch.int64), z.to(torch.bool), newest, z, z.clone())
    thr = torch.tensor(LAST_SIG_DIFF, device=dev)
    mask_sig = torch.tensor(RI_MASK_SIGNAL, device=dev)
    # ok[b, j, i]: event i is kept when it follows the kept event j (the
    # scan's own float test, so a NaN event is never similar)
    differs = ~((ev[:, None, :] - ev[:, :, None]).abs() < thr)
    ok = ((slot[None, :] > slot[:, None])[None]
          & (slot[None, None, :] < n[:, None, None])
          & (ev != mask_sig)[:, None, :] & differs)
    nxt = torch.where(ok.any(dim=2), ok.to(torch.int8).argmax(dim=2), NE)
    nxt = torch.cat([nxt, torch.full((B, 1), NE, device=dev)], dim=1)
    # event 0 bypasses the similarity test; when it is the mask value the
    # comparison value stays the mask value and nxt[0] is the first kept
    start = torch.where(n > 0, torch.where(ev[:, 0] != mask_sig, 0, nxt[:, 0]),
                        NE)
    kept = start[:, None].expand(B, NE).clone()
    level = nxt
    for k in range(max(NE - 1, 1).bit_length()):
        kept = torch.where((slot >> k & 1).bool()[None, :],
                           level.gather(1, kept), kept)
        level = level.gather(1, level)
    flags = torch.zeros((B, NE + 1), dtype=torch.int64, device=dev)
    flags.scatter_(1, kept, 1)
    keep = flags[:, :NE].bool()
    cnt = flags[:, :NE].cumsum(dim=1)
    kept_pad = torch.cat(
        [kept, torch.zeros((B, 1), dtype=torch.int64, device=dev)], dim=1)
    oldest = torch.where(cnt >= e, kept_pad.gather(1, (cnt - e).clamp(min=0)), 0)
    emit = keep & (cnt >= e)
    # the pack: the e newest kept codes, the newest lowest; a code shifted
    # to bit 32 or beyond has left the uint32
    acc = torch.zeros((B, NE), dtype=torch.int64, device=dev)
    for j in range(e):
        if quant_bit * j >= 32:
            break
        pos = kept_pad.gather(1, (cnt - 1 - j).clamp(min=0)).clamp(max=NE - 1)
        acc |= (tq.gather(1, pos) << (quant_bit * j)) & M32
    hashes = torch.where(emit, hash64_u32(acc & mask), 0)
    return hashes, emit, newest, oldest.to(torch.int32), cnt.to(torch.int32)


def sketch_events_batch(events: torch.Tensor, n_events: torch.Tensor, *,
                        e: int, q: int, lq: int) -> SeedBatch:
    """Plain-mode sketching: one seed per kept event once ``e`` events
    are packed; its position is the newest event. Runs the CUDA kernel
    for CUDA tensors and the plain scan for CPU tensors."""
    from rawalign_tpu_torch.seeds import sketch_cuda

    hashes, emit, newest, _oldest, _cnt = sketch_cuda.sketch_scan(
        events, n_events, e=e, q=q, lq=lq
    )
    return SeedBatch(hashes=hashes, qpos=newest, valid=emit)


def sketch_events_min_batch(events: torch.Tensor, n_events: torch.Tensor, *,
                            w: int, e: int, q: int, lq: int) -> SeedBatch:
    """Minimizer-window sketching with the JAX package's set semantics
    (its ``sketch_events_min_batch``; ri_sketch_min, rsketch.c:146-221):
    a seed is kept iff its hash equals the minimum of at least one window
    of ``w`` consecutive seeds covering it. Its position is the OLDEST
    event of its ``e``-window (min-mode's buffer, rsketch.c:184-190).

    The scan is the same as plain mode's (CUDA kernel or plain scan by
    the tensor's device); the window filter after it is a few vector
    passes of width NE on the same device. The JAX scatter-min is
    ``scatter_reduce_(..., "amin")`` on int64 holding uint32, with
    ``0xFFFFFFFF`` as the empty-slot sentinel."""
    from rawalign_tpu_torch.seeds import sketch_cuda

    hashes, emit, _newest, oldest, cnt = sketch_cuda.sketch_scan(
        events, n_events, e=e, q=q, lq=lq
    )
    B, NE = hashes.shape
    big = torch.full((B, NE), M32, dtype=torch.int64, device=hashes.device)
    h = torch.where(emit, hashes, big)
    # compact the seeds by emission rank, so that "w consecutive seeds"
    # is a contiguous window of columns
    rank = torch.where(emit, cnt.to(torch.int64) - e, 0)
    comp = big.clone().scatter_reduce_(
        1, torch.where(emit, rank, NE - 1), h, "amin"
    )
    # wmin[r] = min over compact ranks r-w+1 .. r
    wmin = comp
    for d in range(1, w):
        wmin = torch.minimum(wmin, torch.cat([big[:, :d], comp[:, :-d]], dim=1))
    # the seed at rank r is a minimizer iff comp[r] == wmin[r'] for some
    # r' in r .. r+w-1
    is_min = torch.zeros((B, NE), dtype=torch.bool, device=hashes.device)
    for d in range(w):
        is_min |= comp == torch.cat([wmin[:, d:], big[:, :d]], dim=1)
    picked = emit & (is_min & (comp != M32)).gather(1, rank)
    return SeedBatch(hashes=hashes, qpos=oldest.to(torch.int64), valid=picked)
