"""Wrapper of the chaining-DP CUDA kernel (``csrc/chain_dp.cu``).

Port of rawalign_tpu/map/chain_pallas.py. :func:`chain_dp` runs the
kernel on CUDA tensors: two launches, the window pass (a warp per
anchor, each window's score-free part into a record) and the recurrence
(a block per read, a warp per independent run of its anchors);
``map/chain.py:chain_dp_runs_plain`` is its split of the rows and
``chain_dp_scan_plain`` its step, in plain PyTorch. On CPU tensors it
runs the plain PyTorch version (``map/chain.py:chain_dp_plain``); any
other device raises. ``launches`` counts kernel launches: two a call.
Under the NaN guard (``runtime.set_debug_nans``) each row's live scores
are checked for NaN on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rawalign_tpu_torch import runtime
from rawalign_tpu_torch.kernels import build
from rawalign_tpu_torch.map import chain

#: shared memory a block may use on Hopper (bytes); each warp of a block
#: keeps a ring of seg/target/query/score of the last W anchors and the
#: next 64 (16 bytes a slot, a power of two of at least min(W, A) + 64
#: slots) there beside the block's job tables, as many warps as fit up to
#: WARPS, and in a device buffer (WARPS rings a block) when fewer than two
#: fit
MAX_SMEM = 232448
#: static shared memory of a block: the job tables and the record stages
#: (``RA_TABLE_BYTES + 1024 * RA_MAX_WARPS`` in ``csrc/chain_dp.cu``)
TABLE_BYTES = 1024 * 12 + 8 + 1024 * 8
#: warps a block (``RA_MAX_WARPS``)
WARPS = 8

launches = 0


@functools.cache
def _entry():
    fn = build.load("chain_dp").ra_chain_dp
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def geometry(window: int, A: int) -> tuple[int, int, bool]:
    """(ring slots a warp, warps a block, rings in shared memory) of a
    launch: the ring a power of two of at least min(window, A) + 64; a
    block has at least two warps, so every window splits its rows."""
    ring = 1
    while ring < min(window, A) + 64:
        ring *= 2
    warps = min(WARPS, (MAX_SMEM - TABLE_BYTES) // (16 * ring))
    return (ring, warps, True) if warps >= 2 else (ring, WARPS, False)


def chain_dp(seg: torch.Tensor, target: torch.Tensor, query: torch.Tensor,
             n_anchors: torch.Tensor, *, window: int, e: int, max_gap: int,
             max_target_gap: int, max_skips: int) -> chain.ChainScores:
    """Scores and predecessors (B, A) of ``chain.chain_dp_plain``."""
    kw = dict(window=window, e=e, max_gap=max_gap,
              max_target_gap=max_target_gap, max_skips=max_skips)
    if seg.device.type == "cpu":
        dp = chain.chain_dp_plain(seg, target, query, n_anchors, **kw)
    else:
        dp = _launch(seg, target, query, n_anchors, **kw)
    runtime.check_finite("chain_dp output", dp.scores, lengths=n_anchors)
    return dp


def _launch(seg: torch.Tensor, target: torch.Tensor, query: torch.Tensor,
            n_anchors: torch.Tensor, *, window: int, e: int, max_gap: int,
            max_target_gap: int, max_skips: int) -> chain.ChainScores:
    """The kernel's launch for :func:`chain_dp`."""
    global launches
    if seg.device.type != "cuda":
        raise ValueError(f"chain_dp: unsupported device {seg.device}")
    if seg.dim() != 2:
        raise ValueError("chain_dp: seg must be (B, A)")
    B, A = seg.shape
    for name, x in (("seg", seg), ("target", target), ("query", query)):
        if (x.device != seg.device or x.dtype != torch.int32
                or tuple(x.shape) != (B, A) or not x.is_contiguous()):
            raise ValueError(f"chain_dp: {name} must be contiguous int32 "
                             f"({B}, {A}) on {seg.device}")
    if (n_anchors.device != seg.device or n_anchors.dtype != torch.int32
            or tuple(n_anchors.shape) != (B,) or not n_anchors.is_contiguous()):
        raise ValueError("chain_dp: n_anchors must be contiguous int32 (B,)")
    if window < 0:
        raise ValueError(f"chain_dp: window={window} must be >= 0")
    ring, warps, in_smem = geometry(window, A)
    dev = seg.device
    scores = torch.empty((B, A), dtype=torch.float32, device=dev)
    preds = torch.empty((B, A), dtype=torch.int32, device=dev)
    if B and A:
        # each anchor's window record (the first launch writes, the
        # second reads); rings beyond shared memory live in device
        # memory, one per warp
        rec = torch.empty((B, A, 4), dtype=torch.int32, device=dev)
        gring = (None if in_smem else torch.empty(
            (B, warps * 4 * ring), dtype=torch.int32, device=dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the entry point sets the thread's current device; the guard
        # gives the caller's back
        with torch.cuda.device(dev):
            err = _entry()(
                dev.index, seg.data_ptr(), target.data_ptr(), query.data_ptr(),
                n_anchors.data_ptr(), B, A, window, ring, warps, e, max_gap,
                max_target_gap, max_skips, rec.data_ptr(), scores.data_ptr(),
                preds.data_ptr(), None if gring is None else gring.data_ptr(),
                stream,
            )
        build.check(err, "ra_chain_dp")
        launches += 2
    return chain.ChainScores(scores=scores, preds=preds)
