"""Wrapper of the chaining-DP CUDA kernel (``csrc/chain_dp.cu``).

Port of rawalign_tpu/map/chain_pallas.py. :func:`chain_dp` runs the
kernel (a warp per read; ``map/chain.py:chain_dp_scan_plain`` is its
formulation in plain PyTorch) on CUDA tensors and the plain PyTorch
version (``map/chain.py:chain_dp_plain``) on CPU tensors; any other
device raises. ``launches`` counts kernel launches. Under the NaN
guard (``runtime.set_debug_nans``) each row's live scores are checked
for NaN on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rawalign_tpu_torch import runtime
from rawalign_tpu_torch.kernels import build
from rawalign_tpu_torch.map import chain

#: shared memory a block may use on Hopper (bytes); a block keeps a ring
#: of seg/target/query/score of the last W anchors and the next 32 there
#: (16 bytes a slot, a power of two of at least min(W, A) + 32 slots) up
#: to min(W, A) = 8160, and in a device buffer beyond
MAX_SMEM = 232448

launches = 0


@functools.cache
def _entry():
    fn = build.load("chain_dp").ra_chain_dp
    p = ctypes.c_void_p
    i = ctypes.c_int
    fn.argtypes = [i, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


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
    ring = 1
    while ring < min(window, A) + 32:
        ring *= 2
    dev = seg.device
    scores = torch.empty((B, A), dtype=torch.float32, device=dev)
    preds = torch.empty((B, A), dtype=torch.int32, device=dev)
    if B and A:
        # a ring beyond shared memory lives in device memory, one per read
        gring = (torch.empty((B, 4 * ring), dtype=torch.int32, device=dev)
                 if 16 * ring > MAX_SMEM else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the entry point sets the thread's current device; the guard
        # gives the caller's back
        with torch.cuda.device(dev):
            err = _entry()(
                dev.index, seg.data_ptr(), target.data_ptr(), query.data_ptr(),
                n_anchors.data_ptr(), B, A, window, ring, e, max_gap,
                max_target_gap, max_skips, scores.data_ptr(), preds.data_ptr(),
                None if gring is None else gring.data_ptr(), stream,
            )
        build.check(err, "ra_chain_dp")
        launches += 1
    return chain.ChainScores(scores=scores, preds=preds)
