"""Wrapper of the event-detection CUDA kernel (``csrc/event_detect.cu``).

Port of rawalign_tpu/signal/events_pallas.py (with the compaction, event
means and z-norm of rawalign_tpu/signal/events.py). :func:`detect_events`
runs the kernel on CUDA tensors and the plain PyTorch version
(``signal/events.py:detect_events_plain``) on CPU tensors; any other
device raises. ``launches`` counts kernel launches; :func:`reruns` reads
the kernel's own count of the peak machine's chunks that ran again, and
of the rounds of such runs. Under the NaN guard
(``runtime.set_debug_nans``) each row's live samples and events are
checked for NaN on either device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rawalign_tpu_torch import runtime
from rawalign_tpu_torch.kernels import build
from rawalign_tpu_torch.signal import events

#: shared memory a block may use on Hopper (bytes). A block keeps five
#: rows of ``_row_words(L)`` floats there (prefix sums; sums of squares,
#: then the short detector's record and the peak list; the staged
#: samples, then the short t row and the long detector's peaks; the long
#: t row, then the event means; the short detector's peaks), or in a
#: device buffer when they do not fit
MAX_SMEM = 232448
#: bytes of the kernel's static shared memory, rounded up (the end state
#: of each of a detector's 256 chunks, per-warp peak counts, the two
#: z-norm sums)
_STATIC_SMEM = 6144

launches = 0


@functools.cache
def _entry():
    fn = build.load("event_detect").ra_event_detect
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    i64 = ctypes.c_int64
    fn.argtypes = [i, p, i64, p, i, i, i, i, f, f, f, i, p, i64, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def reruns(device: torch.device, reset: bool = True) -> tuple[int, int]:
    """(chunks of the peak machine run again, rounds of such runs) over
    all launches on ``device`` since the last reset, summed over rows and
    over both detectors. Waits for the device."""
    fn = build.load("event_detect").ra_event_reruns
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = (ctypes.c_uint64 * 2)()
    with torch.cuda.device(device):
        build.check(fn(device.index, out, int(reset)), "ra_event_reruns")
    return int(out[0]), int(out[1])


def _row_words(L: int) -> int:
    """Words of one scratch row: L + 1 rounded up to a multiple of 4."""
    return (L + 4) & ~3


def detect_events(sig: torch.Tensor, length: torch.Tensor, *, w1: int,
                  w2: int, threshold1: float, threshold2: float,
                  peak_height: float, max_events: int) -> events.EventBatch:
    """Events of each row of ``sig`` (B, L) float32 (unit column stride)
    over its first ``length`` (B,) int32 samples: the outputs of
    ``events.detect_events_plain``."""
    kw = dict(w1=w1, w2=w2, threshold1=threshold1, threshold2=threshold2,
              peak_height=peak_height, max_events=max_events)
    runtime.check_finite("detect_events input", sig, lengths=length)
    if sig.device.type == "cpu":
        ev = events.detect_events_plain(sig, length, **kw)
    else:
        ev = _launch(sig, length, **kw)
    runtime.check_finite("detect_events output", ev.values, lengths=ev.n_events)
    return ev


def _launch(sig: torch.Tensor, length: torch.Tensor, *, w1: int, w2: int,
            threshold1: float, threshold2: float, peak_height: float,
            max_events: int) -> events.EventBatch:
    """The kernel's launch for :func:`detect_events`."""
    global launches
    if sig.device.type != "cuda":
        raise ValueError(f"detect_events: unsupported device {sig.device}")
    if sig.dtype != torch.float32 or sig.dim() != 2 or (
            sig.shape[1] > 1 and sig.stride(1) != 1):
        raise ValueError("detect_events: sig must be a 2-D float32 tensor "
                         "with unit column stride")
    B, L = sig.shape
    if (length.device != sig.device or length.dtype != torch.int32
            or tuple(length.shape) != (B,) or not length.is_contiguous()):
        raise ValueError("detect_events: length must be contiguous int32 (B,) "
                         "on the signal's device")
    if max_events < 0:
        raise ValueError(f"detect_events: max_events={max_events}")
    dev = sig.device
    values = torch.empty((B, max_events), dtype=torch.float32, device=dev)
    n_events = torch.empty(B, dtype=torch.int32, device=dev)
    n_dropped = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        smem = 20 * _row_words(L)
        scratch = None
        if smem + _STATIC_SMEM > MAX_SMEM:
            scratch = torch.empty(B * 5 * _row_words(L), dtype=torch.float32,
                                  device=dev)
            smem = 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the entry point sets the thread's current device; the guard
        # gives the caller's back
        with torch.cuda.device(dev):
            err = _entry()(
                dev.index, sig.data_ptr(), sig.stride(0), length.data_ptr(), B,
                L, w1, w2, threshold1, threshold2, peak_height, max_events,
                None if scratch is None else scratch.data_ptr(), smem,
                values.data_ptr(), n_events.data_ptr(), n_dropped.data_ptr(),
                stream,
            )
        build.check(err, "ra_event_detect")
        launches += 1
    return events.EventBatch(values=values, n_events=n_events,
                             n_dropped=n_dropped)
