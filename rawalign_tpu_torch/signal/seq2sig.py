"""Copy of rawalign_tpu/signal/seq2sig.py for the port.

Reference sequence -> expected signal conversion.

Slides the pore-model k-mer over the sequence and z-normalizes the whole
per-sequence signal, reproducing reference src/rsig.cpp:7-41 exactly:

* ``strand == 0``: iterate the sequence forward, k-mer code
  ``(kmer << 2 | c) & mask``.
* ``strand == 1``: iterate the REVERSED sequence, complementing each base,
  k-mer code ``((kmer << 2) | (3 ^ c)) & mask``; the resulting coordinate
  system is reversed-complement space and maps to '-'-strand PAF output
  via ``len + 1 - end_position`` (rmap.cpp:753).
* Ambiguous bases shift in ``00`` on both strands (rsig.cpp:24).
* Emission starts once ``i + 1 >= k``; output length is ``len - k + 1``
  for ``len >= k``.
* Mean/stddev use float64 accumulators over float32 values (the C code's
  double sum/sum2 over float curval), final normalize in float32.

Note the reference's confusing naming: its "forward_signals" array is
built with ``strand=1`` (rawindex.cpp:141-143) and its "reverse_signals"
with ``strand=0``. We keep the *strand numbers* as the source of truth.

Implemented as vectorized NumPy (host; used by the index build and as the
golden model) and as a JAX function (device; used by tests of parity and
available to sharded index building).
"""

from __future__ import annotations

import numpy as np

from rawalign_tpu_torch.pore_model import SEQ_NT4


def seq_to_codes(seq: str) -> np.ndarray:
    """2-bit base codes with 4 for ambiguous, as uint8."""
    return SEQ_NT4[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def seq_to_sig(
    seq_codes: np.ndarray, pore_vals: np.ndarray, k: int, strand: int
) -> np.ndarray:
    """Expected-signal conversion for one sequence (float32, z-normalized).

    seq_codes: uint8 array of 2-bit codes (4 = ambiguous) in FORWARD
    sequence order; the strand-1 reversal happens internally, as in the
    reference.
    """
    codes = np.asarray(seq_codes)
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=np.float32)
    # int32 throughout: 4^k table indices fit easily (k <= 15) and the
    # rolling-OR passes below are memory-bound on long genomes
    if strand:
        codes = codes[::-1]
        eff = np.where(codes < 4, 3 ^ codes, 0).astype(np.int32)
    else:
        eff = np.where(codes < 4, codes, 0).astype(np.int32)

    # kmer[i] = sum_{j=0..k-1} eff[i-j] << (2*j)  for i in k-1..n-1
    kmers = np.zeros(n - k + 1, dtype=np.int32)
    for j in range(k):
        kmers <<= 2
        kmers |= eff[j : n - k + 1 + j]

    # Double-precision accumulators, as the reference (rsig.cpp:12,30-35).
    # The reference folds sequentially (`sum += curval`); np.sum's
    # pairwise summation rounds the low bits differently, which shifts
    # mean/std by ~1 ulp and flips a handful of normalized values per
    # megabase (visible only in --dtw-output-cigar per-element
    # differences) — so use the native order-exact left-fold when built.
    # The gather and the normalize also run in C single-pass when built:
    # at 50Mb the numpy fancy-index + float64-promoted normalize cost
    # ~8s/strand (three full-array passes), ~2/3 of the index build.
    from rawalign_tpu_torch import native

    if native.znorm_sums_available() and native.pore_gather_available():
        vals = native.pore_gather(kmers, pore_vals)
        # np.float64: python-float scalars are "weak" under NumPy 2
        # promotion and would drop a numpy normalize to float32
        s, s2 = (np.float64(x) for x in native.znorm_sums(vals))
        m = s / vals.size
        std = np.sqrt(s2 / vals.size - m * m)
        native.znorm_apply(vals, float(m), float(std))
        return vals
    vals = pore_vals[kmers].astype(np.float32)
    s = np.sum(vals, dtype=np.float64)
    s2 = np.sum(vals.astype(np.float64) ** 2)
    m = s / vals.size
    std = np.sqrt(s2 / vals.size - m * m)
    return ((vals - m) / std).astype(np.float32)


def ref_signals(
    seq_codes: np.ndarray, pore_vals: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """(strand1_signal, strand0_signal) for one reference sequence.

    strand1_signal corresponds to the reference's ``forward_signals``
    (rawindex.cpp:141) and strand0_signal to its ``reverse_signals``
    (rawindex.cpp:146).
    """
    return (
        seq_to_sig(seq_codes, pore_vals, k, 1),
        seq_to_sig(seq_codes, pore_vals, k, 0),
    )
