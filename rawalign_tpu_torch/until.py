"""Copy of rawalign_tpu/until.py for the port.

Sequence Until: adaptive relative-abundance early stop.

Reference: src/sequence_until.{h,c} + the pipeline hook rmap.cpp:918-944.
Accumulates per-reference mapped fragment lengths; every ``ttest_freq``
mapped reads (after ``tmin_reads``) it snapshots the relative-abundance
vector into a ring of ``tn_samples`` estimates and computes the maximum
pairwise squared distance to estimate 0 (find_outlier,
sequence_until.c:4-18); when that falls to or below ``t_threshold`` the
abundance estimate has converged and sequencing can stop.
"""

from __future__ import annotations

import numpy as np

from rawalign_tpu_torch.config import MappingOptions


def find_outlier(estimates: np.ndarray) -> float:
    """Greedy max pairwise squared distance (sequence_until.c:4-18): each
    row is compared against the current outlier row (initially row 0,
    updated whenever a farther row is found)."""
    x = np.asarray(estimates, dtype=np.float32)
    outlier = 0
    max_dist = 0.0
    for i in range(x.shape[0]):
        dist = float(np.sum((x[i] - x[outlier]) ** 2))
        if dist > max_dist:
            max_dist = dist
            outlier = i
    return max_dist


class SequenceUntil:
    """Streaming estimator; feed mapped reads, poll .stopped."""

    def __init__(self, n_seq: int, opt: MappingOptions):
        self.opt = opt
        self.n_seq = n_seq
        self.counts = np.zeros(n_seq, dtype=np.uint64)
        self.ab_count = 0
        self.n_reads = 0
        self.cur = 0
        self.n_estimations = 0
        self.estimates = np.zeros((opt.tn_samples, n_seq), dtype=np.float32)
        self.stopped = False

    def add_mapped_read(self, ref_id: int, fragment_length: int) -> bool:
        """Account one mapped read; returns True if the stop signal fires
        (rmap.cpp:920-941)."""
        if self.stopped:
            return True
        self.counts[ref_id] += np.uint64(fragment_length)
        self.ab_count += fragment_length
        self.n_reads += 1
        if (
            self.n_reads > self.opt.tmin_reads
            and self.n_reads % self.opt.ttest_freq == 0
        ):
            # (float)count / ab_count is a float32 division in the
            # reference (rmap.cpp:927)
            self.estimates[self.cur] = self.counts.astype(
                np.float32
            ) / np.float32(self.ab_count)
            self.cur += 1
            if self.cur >= self.opt.tn_samples:
                self.cur = 0
            # post-increment compare (rmap.cpp:933 `su_nestimations++ >=
            # tn_samples`): the outlier test first runs on the
            # (tn_samples+1)-th estimation, not the tn_samples-th
            n_est_before = self.n_estimations
            self.n_estimations += 1
            if n_est_before >= self.opt.tn_samples:
                if find_outlier(self.estimates) <= self.opt.t_threshold:
                    self.stopped = True
        return self.stopped

    @property
    def abundance(self) -> np.ndarray:
        """Current relative-abundance estimate."""
        total = max(self.ab_count, 1)
        return self.counts.astype(np.float64) / total
