"""Copy of rawalign_tpu/golden/index.py for the port.

Index golden model (reference: src/rawindex.{h,cpp}).

The reference stores seeds in 2^14 buckets, each a khash of
hash -> (offset, count) into a position array sorted by position value
(rawindex.cpp:194-246). This golden model (and the production index) keeps
one sorted table of (hash, y) pairs — sorted by hash then y — which yields
exactly the reference's query results: ``get(hash)`` returns all y values
for that hash in ascending y order (the reference radix-sorts each hash's
positions by y, rawindex.cpp:233).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rawalign_tpu_torch.config import IndexOptions
from rawalign_tpu_torch.golden import sketch as gsketch
from rawalign_tpu_torch.io.fasta import Sequence
from rawalign_tpu_torch.signal import seq2sig


@dataclasses.dataclass
class GoldenIndex:
    """In-memory index: sorted seed table + per-sequence expected signals."""

    opt: IndexOptions
    seq_names: list[str]
    seq_lens: np.ndarray  # uint32 (n_seq,) — base-pair lengths
    sig_lens: np.ndarray  # uint32 (n_seq,) — signal lengths (len - k + 1)
    # Expected signals per sequence; index 1 = reference's "forward_signals"
    # (strand-1 / reverse-complement iteration), index 0 = "reverse_signals"
    # (strand-0 / forward iteration). See rawindex.cpp:141-148.
    signals: dict[int, list[np.ndarray]]
    keys: np.ndarray  # uint64 sorted hash per seed
    vals: np.ndarray  # uint64 y = id<<32 | pos<<1 | strand, grouped by key

    @property
    def n_seq(self) -> int:
        return len(self.seq_names)

    def get(self, hashval: int) -> np.ndarray:
        """All y values for a seed hash (ri_idx_get, rawindex.cpp:256-273)."""
        lo = np.searchsorted(self.keys, np.uint64(hashval), side="left")
        hi = np.searchsorted(self.keys, np.uint64(hashval), side="right")
        return self.vals[lo:hi]


def build_index(
    seqs: list[Sequence], pore_vals: np.ndarray, opt: IndexOptions
) -> GoldenIndex:
    """Build the index from sequences (ri_idx_gen, rawindex.cpp:99-181,
    405-420): per sequence, convert to expected signal on both strands and
    sketch each; then sort all seeds."""
    names: list[str] = []
    lens: list[int] = []
    sig_lens: list[int] = []
    signals: dict[int, list[np.ndarray]] = {0: [], 1: []}
    seed_blocks: list[np.ndarray] = []
    for rid, s in enumerate(seqs):
        names.append(s.name)
        lens.append(len(s.seq))
        codes = seq2sig.seq_to_codes(s.seq)
        # strand 1 first, as the reference does (rawindex.cpp:141-147)
        sig1 = seq2sig.seq_to_sig(codes, pore_vals, opt.k, 1)
        sig0 = seq2sig.seq_to_sig(codes, pore_vals, opt.k, 0)
        signals[1].append(sig1)
        signals[0].append(sig0)
        sig_lens.append(sig1.size)
        if sig1.size:
            seed_blocks.append(
                gsketch.sketch(sig1, rid, 1, opt.w, opt.e, opt.n, opt.q, opt.lq, opt.k)
            )
        if sig0.size:
            seed_blocks.append(
                gsketch.sketch(sig0, rid, 0, opt.w, opt.e, opt.n, opt.q, opt.lq, opt.k)
            )
    if seed_blocks:
        seeds = np.concatenate(seed_blocks, axis=0)
    else:
        seeds = np.zeros((0, 2), dtype=np.uint64)
    hashes = seeds[:, 0] >> np.uint64(gsketch.RI_HASH_SHIFT)
    ys = seeds[:, 1]
    order = np.lexsort((ys, hashes))
    return GoldenIndex(
        opt=opt,
        seq_names=names,
        seq_lens=np.asarray(lens, dtype=np.uint32),
        sig_lens=np.asarray(sig_lens, dtype=np.uint32),
        signals=signals,
        keys=hashes[order],
        vals=ys[order],
    )
