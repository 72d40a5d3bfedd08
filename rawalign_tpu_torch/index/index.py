"""Copy of rawalign_tpu/index/index.py for the port.

The seed index: build (host), query (device), serialization.

TPU-first redesign of the reference's bucketed khash index
(src/rawindex.cpp:194-273): one flat table of all seeds sorted by
(hash, y), queried with vectorized binary search + bounded gather. This
replaces pointer-chasing hash lookups with two ``searchsorted`` passes and
a contiguous gather — bandwidth-friendly and fully batched, and it
produces the reference's exact hit lists in the same order (the reference
radix-sorts each hash's positions by y, rawindex.cpp:233).

Device layout (all uint32/int32 — TPUs have no native 64-bit int):
  keys   (S,)  uint32  sorted seed hashes
  val_id (S,)  uint32  target sequence id
  val_ps (S,)  uint32  pos<<1 | strand

The index also carries the full per-sequence expected signal arrays,
concatenated with per-sequence offsets (the reference stores them per
sequence, rawindex.h:32-34) — required by the DTW chain evaluation.

On-disk format: a single .npz (RAWALIGN_TPU_IDX v1) holding the tables,
the signals and the build parameters (the reference embeds w,e,q,lq,k in
its binary dump too, rawindex.cpp:277-282).

:func:`index_from` carries an index built elsewhere (the JAX package's,
in the tests) into this class.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rawalign_tpu_torch.config import IndexOptions, options_from
from rawalign_tpu_torch.golden import sketch as gsketch
from rawalign_tpu_torch.io.fasta import Sequence
from rawalign_tpu_torch.signal import seq2sig

MAGIC = "RAWALIGN_TPU_IDX_V1"


@dataclasses.dataclass
class RawIndex:
    """Host-resident index; .device() uploads the query tables."""

    opt: IndexOptions
    seq_names: list[str]
    seq_lens: np.ndarray  # (n_seq,) uint32 bp lengths
    sig_lens: np.ndarray  # (n_seq,) uint32 signal lengths
    sig_offsets: np.ndarray  # (n_seq+1,) int64 offsets into concat signals
    # concatenated expected signals; index by strand bit (1 = the
    # reference's "forward_signals" built with strand-1 conversion)
    signals_s1: np.ndarray  # float32 (total_sig,)
    signals_s0: np.ndarray  # float32 (total_sig,)
    keys: np.ndarray  # (S,) uint32 sorted
    val_id: np.ndarray  # (S,) uint32
    val_ps: np.ndarray  # (S,) uint32  pos<<1|strand

    @property
    def n_seq(self) -> int:
        return len(self.seq_names)

    # ---- golden-compatible accessors (used by the golden engine/tests)
    @property
    def signals(self):
        out = {0: [], 1: []}
        for i in range(self.n_seq):
            lo, hi = self.sig_offsets[i], self.sig_offsets[i + 1]
            out[0].append(self.signals_s0[lo:hi])
            out[1].append(self.signals_s1[lo:hi])
        return out

    def get(self, hashval: int) -> np.ndarray:
        """All y values for a hash, ascending (ri_idx_get semantics)."""
        h = np.uint32(hashval)
        lo = np.searchsorted(self.keys, h, side="left")
        hi = np.searchsorted(self.keys, h, side="right")
        return (
            (self.val_id[lo:hi].astype(np.uint64) << np.uint64(32))
            | self.val_ps[lo:hi].astype(np.uint64)
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            magic=np.array(MAGIC),
            params=np.array(
                [
                    self.opt.b,
                    self.opt.w,
                    self.opt.e,
                    self.opt.n,
                    self.opt.q,
                    self.opt.lq,
                    self.opt.k,
                    self.opt.flag,
                ],
                dtype=np.int64,
            ),
            seq_names=np.array(self.seq_names),
            seq_lens=self.seq_lens,
            sig_lens=self.sig_lens,
            sig_offsets=self.sig_offsets,
            signals_s1=self.signals_s1,
            signals_s0=self.signals_s0,
            keys=self.keys,
            val_id=self.val_id,
            val_ps=self.val_ps,
        )

    @staticmethod
    def load(path: str) -> "RawIndex":
        z = np.load(path, allow_pickle=False)
        if str(z["magic"]) != MAGIC:
            raise ValueError(f"{path}: not a {MAGIC} index")
        p = z["params"]
        opt = IndexOptions(
            b=int(p[0]),
            w=int(p[1]),
            e=int(p[2]),
            n=int(p[3]),
            q=int(p[4]),
            lq=int(p[5]),
            k=int(p[6]),
            flag=int(p[7]),
        )
        return RawIndex(
            opt=opt,
            seq_names=[str(s) for s in z["seq_names"]],
            seq_lens=z["seq_lens"],
            sig_lens=z["sig_lens"],
            sig_offsets=z["sig_offsets"],
            signals_s1=z["signals_s1"],
            signals_s0=z["signals_s0"],
            keys=z["keys"],
            val_id=z["val_id"],
            val_ps=z["val_ps"],
        )


def index_from(other) -> RawIndex:
    """A ``RawIndex`` holding the arrays of ``other`` (any object with this
    class's fields, such as the JAX package's index; the arrays are
    shared, not copied) and a copy of its options."""
    arrays = ("seq_lens", "sig_lens", "sig_offsets", "signals_s1",
              "signals_s0", "keys", "val_id", "val_ps")
    return RawIndex(
        opt=options_from(other.opt),
        seq_names=list(other.seq_names),
        **{k: np.asarray(getattr(other, k)) for k in arrays},
    )


def _build_seq(rid, seq, pore_vals, opt, use_native):
    """Signals + sorted packed seeds for one sequence (one parallel job;
    replaces steps 1-2 of the reference's ri_idx_gen pipeline,
    rawindex.cpp:128-179)."""
    from rawalign_tpu_torch import native

    codes = seq2sig.seq_to_codes(seq)

    def strand_job(strand):
        sig = seq2sig.seq_to_sig(codes, pore_vals, opt.k, strand)
        if not sig.size:
            return sig, None, None
        if use_native:
            if opt.w:
                h, p = native.sketch_min(sig, opt.w, opt.e, opt.q, opt.lq)
            else:
                h, p = native.sketch_reg(sig, opt.e, opt.q, opt.lq)
        else:
            seeds = gsketch.sketch(
                sig, rid, strand, opt.w, opt.e, opt.n, opt.q, opt.lq, opt.k
            )
            h = (seeds[:, 0] >> np.uint64(gsketch.RI_HASH_SHIFT)).astype(
                np.uint32
            )
            p = (
                (seeds[:, 1] & np.uint64(0xFFFFFFFF))
                >> np.uint64(gsketch.RI_POS_SHIFT)
            ).astype(np.int64)
        ps = (p.astype(np.uint32) << np.uint32(1)) | np.uint32(strand)
        return sig, h.astype(np.uint32), ps

    if len(codes) > 1_000_000:
        # long sequences: the two strands in parallel (numpy + the
        # native sketcher release the GIL)
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            f1 = pool.submit(strand_job, 1)
            f0 = pool.submit(strand_job, 0)
            (sig1, h1, ps1), (sig0, h0, ps0) = f1.result(), f0.result()
    else:
        sig1, h1, ps1 = strand_job(1)
        sig0, h0, ps0 = strand_job(0)
    hs = [h for h in (h1, h0) if h is not None]
    pss = [p for p in (ps1, ps0) if p is not None]
    if hs:
        h = np.concatenate(hs) if len(hs) > 1 else hs[0]
        ps = np.concatenate(pss) if len(pss) > 1 else pss[0]
        # ONE radix sort of (hash << 32 | pos<<1|strand) replaces this
        # sequence's share of the global 3-key lexsort: within a hash the
        # y order is ascending exactly like the reference's per-bucket
        # radix sort (rawindex.cpp:233). (hash, ps) pairs are unique per
        # sequence, so plain sort order == (hash, id, ps) order.
        if use_native and native.pack_seeds_available():
            packed = native.pack_seeds(h, ps)  # one pass vs three
        else:
            packed = (h.astype(np.uint64) << np.uint64(32)) | ps.astype(
                np.uint64
            )
        packed.sort(kind="stable")  # radix for integer dtypes
    else:
        packed = np.zeros(0, np.uint64)
    return sig1, sig0, packed


def build_index(
    seqs: list[Sequence], pore_vals: np.ndarray, opt: IndexOptions,
    n_threads: int | None = None,
) -> RawIndex:
    """Host-side index build (replaces ri_idx_gen + ri_idx_post,
    rawindex.cpp:99-250): per sequence (in a thread pool — NumPy and the
    native sketcher release the GIL, matching the reference's 3-step
    kt_pipeline + kt_for build parallelism), expected-signal conversion
    on both strands + sketching + a per-sequence packed radix sort; a
    single stable merge pass by hash replaces ri_idx_post for multi-
    sequence references (stability preserves the per-sequence (id, ps)
    order within equal hashes)."""
    import concurrent.futures
    import os

    from rawalign_tpu_torch import native

    use_native = native.available()
    if n_threads is None:
        n_threads = min(max(os.cpu_count() or 1, 1), 16)
    names = [s.name for s in seqs]
    lens = [len(s.seq) for s in seqs]
    if len(seqs) > 1 and n_threads > 1:
        with concurrent.futures.ThreadPoolExecutor(n_threads) as pool:
            results = list(
                pool.map(
                    lambda a: _build_seq(
                        a[0], a[1].seq, pore_vals, opt, use_native
                    ),
                    enumerate(seqs),
                )
            )
    else:
        results = [
            _build_seq(rid, s.seq, pore_vals, opt, use_native)
            for rid, s in enumerate(seqs)
        ]
    sigs1 = [r[0] for r in results]
    sigs0 = [r[1] for r in results]
    sig_lens = [r[0].size for r in results]
    packs = [r[2] for r in results]
    sizes = np.array([p.size for p in packs], dtype=np.int64)
    if len(packs) == 1:
        packed = packs[0]
        v = packed.view(np.uint32)  # little-endian: [0::2]=low, [1::2]=hi
        keys = v[1::2].copy()
        ps_sorted = v[0::2].copy()
        ids_sorted = np.zeros(packed.size, np.uint32)
    elif packs:
        # merge the per-sequence sorted blocks: a stable sort by hash of
        # the concatenation keeps, within equal hashes, blocks in id
        # order and each block's ps order — i.e. (hash, id, ps).
        # This host is memory-bandwidth-bound, so the packing works on
        # little-endian u32 VIEWS in place of shift/astype passes.
        cat = np.concatenate(packs)
        assert cat.size < (1 << 32), "index > 2^32 seeds: shard the build"
        pack2 = cat.copy()
        v = pack2.view(np.uint32)
        v[0::2] = np.arange(cat.size, dtype=np.uint32)  # low word = index
        pack2.sort(kind="stable")
        v = pack2.view(np.uint32)
        order = v[0::2]
        keys = v[1::2].copy()
        ps_sorted = cat.view(np.uint32)[0::2][order]
        block_starts = np.zeros(len(packs) + 1, dtype=np.int64)
        np.cumsum(sizes, out=block_starts[1:])
        ids_sorted = (
            np.searchsorted(block_starts, order, side="right") - 1
        ).astype(np.uint32)
    else:
        keys = np.zeros(0, np.uint32)
        ids_sorted = np.zeros(0, np.uint32)
        ps_sorted = np.zeros(0, np.uint32)
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(sig_lens, out=offsets[1:])
    return RawIndex(
        opt=opt,
        seq_names=names,
        seq_lens=np.asarray(lens, dtype=np.uint32),
        sig_lens=np.asarray(sig_lens, dtype=np.uint32),
        sig_offsets=offsets,
        signals_s1=(
            np.concatenate(sigs1) if sigs1 else np.zeros(0, np.float32)
        ),
        signals_s0=(
            np.concatenate(sigs0) if sigs0 else np.zeros(0, np.float32)
        ),
        keys=keys,
        val_id=ids_sorted,
        val_ps=ps_sorted,
    )
