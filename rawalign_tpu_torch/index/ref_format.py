"""Copy of rawalign_tpu/index/ref_format.py for the port.

Reader/writer for the reference binary index format (magic "RI").

Lets users of the reference implementation reuse indexes built with its
``rawalign -d ref.ind`` (and go the other way). Format per
rawindex.cpp:275-377:

  "RI" | int32 pars[8] = {w, e, n, q, lq, k, n_seq, flag}
  per sequence: u8 name_len, name, u32 len,
                float32 fwd_signal[len], float32 rev_signal[len]
                (len is the BP length; only len-k+1 leading values are
                meaningful signal, the tail is uninitialized in the
                reference's own dumps)
  per bucket (2^14): u32 n, u64 p[n], u32 size, size x (u64 key, u64 val)
    full_hash = (key >> 1) << 14 | bucket_index
    key & 1   = singleton flag: val is the y value directly; otherwise
                val = start << 32 | count into p (ys sorted ascending)

The reference's "forward_signals" are the strand-1 (reverse-complement
iteration) signals (rawindex.cpp:141-147) and map to signals_s1 here.
"""

from __future__ import annotations

import struct

import numpy as np

from rawalign_tpu_torch.config import IndexOptions
from rawalign_tpu_torch.index.index import RawIndex

MAGIC = b"RI"
B_BITS = 14  # fixed by the reference loader (rawindex.cpp:330)


def load_reference_index(path: str) -> RawIndex:
    with open(path, "rb") as f:
        if f.read(2) != MAGIC:
            raise ValueError(f"{path}: not a reference 'RI' index")
        pars = struct.unpack("<8i", f.read(32))
        w, e, n, q, lq, k, n_seq, flag = pars
        opt = IndexOptions(b=B_BITS, w=w, e=e, n=n, q=q, lq=lq, k=k, flag=flag)
        names: list[str] = []
        seq_lens = np.zeros(n_seq, dtype=np.uint32)
        sig_lens = np.zeros(n_seq, dtype=np.uint32)
        sigs1: list[np.ndarray] = []
        sigs0: list[np.ndarray] = []
        for i in range(n_seq):
            (l,) = struct.unpack("<B", f.read(1))
            name = f.read(l).decode() if l else ""
            (length,) = struct.unpack("<I", f.read(4))
            fwd = np.frombuffer(f.read(4 * length), dtype=np.float32)
            rev = np.frombuffer(f.read(4 * length), dtype=np.float32)
            names.append(name)
            seq_lens[i] = length
            sig_len = max(length - k + 1, 0)
            sig_lens[i] = sig_len
            sigs1.append(fwd[:sig_len].copy())
            sigs0.append(rev[:sig_len].copy())
        key_blocks: list[np.ndarray] = []
        y_blocks: list[np.ndarray] = []
        for bucket in range(1 << B_BITS):
            (bn,) = struct.unpack("<I", f.read(4))
            p = np.frombuffer(f.read(8 * bn), dtype=np.uint64)
            (size,) = struct.unpack("<I", f.read(4))
            if size == 0:
                continue
            kv = np.frombuffer(f.read(16 * size), dtype=np.uint64).reshape(
                size, 2
            )
            keys = kv[:, 0]
            vals = kv[:, 1]
            singleton = (keys & np.uint64(1)) != 0
            full_hash = ((keys >> np.uint64(1)) << np.uint64(B_BITS)) | np.uint64(
                bucket
            )
            # singletons: val is y
            key_blocks.append(full_hash[singleton].astype(np.uint32))
            y_blocks.append(vals[singleton])
            # multi-hit: val = start<<32 | count into p
            multi = ~singleton
            starts = (vals[multi] >> np.uint64(32)).astype(np.int64)
            counts = (vals[multi] & np.uint64(0xFFFFFFFF)).astype(np.int64)
            mh = full_hash[multi].astype(np.uint32)
            for h, s, c in zip(mh, starts, counts):
                key_blocks.append(np.full(c, h, dtype=np.uint32))
                y_blocks.append(p[s : s + c])
    if key_blocks:
        keys = np.concatenate(key_blocks)
        ys = np.concatenate(y_blocks)
    else:
        keys = np.zeros(0, np.uint32)
        ys = np.zeros(0, np.uint64)
    order = np.lexsort((ys, keys))
    keys = keys[order]
    ys = ys[order]
    offsets = np.zeros(n_seq + 1, dtype=np.int64)
    np.cumsum(sig_lens, out=offsets[1:])
    return RawIndex(
        opt=opt,
        seq_names=names,
        seq_lens=seq_lens,
        sig_lens=sig_lens,
        sig_offsets=offsets,
        signals_s1=np.concatenate(sigs1) if sigs1 else np.zeros(0, np.float32),
        signals_s0=np.concatenate(sigs0) if sigs0 else np.zeros(0, np.float32),
        keys=keys,
        val_id=(ys >> np.uint64(32)).astype(np.uint32),
        val_ps=(ys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )


def dump_reference_index(idx: RawIndex, path: str) -> None:
    """Write a RawIndex in the reference binary format."""
    opt = idx.opt
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(
            struct.pack(
                "<8i",
                opt.w,
                opt.e,
                opt.n,
                opt.q,
                opt.lq,
                opt.k,
                idx.n_seq,
                opt.flag,
            )
        )
        signals = idx.signals
        for i, name in enumerate(idx.seq_names):
            nb = name.encode()[:255]
            f.write(struct.pack("<B", len(nb)))
            f.write(nb)
            length = int(idx.seq_lens[i])
            f.write(struct.pack("<I", length))
            for arr in (signals[1][i], signals[0][i]):
                buf = np.zeros(length, dtype=np.float32)
                buf[: arr.size] = arr
                f.write(buf.tobytes())
        # rebuild per-bucket layout from the flat sorted table
        mask = np.uint32((1 << B_BITS) - 1)
        buckets = idx.keys & mask
        ys = (idx.val_id.astype(np.uint64) << np.uint64(32)) | idx.val_ps.astype(
            np.uint64
        )
        order = np.argsort(buckets, kind="stable")
        sorted_buckets = buckets[order]
        bounds = np.searchsorted(
            sorted_buckets, np.arange((1 << B_BITS) + 1, dtype=np.uint32)
        )
        for bucket in range(1 << B_BITS):
            sel = order[bounds[bucket] : bounds[bucket + 1]]
            if sel.size == 0:
                f.write(struct.pack("<II", 0, 0))
                continue
            bkeys = idx.keys[sel]
            bys = ys[sel]
            # group by hash (table already hash-major; sel preserves it)
            uniq, starts_u, counts_u = np.unique(
                bkeys, return_index=True, return_counts=True
            )
            p_list = []
            kv = []
            p_off = 0
            for h, s, c in zip(uniq, starts_u, counts_u):
                key = (np.uint64(h) >> np.uint64(B_BITS)) << np.uint64(1)
                if c == 1:
                    kv.append((key | np.uint64(1), bys[s]))
                else:
                    grp = np.sort(bys[s : s + c])
                    p_list.append(grp)
                    kv.append(
                        (key, (np.uint64(p_off) << np.uint64(32)) | np.uint64(c))
                    )
                    p_off += c
            p_arr = (
                np.concatenate(p_list) if p_list else np.zeros(0, np.uint64)
            )
            f.write(struct.pack("<I", p_arr.size))
            f.write(p_arr.tobytes())
            f.write(struct.pack("<I", len(kv)))
            for key, val in kv:
                f.write(struct.pack("<QQ", int(key), int(val)))
