"""The batched mapping engine (port of rawalign_tpu/map/engine.py).

One mapping round of a group of ``batch_size`` read slots, on the
default hybrid path:

  host (native C)               device (PyTorch + CUDA kernels)
    detect events of the next
    chunk of every live read  ->  sketch (CUDA sketch scan), hits-first
                                  seed compaction, bucketed index lookup,
                                  event-history append; one packed output
    expand hits, chain DP,    <-
    chain records and DTW
    tile descriptors          ->  banded DTW on the descriptors (CUDA
                                  kernel; oversized tiles in host C)
    round finalize: B&B,      <-
    primary chains, MAPQ,
    decisions, carried anchors

The other placements, each selectable alone:

* ``stage1_impl="device"`` uploads the raw chunks and detects the events
  on the device (CUDA event kernel, the golden detector's semantics bit
  for bit, so the events equal the hybrid path's) before the same
  sketch/lookup body.
* ``stage1_impl="host"`` runs the whole stage1 on the host (native
  detector, native sketch, ``np.searchsorted`` on the sorted keys, the
  occurrence cap, no compaction); the round's only device work is the
  DTW.
* ``chain_impl="device"`` expands the anchors on the host, runs the
  chaining DP on the device (CUDA chain kernel; one upload, one fetch)
  and finishes the round in Python: traceback, DTW tile descriptors,
  B&B replay, primary chains, MAPQ and the decision, as the JAX engine's
  Python tail does.

Minimizer indexes (``index.opt.w > 0``, e.g. the ``faster`` preset) seed
through the same sketch scan followed by the minimizer window filter.
The flags whose output needs host events or Python chains at emit
(``PYTHON_TAIL_FLAGS``: CIGAR, chain output, the three logs) finish every
round in the Python tail, after the native chain DP too. CIGAR needs each
read's events on the host: the hybrid and host stage1 have them, the
device stage1 then carries them in its download, and the DTW reads a
per-round uploaded pool of them instead of the device history.

``pipeline_depth`` groups advance round-robin as generators that yield
at every device wait, so one group's host work overlaps another group's
device work. Slots are position-stable and refilled as reads finish
(continuous batching).

``fused=True`` (with the device stage1) runs the fused stage1+chain of
the JAX engine: one device stage runs the events, sketch, lookup, the
hit expansion, the carried-anchor merge, the 4-key sort, the occ-ranked
drop to ``max_anchors`` (``map/fused.py``) and the chain DP (CUDA chain
kernel), so the round uploads the raw chunks and its carried anchors,
not the anchors. The host replays the expansion from the stage1 blocks
it downloads (same order, same drop), fetches a prefix of the
device-resident DP output as wide as its widest row, and finishes the
round in the Python tail. A row with more hits and carried anchors than
``2 * max_anchors`` escalates to the unfused chain DP of the chain
placement; a round with more carried anchors than ``min(512,
max_carried)`` runs unfused.

``"auto"`` resolves as the JAX engine does: the hybrid stage1 when the
native library has the event detector and ``fused`` is off, else the
device stage1 (``fused=True`` with ``stage1_impl="hybrid"`` raises
``ValueError``); the native chain DP when the library has it and its
round tail, else the device chain DP. A native library without what
the chosen placements need raises ``RuntimeError``.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from rawalign_tpu_torch import native, runtime
from rawalign_tpu_torch.config import MappingFlag, MappingOptions
from rawalign_tpu_torch.golden import chain as gchain
from rawalign_tpu_torch.golden import engine as gengine
from rawalign_tpu_torch.golden import events as gevents
from rawalign_tpu_torch.index import query
from rawalign_tpu_torch.index.index import RawIndex
from rawalign_tpu_torch.io import paf
from rawalign_tpu_torch.map import anchors as manchors
from rawalign_tpu_torch.map import chain, fused as mfused, postprocess, stage1_codec, tiles
from rawalign_tpu_torch.map.postprocess import BorderConstraint, FillMethod
from rawalign_tpu_torch.seeds import sketch
from rawalign_tpu_torch.signal import events

#: flags whose output needs host events or chain structure at emit: they
#: take the Python round tail instead of the native round finalize
PYTHON_TAIL_FLAGS = (
    MappingFlag.DTW_OUTPUT_CIGAR
    | MappingFlag.OUTPUT_CHAINS
    | MappingFlag.DTW_LOG_SCORES
    | MappingFlag.LOG_ANCHORS
    | MappingFlag.LOG_NUM_ANCHORS
)
LOG_FLAGS = MappingFlag.LOG_ANCHORS | MappingFlag.LOG_NUM_ANCHORS

#: ``ra_expand_round`` (native/rawalign_host.cpp:736-767) packs each
#: anchor's input position within its read, the stable sort's tie-break,
#: into 24 bits of the sort key: positions 0 .. 2**24 - 1
EXPAND_MAX_ANCHORS = 1 << 24


def check_expand_bound(need: np.ndarray, live: np.ndarray) -> None:
    """Raise before an anchor expansion whose 24-bit tie-break would wrap:
    ``need`` (B,) is each read's pre-drop anchor count (its seed hits
    after the occurrence cap plus its carried anchors), ``live`` the
    reads the round expands. Beyond ``EXPAND_MAX_ANCHORS`` the native
    expansion would corrupt qpos and the sort order without an error."""
    if live.any() and int(need[live].max()) > EXPAND_MAX_ANCHORS:
        i = int(np.flatnonzero(live)[np.argmax(need[live])])
        raise RuntimeError(
            f"read slot {i} expands {int(need[i])} anchors in one round; the "
            f"native anchor expansion takes at most {EXPAND_MAX_ANCHORS} "
            "(lower max_occ)"
        )


#: the least anchor demand of a round's row block: a lighter round's tail
#: runs in fewer jobs, since every job adds its Python glue and its
#: hand-overs of the interpreter lock to the main thread's round loop
ROW_BLOCK_ANCHORS = 1 << 17


def host_cpus() -> int:
    """The CPUs this process may run on (its affinity mask, which a
    container or ``taskset`` may narrow below ``os.cpu_count()``)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # a platform without affinity masks
        return os.cpu_count() or 1


def row_blocks(weight: np.ndarray, k: int) -> list[tuple[int, int]]:
    """Cut rows 0 .. B into at most ``k`` contiguous blocks [lo, hi) of
    about equal summed ``weight`` (a row's anchor demand, 0 for a row
    the round does not chain). Every row lies in exactly one block."""
    B = weight.size
    total = int(weight.sum())
    if k <= 1 or total == 0:
        return [(0, B)]
    cum = np.cumsum(weight)
    # a block ends at the row whose running sum first reaches j/k of it
    cuts = np.searchsorted(cum, total * np.arange(1, k) / k, side="left") + 1
    edges = np.unique(np.concatenate([[0], np.minimum(cuts, B), [B]]))
    return list(zip(edges[:-1].tolist(), edges[1:].tolist()))


class _ReadState:
    __slots__ = (
        "name", "signal", "qlen", "chunk_ptr", "chunks_done", "events",
        "offset", "ev_total", "chains", "carried", "fin", "done", "map_time",
    )

    def __init__(self, name: str, signal: np.ndarray):
        self.name = name
        self.signal = np.asarray(signal, dtype=np.float32)
        self.qlen = self.signal.size
        self.chunk_ptr = 0
        self.chunks_done = 0
        # every event of the read, on the host; kept only when the host
        # has them anyway or CIGAR output needs them (see _events_on_host)
        self.events = np.zeros(0, dtype=np.float32)
        # events of chunks that passed the min_events gate
        self.offset = 0
        # all events ever detected = write offset into the history row
        self.ev_total = 0
        # the Python tail's chains (device chain path)
        self.chains: list[gchain.Chain] = []
        # carried anchors for the next round and the emit-field record,
        # both from the native round finalize (native chain path)
        self.carried: tuple | None = None
        self.fin: dict | None = None
        self.done = False
        # wall time of the rounds this read was live in (mt:f)
        self.map_time = 0.0


def _carried_from_chains(chains: list[gchain.Chain]) -> tuple:
    """Every anchor of ``chains`` as (seg, target, query) int64 arrays,
    chain by chain: the next round re-injects them (rmap.cpp:343-362)."""
    seg = np.concatenate([
        np.full(c.anchors.shape[0], c.reference_sequence_index * 2 + c.strand,
                np.int64)
        for c in chains
    ])
    a = np.concatenate([c.anchors for c in chains]).astype(np.int64)
    return seg, a[:, 0].copy(), a[:, 1].copy()


class MappingEngine:
    """Maps batches of raw-signal reads against a RawIndex."""

    #: the DTW tiles' mesh (the distributed engine's); one device here
    mesh = None

    def __init__(
        self,
        index: RawIndex,
        opt: MappingOptions,
        *,
        device: str | torch.device = "cuda",
        batch_size: int = 64,
        max_occ: int = 4096,
        max_anchors: int = 2048,
        max_anchors_ceiling: int | None = None,
        max_carried: int = 1024,
        chain_window: int = 64,
        pipeline_depth: int = 2,
        seeds_out: int = 768,
        dtw_device_max_n: int = 2048,
        dtw_device_max_b: int = 2048,
        mt_mode: str = "share",
        chain_impl: str = "auto",
        stage1_impl: str = "auto",
        fused: bool = False,
        pool_workers: int | None = None,
    ):
        if chain_impl not in ("auto", "native", "device"):
            raise ValueError(f"chain_impl must be auto|native|device: {chain_impl}")
        if stage1_impl not in ("auto", "hybrid", "device", "host"):
            raise ValueError(
                f"stage1_impl must be auto|hybrid|device|host: {stage1_impl}"
            )
        if mt_mode not in ("share", "wall"):
            raise ValueError(f"mt_mode must be share|wall: {mt_mode}")
        if chain_impl == "auto":
            # the native chain DP only with the native round tail beside it
            chain_impl = (
                "native"
                if native.chain_dp_available() and native.round_tail_available()
                else "device"
            )
        if stage1_impl == "auto":
            # the fused stage needs the raw signal on the device
            stage1_impl = (
                "hybrid"
                if native.available() and native.events_available() and not fused
                else "device"
            )
        if fused and stage1_impl == "hybrid":
            raise ValueError("fused=True requires stage1_impl='device'")
        # CIGAR output reads each read's events on the host at emit: the
        # hybrid and host stage1 detect them there, the device stage1
        # then ships them in its download and the DTW reads a per-round
        # uploaded pool of them (the JAX engine's _events_on_host)
        self._events_on_host = (
            bool(opt.flag & MappingFlag.DTW_OUTPUT_CIGAR)
            or stage1_impl == "host"
        ) and stage1_impl != "hybrid"
        # whether the stage1 download leads with the events (the JAX
        # engine's _s1_dl_events). On one card exactly when the DTW reads
        # the host pool; the distributed engine reads the pool on every
        # placement but downloads the events only from the device stage1
        self._s1_dl_events = self._events_on_host
        # rounds end in the Python tail (per-read chains, B&B replay in
        # Python) instead of the native round finalize
        # (every round under fused: its rounds end there, as in the JAX
        # engine, and one tail keeps a read's state in one form)
        self._python_tail = (
            bool(opt.flag & PYTHON_TAIL_FLAGS) or self._events_on_host
            or bool(fused)
        )
        # anchor expansion, oversized DTW tiles and the traceback run in
        # the native library on every path
        need = {"its core": native.available()}
        if stage1_impl in ("hybrid", "host"):
            need["events"] = native.events_available()
        if chain_impl == "native":
            need["chain DP"] = native.chain_dp_available()
            if not self._python_tail:
                need["round tail"] = native.round_tail_available()
        if chain_impl == "device" or self._python_tail:
            need["traceback"] = native.chains_from_dp_available()
        missing = [k for k, ok in need.items() if not ok]
        if missing:
            raise RuntimeError(
                f"stage1_impl={stage1_impl!r} with chain_impl={chain_impl!r} "
                f"needs the native host library with {', '.join(missing)} "
                "(make -C native)"
            )
        self.stage1_impl = stage1_impl
        self.chain_impl = chain_impl
        stage1_codec.validate_bounds(opt.max_events_per_chunk, max_occ)
        self.device = runtime.device(device)
        self.index = index
        self.opt = opt
        self.mt_mode = mt_mode
        self.batch_size = batch_size
        self.max_occ = max_occ
        self.max_anchors = max_anchors
        # the chain DP sizes its arrays to the round's demand up to this
        # ceiling and decimates only beyond it
        self.max_anchors_ceiling = (
            max(1 << 17, max_anchors)
            if max_anchors_ceiling is None
            else max(max_anchors_ceiling, max_anchors)
        )
        self.chain_window = chain_window
        self.pipeline_depth = pipeline_depth
        # tiles with a side beyond these run in the native host library
        self.dtw_device_max_n = dtw_device_max_n
        self.dtw_device_max_b = dtw_device_max_b
        # host C work (expansion, chain DP, round tail) releases the GIL:
        # run it on a pool so pipeline groups overlap, each round's tail
        # cut into one row block a worker (row_blocks). Width: one thread
        # for each CPU this process may run on. On 8 CPUs 8 beat 7 (the
        # main thread keeping a core) and 4 in every cell tried, CIGAR's
        # emit-time traceback on the main thread included (PERF.md §6)
        self.pool_workers = (
            max(2, host_cpus()) if pool_workers is None else int(pool_workers)
        )
        if self.pool_workers < 1:
            raise ValueError(f"pool_workers must be at least 1: {pool_workers}")
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.pool_workers
        )
        # the per-read event detection, which the main thread waits on,
        # on a pool of its own so that it never queues behind the tails;
        # as wide, since with reads that map nowhere it is most of the
        # host's work (the threads share the CPUs with the tails')
        self._events_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.pool_workers
        )

        ne = opt.max_events_per_chunk
        self._ns_out = min(seeds_out, ne)
        self._hmax = opt.max_num_chunk * ne
        self._bk = query.index_state(index, self.device)
        # resident reference-signal pool; tiles index it by base
        self._sig_base: dict[tuple[int, int], int] = {}
        parts = []
        off = 0
        for strand in (0, 1):
            for si, sig in enumerate(index.signals[strand]):
                self._sig_base[(strand, si)] = off
                arr = np.asarray(sig, np.float32)
                parts.append(arr)
                off += arr.size
        self._ref_cat_host = (
            np.concatenate(parts) if parts else np.zeros(0, np.float32)
        )
        self._ref_cat_dev = runtime.put(self._ref_cat_host, self.device)
        lref = self._ref_cat_host.size
        self._segbase_tbl = np.zeros(max(2 * index.n_seq, 1), np.int64)
        for (strand, si), base in self._sig_base.items():
            self._segbase_tbl[si * 2 + strand] = base
        # event bases: slot i's history row starts at lref + i * hmax
        self._evbase_arr = np.arange(batch_size, dtype=np.int64) * self._hmax + lref
        # per-pipeline-group device event history (batch_size, hmax)
        self._group_hist: dict[int, torch.Tensor] = {}
        self._h_val_id = np.asarray(index.val_id)
        self._h_val_ps = np.asarray(index.val_ps)
        self._ev_arange = torch.arange(ne, device=self.device)
        # the fused stage1+chain (device stage1 only): the DP at the
        # anchor budget, hits expanded to twice it, up to _fused_c
        # carried anchors, and _fused_p columns of scores and preds in
        # the stage1 download (0: every round fetches the prefix it needs)
        self.max_carried = max_carried
        self._fused = bool(fused) and stage1_impl == "device"
        self._fused_w = max_anchors
        self._fused_exp = 2 * max_anchors
        self._fused_c = min(512, max_carried)
        self._fused_p = 0
        if self._fused:
            # the index's value table on the device (int32 bits)
            self._val_id = runtime.put(self._h_val_id.view(np.int32), self.device)
            self._val_ps = runtime.put(self._h_val_ps.view(np.int32), self.device)

        self.counters = {
            "seed_hits_compact_dropped": 0,
            "seed_hits_dropped": 0,
            "anchors_dropped": 0,
            "events_dropped": 0,
            "reads_mapped": 0,
            "reads_processed": 0,
            "dtw_tiles": 0,
            "dtw_cells": 0,
            "dtw_tiles_device": 0,
            "dtw_tiles_host_large": 0,
            "fused_escalations": 0,
            "fused_refetches": 0,
        }
        # wall-clock seconds per engine phase
        self.phase_times = {
            "build_inputs": 0.0,
            "stage_chain": 0.0,
            "host_anchors": 0.0,
            "chain_dp": 0.0,
            "traceback": 0.0,
            "dtw_prep": 0.0,
            "dtw": 0.0,
            "finalize": 0.0,
            "rounds": 0,
        }

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Release the worker pools (idempotent)."""
        for name in ("_pool", "_events_pool"):
            pool = getattr(self, name)
            setattr(self, name, None)
            if pool is not None:
                pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    def _stage1(self, packed_ev: np.ndarray, hist: torch.Tensor,
                hist_off: np.ndarray) -> torch.Tensor:
        """Hybrid stage1: ``packed_ev`` (B, ne+2) holds event values |
        n_events | n_dropped, detected on the host."""
        ne = self.opt.max_events_per_chunk
        x = runtime.put(packed_ev, self.device)
        return self._stage1_post(
            x[:, :ne].contiguous(), x[:, ne].to(torch.int32),
            x[:, ne + 1].to(torch.int32), hist, hist_off,
        )

    def _stage1_device(self, packed_sig: np.ndarray, hist: torch.Tensor,
                       hist_off: np.ndarray) -> torch.Tensor:
        """Device stage1: ``packed_sig`` (B, chunk_size+1) holds each
        slot's raw chunk | its length; the events are detected on the
        device, and lead the packed output when the download carries them
        (``_s1_dl_events``)."""
        opt = self.opt
        L = opt.chunk_size
        x = runtime.put(packed_sig, self.device)
        ev = events.detect_events_batch(
            x[:, :L], x[:, L].to(torch.int32),
            w1=opt.window_length1,
            w2=opt.window_length2,
            threshold1=opt.threshold1,
            threshold2=opt.threshold2,
            peak_height=opt.peak_height,
            max_events=opt.max_events_per_chunk,
        )
        return self._stage1_post(ev.values, ev.n_events, ev.n_dropped, hist,
                                 hist_off, with_events=self._s1_dl_events)

    def _stage1_post(self, ev_values: torch.Tensor, ev_n: torch.Tensor,
                     ev_nd: torch.Tensor, hist: torch.Tensor,
                     hist_off: np.ndarray, *,
                     with_events: bool = False) -> torch.Tensor:
        """Sketch, seed compaction, lookup and history append on one
        round's events (B, ne). Appends the events to ``hist`` in place —
        the JAX engine donates this buffer to its jitted stage and gets a
        new one back; here it is simply updated. Returns the packed
        stage1 output (B, [ne +] 2*ns + 4), the events first if
        ``with_events``."""
        return stage1_codec.pack_stage1(
            *self._stage1_blocks(ev_values, ev_n, ev_nd, hist, hist_off),
            ev_values if with_events else None,
        )

    def _stage1_blocks(self, ev_values: torch.Tensor, ev_n: torch.Tensor,
                       ev_nd: torch.Tensor, hist: torch.Tensor,
                       hist_off: np.ndarray):
        """:meth:`_stage1_post` up to the packing: (lo, qc, scalars)."""
        ne = self.opt.max_events_per_chunk
        h_c, qp_c, v_c, n_compact_dropped = self._compact_seeds(ev_values, ev_n)
        lo_c, count = query.lookup_bounds(self._bk, h_c)
        # append this chunk's events to each slot's history row (the
        # JAX dynamic_update_slice: start clamped so the row fits)
        off = runtime.put(hist_off.astype(np.int64), self.device)
        col = off.clamp(0, self._hmax - ne)[:, None] + self._ev_arange
        hist.scatter_(1, col, ev_values)
        return self._hit_blocks(ev_n, ev_nd, lo_c, count, qp_c, v_c,
                                n_compact_dropped)

    def _compact_seeds(self, ev_values: torch.Tensor, ev_n: torch.Tensor):
        """Sketch (minimizers when ``index.opt.w``) and seed compaction:
        a stable sort of the invalid flag keeps the valid seeds first, in
        original order, so the host expansion sees anchors in the
        uncompacted order. Returns the first ns_out columns' (hashes,
        qpos int32, valid) and each row's seeds beyond ns_out (never
        looked up)."""
        io = self.index.opt
        if io.w:
            seeds = sketch.sketch_events_min_batch(
                ev_values, ev_n, w=io.w, e=io.e, q=io.q, lq=io.lq
            )
        else:
            seeds = sketch.sketch_events_batch(
                ev_values, ev_n, e=io.e, q=io.q, lq=io.lq
            )
        flag = (~seeds.valid).to(torch.int32)
        perm_c = torch.sort(flag, dim=1, stable=True).indices[:, : self._ns_out]
        h_c = seeds.hashes.gather(1, perm_c)
        qp_c = seeds.qpos.gather(1, perm_c).to(torch.int32)
        v_c = seeds.valid.gather(1, perm_c)
        n_valid = seeds.valid.sum(dim=1, dtype=torch.int32)
        return h_c, qp_c, v_c, (n_valid - self._ns_out).clamp(min=0)

    def _pack_hits(self, ev_values, ev_n, ev_nd, lo_c, count, qp_c, v_c,
                   n_compact_dropped, with_events: bool) -> torch.Tensor:
        """:meth:`_hit_blocks`, then the packed stage1 output."""
        return stage1_codec.pack_stage1(
            *self._hit_blocks(ev_n, ev_nd, lo_c, count, qp_c, v_c,
                              n_compact_dropped),
            ev_values if with_events else None,
        )

    def _hit_blocks(self, ev_n, ev_nd, lo_c, count, qp_c, v_c,
                    n_compact_dropped):
        """The occurrence cap, the (qpos, count) packing and the
        hits-first column order on the looked-up seeds: (lo, qc,
        scalars)."""
        over = count > self.max_occ
        n_occ_dropped = torch.where(v_c & over, count, 0).sum(
            dim=1, dtype=torch.int32
        )
        cnt_c = torch.where(v_c & ~over, count, 0)
        qc_c = stage1_codec.pack_qc(qp_c, cnt_c)
        # hits-first: zero-count columns emit no anchors, so moving them
        # last keeps the expanded anchor order
        perm2 = stage1_codec.hits_first_perm(cnt_c)
        lo_c = lo_c.gather(1, perm2)
        qc_c = qc_c.gather(1, perm2)
        scalars = torch.stack(
            [ev_n, ev_nd, n_occ_dropped, n_compact_dropped.to(torch.int32)],
            dim=1,
        )
        return lo_c, qc_c, scalars

    def _stage1_fused(self, packed_sig: np.ndarray, carried_in: np.ndarray,
                      hist: torch.Tensor, hist_off: np.ndarray):
        """The fused stage1+chain: :meth:`_stage1_device`'s events,
        sketch, lookup and history append, then ``map/fused.py``'s
        anchors from the stage1 blocks and ``carried_in`` (B, 3C+2) int32,
        and the chain DP at width ``_fused_w``, all queued on the device
        with no wait on the host. Returns (packed, dp_full): the stage1
        row with ``_fused_p`` columns of scores and preds
        (``stage1_codec.pack_stage1_fused``), and the whole DP output
        (B, 2A) scores | preds bitcast, which stays on the device."""
        opt = self.opt
        L = opt.chunk_size
        x = runtime.put(packed_sig, self.device)
        ev = events.detect_events_batch(
            x[:, :L], x[:, L].to(torch.int32),
            w1=opt.window_length1,
            w2=opt.window_length2,
            threshold1=opt.threshold1,
            threshold2=opt.threshold2,
            peak_height=opt.peak_height,
            max_events=opt.max_events_per_chunk,
        )
        lo_c, qc_c, scalars = self._stage1_blocks(
            ev.values, ev.n_events, ev.n_dropped, hist, hist_off
        )
        anchors, n_dp = mfused.fused_anchors(
            lo_c, qc_c, runtime.put(carried_in, self.device),
            self._val_id, self._val_ps, a=self._fused_w, a_exp=self._fused_exp,
        )
        dp = chain.chain_dp_batch(
            anchors.seg, anchors.tgt, anchors.qry, n_dp,
            window=self.chain_window,
            e=self.index.opt.e,
            max_gap=opt.max_gap_length,
            max_target_gap=opt.max_target_gap_length,
            max_skips=opt.max_num_skips,
        )
        P = self._fused_p
        packed = stage1_codec.pack_stage1_fused(
            lo_c, qc_c, scalars, ev.values if self._s1_dl_events else None,
            dp.scores[:, :P], dp.preds[:, :P],
        )
        return packed, torch.cat([dp.scores, dp.preds.view(torch.float32)], dim=1)

    def _dp_prefix(self, dp_full: torch.Tensor, w: int) -> runtime.PendingFetch:
        """Start fetching the ``w``-column prefix of the device-resident
        fused DP output: (B, 2w) scores | preds bitcast."""
        A = self._fused_w
        return runtime.fetch_async(
            torch.cat([dp_full[:, :w], dp_full[:, A : A + w]], dim=1)
        )

    # ------------------------------------------------------------------
    def map_reads(
        self, reads: Iterable[tuple[str, np.ndarray]]
    ) -> Iterator[paf.MappingResult]:
        """Continuous batching with software pipelining: the read groups
        advance round-robin, one device wait at a time."""
        it = iter(reads)
        depth = max(1, self.pipeline_depth)
        group_slots: list[list[_ReadState | None]] = [
            [None] * self.batch_size for _ in range(depth)
        ]
        gens: list = [None] * depth
        exhausted = False
        while True:
            progressed = False
            for g in range(depth):
                if gens[g] is None:
                    slots = group_slots[g]
                    for i, st in enumerate(slots):
                        if st is not None and (
                            st.done
                            or st.chunk_ptr >= st.qlen
                            or st.chunks_done >= self.opt.max_num_chunk
                        ):
                            yield self._emit(st)
                            slots[i] = None
                    if not exhausted:
                        for i in range(self.batch_size):
                            if slots[i] is not None:
                                continue
                            try:
                                name, sig = next(it)
                            except StopIteration:
                                exhausted = True
                                break
                            slots[i] = _ReadState(name, sig)
                    if any(st is not None for st in slots):
                        gens[g] = self._round_gen(slots, g)
                if gens[g] is not None:
                    progressed = True
                    try:
                        next(gens[g])
                    except StopIteration:
                        gens[g] = None
            if not progressed:
                break

    # ------------------------------------------------------------------
    def _round_gen(self, slots: list, g: int):
        opt = self.opt
        pt = self.phase_times
        pt["rounds"] += 1
        t_round0 = time.perf_counter()
        t_mark = t_round0
        n_live = sum(1 for st in slots if st is not None)

        def charge_round():
            # "share": each live read is charged its share of the
            # round's wall time; "wall": the full round wall
            dt = time.perf_counter() - t_round0
            if self.mt_mode == "share":
                dt /= max(1, n_live)
            for st in slots:
                if st is not None:
                    st.map_time += dt

        def mark(phase):
            nonlocal t_mark
            now = time.perf_counter()
            pt[phase] += now - t_mark
            t_mark = now

        B = self.batch_size
        L = opt.chunk_size
        ne = opt.max_events_per_chunk
        hist_off = np.zeros(B, dtype=np.int32)
        # carried anchors are gathered now: the fused stage uploads them,
        # and the host replay reuses these arrays, so both see one order
        carried_lists: dict[int, tuple] = {}
        live: list = []
        for i, st in enumerate(slots):
            if st is None:
                continue
            live.append((i, st.signal[st.chunk_ptr : st.chunk_ptr + L]))
            hist_off[i] = st.ev_total
            if st.carried is not None:
                carried_lists[i] = st.carried
            elif st.chains:
                carried_lists[i] = _carried_from_chains(st.chains)
        max_car = max((c[0].size for c in carried_lists.values()), default=0)
        use_fused = self._fused and max_car <= self._fused_c
        fused_out = None

        if self.stage1_impl == "host":
            # no device round trip: the round's only device work is DTW
            mark("build_inputs")
            s1 = self._stage1_host_round(slots)
        else:
            if self.stage1_impl == "device":
                stage1 = self._stage1_device
                packed_in = np.zeros((B, L + 1), dtype=np.float32)
                for i, part in live:
                    packed_in[i, : part.size] = part
                    packed_in[i, L] = part.size
            else:
                stage1 = self._stage1
                packed_in = np.zeros((B, ne + 2), dtype=np.float32)

                @runtime.spanned("host.events")
                def detect(item):
                    # native C detector (revent.c semantics); rows and
                    # read states are disjoint
                    i, part = item
                    evs = (gevents.detect_events_fast(part, opt) if part.size
                           else np.zeros(0, np.float32))
                    dropped = max(evs.size - ne, 0)
                    evs = evs[:ne]
                    if evs.size:
                        st = slots[i]
                        st.events = np.concatenate([st.events, evs])
                    packed_in[i, : evs.size] = evs
                    packed_in[i, ne] = evs.size
                    packed_in[i, ne + 1] = dropped

                list(self._events_pool.map(detect, live))
            mark("build_inputs")

            hist = self._group_hist.get(g)
            if hist is None:
                hist = torch.zeros((B, self._hmax), device=self.device)
                self._group_hist[g] = hist
            if use_fused:
                C = self._fused_c
                carried_in = np.zeros((B, 3 * C + 2), dtype=np.int32)
                for i, (cs, ct, cq) in carried_lists.items():
                    m = cs.size
                    carried_in[i, :m] = cs
                    carried_in[i, C : C + m] = ct
                    carried_in[i, 2 * C : 2 * C + m] = cq
                    carried_in[i, 3 * C] = m
                for i, st in enumerate(slots):
                    if st is not None:
                        carried_in[i, 3 * C + 1] = st.offset
                out, dp_full = self._stage1_fused(packed_in, carried_in, hist,
                                                  hist_off)
            else:
                out = stage1(packed_in, hist, hist_off)
            pending = runtime.fetch_async(out)
            yield  # other groups' host work overlaps this device work
            if use_fused:
                sf = stage1_codec.unpack_stage1_fused(
                    pending.result(), ne=ne, ns=self._ns_out, a=self._fused_p,
                    events_on_host=self._s1_dl_events,
                )
                s1 = sf.stage1
                fused_out = (sf.scores, sf.preds, dp_full)
            else:
                s1 = stage1_codec.unpack_stage1(
                    pending.result(), ne=ne, ns=self._ns_out,
                    events_on_host=self._s1_dl_events,
                )
        ev_counts = s1.n_events
        mark("stage_chain")
        self.counters["events_dropped"] += int(s1.n_ev_dropped.sum())
        self.counters["seed_hits_dropped"] += int(s1.n_occ_dropped.sum())
        self.counters["seed_hits_compact_dropped"] += int(
            s1.n_compact_dropped.sum()
        )
        chain_this_round = ev_counts >= opt.min_events
        for i, st in enumerate(slots):
            if st is None:
                chain_this_round[i] = False
                continue
            n_ev = int(ev_counts[i])
            st.ev_total += n_ev
            if n_ev and s1.ev_values is not None:
                st.events = np.concatenate([st.events, s1.ev_values[i, :n_ev]])
        yield from self._round_tail(
            slots, g, carried_lists, chain_this_round, s1, mark, charge_round,
            fused_out,
        )

    # ------------------------------------------------------------------
    def _stage1_host_round(self, slots) -> stage1_codec.Stage1Host:
        """Host stage1 of one round (the JAX engine's _stage1_host_round):
        the native detector, the native sketch (minimizers when
        ``index.opt.w``), ``np.searchsorted`` on the sorted key table and
        the occurrence cap, with no compaction (NS = ne). The events are
        appended to each read's host array."""
        opt = self.opt
        io = self.index.opt
        B = self.batch_size
        ne = opt.max_events_per_chunk
        L = opt.chunk_size
        keys = self.index.keys
        lo = np.zeros((B, ne), np.int32)
        qpos = np.zeros((B, ne), np.int32)
        count = np.zeros((B, ne), np.int32)
        n_events = np.zeros(B, np.int64)
        n_ev_dropped = np.zeros(B, np.int64)
        n_occ_dropped = np.zeros(B, np.int64)

        @runtime.spanned("host.events")
        def one(item):
            # rows and read states are disjoint
            i, st = item
            part = st.signal[st.chunk_ptr : st.chunk_ptr + L]
            if part.size == 0:
                return
            evs = gevents.detect_events_fast(part, opt)
            if evs.size > ne:
                n_ev_dropped[i] = evs.size - ne
                evs = evs[:ne]
            n_events[i] = evs.size
            if evs.size:
                st.events = np.concatenate([st.events, evs])
            if evs.size < io.e:
                return
            if io.w:
                h, p = native.sketch_min(evs, io.w, io.e, io.q, io.lq)
            else:
                h, p = native.sketch_reg(evs, io.e, io.q, io.lq)
            if h.size == 0:
                return
            h_lo = np.searchsorted(keys, h, side="left")
            cnt = (np.searchsorted(keys, h, side="right") - h_lo).astype(np.int64)
            over = cnt > self.max_occ
            n_occ_dropped[i] = int(cnt[over].sum())
            cnt[over] = 0
            m = h.size
            lo[i, :m] = h_lo
            qpos[i, :m] = p
            count[i, :m] = cnt

        live = [(i, st) for i, st in enumerate(slots) if st is not None]
        list(self._pool.map(one, live))
        return stage1_codec.Stage1Host(
            ev_values=None, lo=lo, qpos=qpos, count=count, n_events=n_events,
            n_ev_dropped=n_ev_dropped, n_occ_dropped=n_occ_dropped,
            n_compact_dropped=np.zeros(B, np.int64),
        )

    # ------------------------------------------------------------------
    def _round_tail(self, slots, g, carried_lists, chain_this_round, s1,
                    mark, charge_round, fused_out=None):
        """Anchor expansion -> chain DP -> traceback, DTW and decisions
        on one round's stage1 output ``s1``: in host C on the worker pool
        (native chain and round tail), or ending in the Python tail
        (device chain, fused, or a flag in ``PYTHON_TAIL_FLAGS``).
        ``fused_out`` is a fused round's (scores, preds) prefix and
        device-resident DP output."""
        opt = self.opt
        B = self.batch_size
        h_count = s1.count
        ev_counts = s1.n_events
        if not chain_this_round.any():
            for st in slots:
                if st is not None:
                    st.chunk_ptr += opt.chunk_size
                    st.chunks_done += 1
            mark("host_anchors")
            mark("finalize")
            charge_round()
            return
        # lossless sizing: grow A to the round's anchor demand (hits +
        # carried), up to the ceiling; a fused round replays the device's
        # drop at max_anchors instead
        A = self.max_anchors
        need = h_count.sum(axis=1, dtype=np.int64)
        for i, cl in carried_lists.items():
            need[i] += cl[0].size
        check_expand_bound(need, chain_this_round)
        nmax = int(need[chain_this_round].max())
        if nmax > A and fused_out is None:
            A = 1 << int(np.ceil(np.log2(nmax)))
        A = min(A, self.max_anchors_ceiling)
        # each block job fills its own rows: the sentinel segment and
        # zeros before the expansion, every column of scores and preds
        seg_b = np.empty((B, A), dtype=np.int32)
        tgt_b = np.empty((B, A), dtype=np.int32)
        qry_b = np.empty((B, A), dtype=np.int32)
        n_anch = np.zeros(B, dtype=np.int32)
        read_offsets = np.zeros(B, dtype=np.int64)
        for i, st in enumerate(slots):
            if st is not None:
                read_offsets[i] = st.offset
        # DTW tiles run for evaluation or for the score log; chains are
        # replaced by the B&B survivors only under evaluation
        use_dtw = bool(opt.flag & (MappingFlag.DTW_EVALUATE_CHAINS
                                   | MappingFlag.DTW_LOG_SCORES))
        io = self.index.opt
        # contiguous row blocks of about equal anchor demand, at most one
        # a worker and one a ROW_BLOCK_ANCHORS of demand
        weight = np.where(chain_this_round, need, 0)
        blocks = row_blocks(weight, min(
            self.pool_workers, -(-int(weight.sum()) // ROW_BLOCK_ANCHORS)))

        @runtime.spanned("host.expand")
        def expand(lo, hi):
            # rows lo..hi's hits and carried anchors into their rows of
            # the (B, A) blocks; returns (max_used, max_true, dropped)
            return manchors.expand_block(
                lo, hi, s1.lo, s1.qpos, h_count, chain_this_round,
                read_offsets, carried_lists, self._h_val_id,
                self._h_val_ps, A, seg_b, tgt_b, qry_b, n_anch,
            )

        dp_kw = dict(
            window=self.chain_window,
            e=io.e,
            max_gap=opt.max_gap_length,
            max_target_gap=opt.max_target_gap_length,
            max_skips=opt.max_num_skips,
        )

        @runtime.spanned("host.chains_of_round")
        def chains_of_round(scores, preds, lo=0, hi=B):
            # the traceback of every chained read of rows lo..hi, sorted
            # by chaining score when DTW runs
            per_read = {}
            for i in np.nonzero(chain_this_round[lo:hi])[0] + lo:
                chains = postprocess.chains_from_dp_fast(
                    seg_b[i], tgt_b[i], qry_b[i], scores[i], preds[i],
                    int(n_anch[i]), opt,
                )
                if use_dtw:
                    chains.sort(key=lambda c: c.chaining_score, reverse=True)
                per_read[int(i)] = chains
            return per_read

        if (self.chain_impl == "native" and fused_out is None
                and not opt.flag & LOG_FLAGS):
            # the whole host tail on the worker pool, one job a row block;
            # the anchor logs stay on this thread to keep their order, as
            # in the JAX engine
            scores = np.empty((B, A), dtype=np.float32)
            preds = np.empty((B, A), dtype=np.int32)
            gate = chain_this_round.astype(np.uint8)

            def work(lo, hi):
                r = slice(lo, hi)
                stats = expand(lo, hi)
                with runtime.span("host.chain_dp"):
                    native.chain_dp_into(seg_b[r], tgt_b[r], qry_b[r],
                                         n_anch[r], scores[r], preds[r],
                                         **dp_kw)
                if self._python_tail:
                    return stats, chains_of_round(scores, preds, lo, hi)
                with runtime.span("host.round_chains"):
                    return stats, native.round_chains(
                        seg_b[r], tgt_b[r], qry_b[r], scores[r], preds[r],
                        n_anch[r], gate[r], A,
                        min_chaining_score=opt.min_chaining_score,
                        num_best_chains=opt.num_best_chains,
                        min_num_anchors=opt.min_num_anchors,
                        disable_filter=bool(
                            opt.flag & MappingFlag.DISABLE_CHAININGSCORE_FILTERING
                        ),
                        sort_for_dtw=use_dtw,
                        use_dtw=use_dtw,
                        border_global=(
                            opt.dtw_border_constraint == BorderConstraint.GLOBAL
                        ),
                        fill_full=opt.dtw_fill_method == FillMethod.FULL,
                        band_frac=opt.dtw_band_radius_frac,
                        segbase=self._segbase_tbl,
                        ev_base=self._evbase_arr[r],
                    )

            futs = [self._pool.submit(work, lo, hi) for lo, hi in blocks]
            mark("host_anchors")
            yield
            outs = [f.result() for f in futs]
            self.counters["anchors_dropped"] += sum(st[2] for st, _ in outs)
            mark("chain_dp")
            if self._python_tail:
                per_read_chains = {}
                for _, part in outs:
                    per_read_chains.update(part)
                yield from self._round_tail_post(
                    slots, g, per_read_chains, chain_this_round, ev_counts,
                    use_dtw, mark, charge_round,
                )
            else:
                rec = native.merge_round_chains(
                    [(lo, out) for (lo, _), (_, out) in zip(blocks, outs)])
                yield from self._round_tail_post_native(
                    slots, g, rec, chain_this_round, ev_counts, use_dtw, mark,
                    charge_round,
                )
            return

        # a flag that prints keeps this round's host work on this thread,
        # so that the groups print in the JAX engine's order; otherwise
        # the expansion (a job a row block) and the traceback run on the
        # worker pool while the other groups go on, as the native path's
        # tail does
        in_order = bool(opt.flag & (LOG_FLAGS | MappingFlag.DTW_LOG_SCORES))
        if in_order:
            max_used, max_true, dropped = expand(0, B)
        else:
            futs = [self._pool.submit(expand, lo, hi) for lo, hi in blocks]
            yield
            stats = [f.result() for f in futs]
            max_used = max(x[0] for x in stats)
            max_true = max(x[1] for x in stats)
            dropped = sum(x[2] for x in stats)
        self.counters["anchors_dropped"] += dropped
        if opt.flag & LOG_FLAGS:
            self._log_anchors(slots, chain_this_round, seg_b, tgt_b, qry_b,
                              n_anch, s1)
        mark("host_anchors")
        fused_dp = fused_out is not None and max_true <= self._fused_exp
        if fused_out is not None and not fused_dp:
            # a row outgrew the expansion width: the chain placement's DP
            self.counters["fused_escalations"] += 1
        if fused_dp:
            # the device DP chained exactly the anchors the host replayed
            fused_scores, fused_preds, dp_full = fused_out
            if max_used <= self._fused_p:
                scores, preds = fused_scores, fused_preds
            else:
                # a prefix as wide as the widest row, from 256 by powers
                # of two
                self.counters["fused_refetches"] += 1
                w = 256
                while w < max_used:
                    w *= 2
                w = min(w, self._fused_w)
                pending = self._dp_prefix(dp_full, w)
                yield
                wide = pending.result()
                scores = wide[:, :w]
                preds = wide.view(np.int32)[:, w:]
        elif self.chain_impl == "native":
            scores, preds = native.chain_dp(seg_b, tgt_b, qry_b, n_anch,
                                            **dp_kw)
        else:
            # the anchor axis bucketed to powers of two from 256
            a = 256
            while a < max_used:
                a *= 2
            a = min(a, A)
            packed = np.empty((B, 3 * a + 1), dtype=np.int32)
            packed[:, :a] = seg_b[:, :a]
            packed[:, a : 2 * a] = tgt_b[:, :a]
            packed[:, 2 * a : 3 * a] = qry_b[:, :a]
            packed[:, 3 * a] = n_anch
            pending = runtime.fetch_async(self._chain_dp(packed, a))
            yield
            dp = pending.result()
            scores = dp[:, :a]
            preds = dp.view(np.int32)[:, a:]
        mark("chain_dp")
        if in_order:
            per_read_chains = chains_of_round(scores, preds)
        else:
            fut = self._pool.submit(chains_of_round, scores, preds)
            yield
            per_read_chains = fut.result()
        yield from self._round_tail_post(
            slots, g, per_read_chains, chain_this_round,
            ev_counts, use_dtw, mark, charge_round,
        )

    def _log_anchors(self, slots, chain_this_round, seg_b, tgt_b, qry_b,
                     n_anch, s1) -> None:
        """--log-anchors and --log-num-anchors for every chained read of
        the round (rmap.cpp:403-425), as the JAX engine prints them."""
        opt = self.opt
        for i, st in enumerate(slots):
            if not chain_this_round[i]:
                continue
            if opt.flag & MappingFlag.LOG_ANCHORS:
                m = int(n_anch[i])
                by_key: dict[tuple[int, int], list[tuple[int, int]]] = {}
                for s, t, q in zip(seg_b[i, :m].tolist(), tgt_b[i, :m].tolist(),
                                   qry_b[i, :m].tolist()):
                    by_key.setdefault((s & 1, s >> 1), []).append((t, q))
                gchain.log_anchors(by_key, st.name, self.index.seq_names,
                                   self.index.n_seq)
            if opt.flag & MappingFlag.LOG_NUM_ANCHORS:
                # every seed hit, with those the occurrence cap and the
                # compaction dropped (the reference counts before
                # appending, rmap.cpp:381)
                gchain.log_num_anchors(
                    st.name, st.offset, int(s1.n_events[i]),
                    int(s1.count[i].sum()) + int(s1.n_occ_dropped[i])
                    + int(s1.n_compact_dropped[i]),
                )

    def _chain_dp(self, packed: np.ndarray, a: int) -> torch.Tensor:
        """Device chain DP on ``packed`` (B, 3a+1) int32: seg | target |
        query | n_anchors. Returns (B, 2a) float32: scores | preds
        bitcast."""
        return self._chain_dp_on(runtime.put(packed, self.device), a)

    def _chain_dp_on(self, x: torch.Tensor, a: int) -> torch.Tensor:
        """:meth:`_chain_dp` on rows already on their device."""
        opt = self.opt
        dp = chain.chain_dp_batch(
            x[:, :a].contiguous(),
            x[:, a : 2 * a].contiguous(),
            x[:, 2 * a : 3 * a].contiguous(),
            x[:, 3 * a].contiguous(),
            window=self.chain_window,
            e=self.index.opt.e,
            max_gap=opt.max_gap_length,
            max_target_gap=opt.max_target_gap_length,
            max_skips=opt.max_num_skips,
        )
        return torch.cat([dp.scores, dp.preds.view(torch.float32)], dim=1)

    # ------------------------------------------------------------------
    def _round_tail_post(self, slots, g, per_read_chains, chain_this_round,
                         ev_counts, use_dtw, mark, charge_round):
        """The Python round tail: DTW tiles of every chain -> B&B replay
        -> primary chains and MAPQ -> decisions. The tiles read the
        group's device event history, or, when the events live on the
        host, this round's uploaded pool of the chained reads' events."""
        opt = self.opt
        descs: list[np.ndarray] = []
        # each (read, chain)'s [start, end) run of tiles
        runs: dict[tuple[int, int], tuple[int, int]] = {}
        n_tiles = 0
        ev_parts: list[np.ndarray] = []
        ev_off = 0
        if use_dtw:
            lref = self._ref_cat_host.size
            for i, chains in per_read_chains.items():
                if not chains:
                    continue
                if self._events_on_host:
                    # the read's whole event array, appended to the pool
                    ev_base = lref + ev_off
                    ev_parts.append(slots[i].events)
                    ev_off += slots[i].events.size
                else:
                    # this slot's device event-history row
                    ev_base = lref + i * self._hmax
                for ci, ch in enumerate(chains):
                    rows = postprocess.build_chain_tile_descs_vec(
                        ch, self._sig_base[(ch.strand, ch.reference_sequence_index)],
                        ev_base, opt,
                    )
                    if len(rows):
                        descs.append(rows)
                        runs[(i, ci)] = (n_tiles, n_tiles + len(rows))
                        n_tiles += len(rows)
        mark("traceback")
        if descs:
            da = np.concatenate(descs)
            if self._events_on_host:
                pool = np.concatenate(ev_parts)
                pending = self._dtw_submit(
                    da, runtime.put(pool, self.device),
                    lambda idx, ln: pool[idx : idx + ln],
                )
            else:
                pending = self._dtw_submit(
                    da, self._group_hist[g], self._make_ev_fetch(g)
                )
            mark("dtw_prep")
            yield
            costs = tiles.dtw_collect(pending)
            mark("dtw")
            self.counters["dtw_tiles"] += int(da.shape[0])
            self.counters["dtw_cells"] += int(np.sum(
                da[:, 1] * np.minimum(2 * da[:, 4] + 1, da[:, 3])
            ))
            empty = np.zeros(0, dtype=np.float32)
            replace = bool(opt.flag & MappingFlag.DTW_EVALUATE_CHAINS)
            for i, chains in per_read_chains.items():
                part_costs = [
                    costs[r[0] : r[1]] if (r := runs.get((i, ci))) else empty
                    for ci in range(len(chains))
                ]
                post = postprocess.bnb_replay(chains, part_costs, opt)
                if replace:
                    per_read_chains[i] = post
        for i, st in enumerate(slots):
            if st is None:
                continue
            st.chunk_ptr += opt.chunk_size
            st.chunks_done += 1
            if not chain_this_round[i]:
                continue
            st.offset += int(ev_counts[i])
            chains = per_read_chains.get(i, [])
            if chains:
                chains = gchain.gen_primary_chains(chains, opt)
                gchain.comp_mapq(chains, opt)
            st.chains = chains
            if self._decision(st):
                st.done = True
        mark("finalize")
        charge_round()

    # ------------------------------------------------------------------
    def _round_tail_post_native(self, slots, g, rec, chain_this_round,
                                ev_counts, use_dtw, mark, charge_round):
        """DTW on the C-built descriptors, then one native round finalize
        (B&B replay, primary chains, MAPQ, decision, emit fields)."""
        opt = self.opt
        B = self.batch_size
        descs = rec[10]
        mark("traceback")
        costs = np.zeros(0, np.float32)
        if use_dtw and len(descs):
            pending = self._dtw_submit(
                descs, self._group_hist[g], self._make_ev_fetch(g)
            )
            mark("dtw_prep")
            yield
            costs = tiles.dtw_collect(pending)
            mark("dtw")
            self.counters["dtw_tiles"] += int(descs.shape[0])
            self.counters["dtw_cells"] += int(np.sum(
                descs[:, 1] * np.minimum(2 * descs[:, 4] + 1, descs[:, 3])
            ))
        fin = native.round_finalize(
            rec, B, costs,
            use_dtw=use_dtw,
            border_global=use_dtw and (
                opt.dtw_border_constraint == BorderConstraint.GLOBAL
            ),
            match_bonus=opt.dtw_match_bonus,
            dtw_min_score=opt.dtw_min_score,
            min_bestmap_ratio=opt.min_bestmap_ratio,
            min_meanmap_ratio=opt.min_meanmap_ratio,
            min_chain_anchor=opt.min_chain_anchor,
        )
        car_off = fin["car_off"]
        for i, st in enumerate(slots):
            if st is None:
                continue
            st.chunk_ptr += opt.chunk_size
            st.chunks_done += 1
            if not chain_this_round[i]:
                continue
            st.offset += int(ev_counts[i])
            mapped = bool(fin["decision"][i])
            st.fin = {
                "mapped": mapped,
                "nc": int(fin["nc"][i]),
                "seg": int(fin["seg"][i]),
                "start_t": int(fin["start_t"][i]),
                "end_t": int(fin["end_t"][i]),
                "nanch0": int(fin["nanch0"][i]),
                "q_start": int(fin["q_start"][i]),
                "q_end": int(fin["q_end"][i]),
                "mapq": int(fin["mapq"][i]),
                "s1": float(fin["s1"][i]),
                "s2": float(fin["s2"][i]),
                "sm": float(fin["sm"][i]),
                "at": float(fin["at"][i]),
                "aq": float(fin["aq"][i]),
            }
            lo, hi = int(car_off[i]), int(car_off[i + 1])
            st.carried = (
                (fin["car_seg"][lo:hi], fin["car_t"][lo:hi], fin["car_q"][lo:hi])
                if hi > lo
                else None
            )
            if mapped:
                st.done = True
        mark("finalize")
        charge_round()

    # ------------------------------------------------------------------
    def _dtw_submit(self, da: np.ndarray, ev_dev: torch.Tensor, ev_fetch):
        """Dispatch one round's DTW tile descriptors (rows a_base, a_len,
        b_base, b_len, radius, exclude_last) against the event operand
        ``ev_dev``: a group's (B, hmax) history or a round's 1-D uploaded
        event pool, read on the host through ``ev_fetch``."""
        pend = tiles.dtw_submit_indexed(
            *(da[:, k].astype(np.int32) for k in range(6)),
            self._ref_cat_dev,
            ev_dev,
            self._ref_cat_host,
            device_max_n=self.dtw_device_max_n,
            device_max_b=self.dtw_device_max_b,
            ev_fetch=ev_fetch,
            mesh=self.mesh,
        )
        self.counters["dtw_tiles_device"] += len(pend.small_idx)
        self.counters["dtw_tiles_host_large"] += len(pend.large_idx)
        return pend

    def _make_ev_fetch(self, g: int):
        """Host accessor into group g's event history, for the oversized
        tiles the native library runs."""

        def fetch(idx: int, ln: int) -> np.ndarray:
            row, col = divmod(int(idx), self._hmax)
            return runtime.fetch(self._group_hist[g][row, col : col + ln])

        return fetch

    # ------------------------------------------------------------------
    def _decision(self, st: _ReadState) -> bool:
        shim = gengine.ReadState(read_name=st.name)
        shim.chains = st.chains
        return gengine.is_mapped_with_high_confidence(shim, self.opt)

    def _emit(self, st: _ReadState) -> paf.MappingResult:
        opt = self.opt
        self.counters["reads_processed"] += 1
        ci = max(st.chunks_done, 1)
        scale = paf.position_scale_f32(
            ci, opt.chunk_size, st.offset or 1, opt.sample_rate, opt.bp_per_sec
        )
        mapping_time_ms = st.map_time * 1000.0
        if st.fin is not None:
            return self._emit_native(st, ci, scale, mapping_time_ms)
        return self._emit_chains(st, ci, scale, mapping_time_ms)

    def _emit_native(self, st: _ReadState, ci: int, scale,
                     mapping_time_ms: float) -> paf.MappingResult:
        """Emit from the native round finalize's record."""
        f = st.fin
        if f["nc"]:
            tags = paf.build_tags(
                mapping_time_ms=mapping_time_ms,
                n_chunks=ci,
                qlen=st.qlen,
                n_anchors0=f["nanch0"],
                n_chains=f["nc"],
                s1=f["s1"],
                s2=f["s2"],
                sm=f["sm"],
                at=f["at"],
                aq=f["aq"],
                mapped_with_chains=f["mapped"],
            )
        else:
            tags = paf.build_tags(
                mapping_time_ms=mapping_time_ms, n_chunks=ci, qlen=st.qlen
            )
        if not f["mapped"]:
            return paf.MappingResult(
                read_name=st.name,
                read_length=paf.scale_pos(scale, st.offset),
                mapped=False,
                mapq=0,
                tags=tags,
            )
        self.counters["reads_mapped"] += 1
        seg = f["seg"]
        ref_idx, strand = seg >> 1, seg & 1
        ref_len = int(self.index.seq_lens[ref_idx])
        return paf.MappingResult(
            read_name=st.name,
            read_length=paf.scale_pos(scale, f["q_end"]),
            mapped=True,
            read_start_position=paf.scale_pos(scale, f["q_start"]),
            read_end_position=paf.scale_pos(scale, f["q_end"]),
            ref_name=self.index.seq_names[ref_idx],
            ref_len=ref_len,
            fragment_start_position=(
                int(ref_len + 1 - f["end_t"]) if strand else int(f["start_t"])
            ),
            fragment_length=int(f["end_t"] - f["start_t"] + 1),
            rev=strand,
            mapq=f["mapq"],
            tags=tags,
        )

    def _emit_chains(self, st: _ReadState, ci: int, scale,
                     mapping_time_ms: float) -> paf.MappingResult:
        """Emit from the read's Python chains (rmap.cpp:700-802); also the
        form of a read that never chained (no chains, unmapped). A mapped
        read gets the event-to-base alignment (``alns``/``aln``, golden's
        traceback on its host events) under CIGAR output and its best
        chain's anchors under chain output."""
        opt = self.opt
        chains = st.chains
        n_anchors0 = chains[0].n_anchors if chains else 0
        mean_score = paf.mean_score_f32([c.chaining_score for c in chains])
        if self._decision(st):
            self.counters["reads_mapped"] += 1
            c0 = chains[0]
            cigar = bool(opt.flag & MappingFlag.DTW_OUTPUT_CIGAR)
            if cigar:
                gchain.align_chain(c0, self.index, st.events, opt, cigar=True)
            # f32 left-fold of per-pair deltas + f32 division, exactly
            # the reference's accumulation (rmap.cpp:719-729)
            at, aq = paf.anchor_gap_means_f32(c0.anchors)
            tags = paf.build_tags(
                mapping_time_ms=mapping_time_ms,
                n_chunks=ci,
                qlen=st.qlen,
                n_anchors0=n_anchors0,
                n_chains=len(chains),
                s1=c0.chaining_score,
                s2=chains[1].chaining_score if len(chains) > 1 else 0.0,
                sm=mean_score,
                at=at,
                aq=aq,
                mapped_with_chains=True,
                alns=c0.alignment_score if cigar else None,
                aln=gengine._dtwresult_to_string(c0.dtw) if cigar else None,
                anchors=(
                    gengine._anchors_to_string(c0.anchors)
                    if opt.flag & MappingFlag.OUTPUT_CHAINS
                    else None
                ),
            )
            ref_len = int(self.index.seq_lens[c0.reference_sequence_index])
            frag_start = (
                int(ref_len + 1 - c0.end_position)
                if c0.strand
                else int(c0.start_position)
            )
            return paf.MappingResult(
                read_name=st.name,
                read_length=paf.scale_pos(scale, c0.anchors[0][1]),
                mapped=True,
                read_start_position=paf.scale_pos(
                    scale, c0.anchors[n_anchors0 - 1][1]
                ),
                read_end_position=paf.scale_pos(scale, c0.anchors[0][1]),
                ref_name=self.index.seq_names[c0.reference_sequence_index],
                ref_len=ref_len,
                fragment_start_position=frag_start,
                fragment_length=int(c0.end_position - c0.start_position + 1),
                rev=c0.strand,
                mapq=c0.mapq,
                tags=tags,
            )
        if chains:
            c0 = chains[0]
            if n_anchors0:
                at, aq = paf.anchor_gap_means_f32(c0.anchors)
            else:
                at = aq = 0.0
            tags = paf.build_tags(
                mapping_time_ms=mapping_time_ms,
                n_chunks=ci,
                qlen=st.qlen,
                n_anchors0=n_anchors0,
                n_chains=len(chains),
                s1=c0.chaining_score,
                s2=chains[1].chaining_score if len(chains) > 1 else 0.0,
                sm=mean_score,
                at=at,
                aq=aq,
            )
        else:
            tags = paf.build_tags(
                mapping_time_ms=mapping_time_ms, n_chunks=ci, qlen=st.qlen
            )
        return paf.MappingResult(
            read_name=st.name,
            read_length=paf.scale_pos(scale, st.offset),
            mapped=False,
            mapq=0,
            tags=tags,
        )
