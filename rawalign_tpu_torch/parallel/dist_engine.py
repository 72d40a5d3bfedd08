"""The distributed mapping engine: every device stage of a round over a
mesh of cards (port of rawalign_tpu/parallel/dist_engine.py).

It is the single-card ``MappingEngine`` — the same round loop, pipeline
groups, decisions and PAF, all in this one process — with three device
stages spread over a (data, shard) ``parallel/mesh.py:Mesh``:

  stage1 (events, sketch, index lookup) — the batch's rows are split over
      all ranks (rank r holds rows [r * b_loc, (r + 1) * b_loc)); each
      rank detects (device stage1) or takes (hybrid) its rows' events,
      sketches them with the CUDA scan and compacts its seeds to
      ``seeds_out``; one all-to-all over the shard axis delivers every
      hash to the rank owning its key range, which answers with (global
      lo, count), and a second all-to-all brings the answers home
      (``mesh.routed_lookup``). The occurrence cap and the packing are
      the single-card stage1's, so the host unpack and expansion are the
      same and the PAF is identical by construction. The index values
      never leave the host.
  chain DP — per read; each rank runs the CUDA kernel on its own rows.
  DTW — the round's tiles dealt over all ranks longest first, one launch
      per rank with tiles, against each device's copy of the reference
      pool (``tiles.run_round_sharded``).

Each rank's output is gathered onto the mesh's first device, so the base
round loop fetches it as on one card. Events stay on the host: the DTW
reads a per-round pool of them, and no device event history is written.
"""

from __future__ import annotations

import numpy as np
import torch

from rawalign_tpu_torch import native, runtime
from rawalign_tpu_torch.config import MappingOptions
from rawalign_tpu_torch.index.index import RawIndex
from rawalign_tpu_torch.map.engine import MappingEngine
from rawalign_tpu_torch.parallel import mesh as pmesh
from rawalign_tpu_torch.signal import events


class DistributedMappingEngine(MappingEngine):
    """MappingEngine with its stage1, chain DP and DTW over ``mesh``.

    ``batch_size`` is rounded up to a multiple of ``mesh.size`` so the
    rows split evenly; ``fused`` is off and ``chain_impl`` "device".
    ``stage1_impl`` is "hybrid" (host C events, the default when the
    native library has the detector) or "device"; "host" raises. The
    engine's ``device`` is the mesh's first device."""

    def __init__(self, index: RawIndex, opt: MappingOptions,
                 mesh: pmesh.Mesh, **kw):
        if tuple(mesh.axis_names) != ("data", "shard"):
            raise ValueError(
                f"mesh axes must be (data, shard): {mesh.axis_names}")
        n = mesh.size
        kw["batch_size"] = -(-kw.pop("batch_size", 64) // n) * n
        kw["fused"] = False
        kw["chain_impl"] = "device"
        s1 = kw.get("stage1_impl", "auto")
        if s1 == "auto":
            s1 = ("hybrid" if native.available() and native.events_available()
                  else "device")
        if s1 not in ("device", "hybrid"):
            raise ValueError(
                f"distributed stage1_impl must be device|hybrid: {s1}")
        kw["stage1_impl"] = s1
        first = mesh.ranks[0]
        if runtime.device(kw.setdefault("device", first)) != first:
            raise ValueError(f"device {kw['device']} is not the mesh's first "
                             f"device {first}")
        super().__init__(index, opt, **kw)
        self.mesh = mesh
        self._b_loc = self.batch_size // n
        # the DTW reads a per-round host pool of the events on every
        # placement; the download carries them only from the device stage1
        self._events_on_host = True
        self._s1_dl_events = s1 == "device"
        self._python_tail = True
        # the reference pool, once per distinct device
        self._ref_cat_dev = {
            dev: (self._ref_cat_dev if dev == self.device
                  else runtime.put(self._ref_cat_host, dev))
            for dev in mesh.distinct
        }
        self._routing = pmesh.routing_keys(mesh, self.index.keys)
        self.counters["all_to_all_bytes"] = 0

    # ------------------------------------------------------------------
    def _rows(self, x: np.ndarray) -> list[torch.Tensor]:
        """Each rank's rows of the host batch ``x``, on its device."""
        b = self._b_loc
        return [runtime.put(x[r * b : (r + 1) * b], dev)
                for r, dev in enumerate(self.mesh.ranks)]

    def _gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The ranks' rows, in rank order, on the mesh's first device."""
        return torch.cat([p.to(self.device, non_blocking=True) for p in parts])

    def _stage1(self, packed_ev: np.ndarray, hist, hist_off) -> torch.Tensor:
        """Hybrid stage1 over the mesh: ``packed_ev`` (B, ne+2) holds the
        host-detected event values | n_events | n_dropped."""
        ne = self.opt.max_events_per_chunk
        evs = [(x[:, :ne].contiguous(), x[:, ne].to(torch.int32),
                x[:, ne + 1].to(torch.int32)) for x in self._rows(packed_ev)]
        return self._stage1_routed(evs)

    def _stage1_device(self, packed_sig: np.ndarray, hist, hist_off
                       ) -> torch.Tensor:
        """Device stage1 over the mesh: ``packed_sig`` (B, chunk_size+1)
        holds each slot's raw chunk | its length; each rank detects its
        rows' events with the CUDA event kernel."""
        opt = self.opt
        L = opt.chunk_size
        evs = []
        for x in self._rows(packed_sig):
            ev = events.detect_events_batch(
                x[:, :L], x[:, L].to(torch.int32),
                w1=opt.window_length1, w2=opt.window_length2,
                threshold1=opt.threshold1, threshold2=opt.threshold2,
                peak_height=opt.peak_height,
                max_events=opt.max_events_per_chunk,
            )
            evs.append((ev.values, ev.n_events, ev.n_dropped))
        return self._stage1_routed(evs)

    def _stage1_routed(self, evs) -> torch.Tensor:
        """Sketch and compaction on each rank, the routed lookup, then
        each rank's cap and packing; ``evs`` holds each rank's (values,
        n_events, n_dropped). Returns the packed (B, [ne +] 2*ns + 4)
        output on the mesh's first device."""
        seeds = [self._compact_seeds(v, n) for v, n, _ in evs]
        glo, cnt, sent = pmesh.routed_lookup(
            self.mesh, self._routing, [s[0] for s in seeds],
            [s[2] for s in seeds])
        self.counters["all_to_all_bytes"] += sent
        return self._gather([
            self._pack_hits(v, n, nd, lo, c, qp, valid, ncd,
                            self._s1_dl_events)
            for (v, n, nd), lo, c, (_h, qp, valid, ncd)
            in zip(evs, glo, cnt, seeds)
        ])

    # ------------------------------------------------------------------
    def _chain_dp(self, packed: np.ndarray, a: int) -> torch.Tensor:
        """The chain DP of each rank's rows on its device (no
        communication); scores | preds of all rows, in rank order."""
        return self._gather([self._chain_dp_on(x, a)
                             for x in self._rows(packed)])
