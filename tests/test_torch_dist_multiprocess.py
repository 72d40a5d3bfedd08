"""Two processes joined by ``torch.distributed`` (gloo, a file rendezvous
in the test's own directory), each mapping its round-robin shard of the
reads with the distributed engine over a local (2, 2) mesh of logical
CPU ranks: the multi-host layout, one process per host (the port of
``scripts/smoke_multiprocess.py``). An ``all_reduce`` of the mapped
counts proves the collective; rank 0 gathers both shards' PAF lines,
which must equal a one-process run of all the reads."""

import datetime
import json
import os
import re
import subprocess
import sys

import torch

from rawalign_tpu_torch import config
from rawalign_tpu_torch.config import MappingFlag
from rawalign_tpu_torch.index import index as dindex
from rawalign_tpu_torch.io import paf
from rawalign_tpu_torch.map.engine import MappingEngine
from rawalign_tpu_torch.testing import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROC = 2
#: seconds a worker may take, rendezvous and mapping included
TIMEOUT = 240


def _dataset():
    ds = synth.make_dataset(seed=7, genome_lengths=[12000, 6000], n_reads=12,
                            read_len_bp=(150, 350))
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.set_flag(MappingFlag.DTW_EVALUATE_CHAINS)
    mo.max_events_per_chunk = 256
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    return idx, mo, [(r.name, r.signal) for r in ds.reads]


def _lines(eng, reads) -> list[str]:
    with eng:
        return sorted(re.sub(r"\tmt:f:[^\t]*", "", paf.paf_line(r))
                      for r in eng.map_reads(reads))


def _worker(rank: int, rdv: str, out: str) -> None:
    """One process: join the group, map this process's shard of the
    reads over a local (2, 2) mesh, all-reduce the mapped counts, gather
    the PAF lines on rank 0."""
    import torch.distributed as dist

    from rawalign_tpu_torch.parallel import distributed
    from rawalign_tpu_torch.parallel import mesh as pmesh
    from rawalign_tpu_torch.parallel.dist_engine import DistributedMappingEngine

    torch.set_num_threads(1)
    distributed.init(f"file://{rdv}", N_PROC, rank, backend="gloo",
                     timeout=datetime.timedelta(seconds=TIMEOUT))
    pid, n = distributed.process_info()
    assert (pid, n) == (rank, N_PROC)
    idx, mo, reads = _dataset()
    mine = set(distributed.shard_files([name for name, _ in reads]))
    mesh = pmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    lines = _lines(DistributedMappingEngine(
        idx, mo, mesh, batch_size=8, device="cpu", dtw_device_max_n=256,
        dtw_device_max_b=256), [r for r in reads if r[0] in mine])
    mapped = torch.tensor([sum(ln.split("\t")[5] != "*" for ln in lines)])
    dist.all_reduce(mapped)
    shards = [None] * n if pid == 0 else None
    dist.gather_object(lines, shards, dst=0)
    if pid == 0:
        with open(out, "w") as f:
            json.dump({"mapped": int(mapped), "shards": shards}, f)
    dist.destroy_process_group()


def test_two_processes_equal_one(tmp_path):
    out = tmp_path / "rank0.json"
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_dist_multiprocess as t; "
            "t._worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, os.path.join(REPO, "tests"), str(rank),
         str(tmp_path / "rdv"), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for rank in range(N_PROC)]
    errors = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=TIMEOUT + 60)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"rank {rank} rc {p.returncode}:\n{err[-3000:]}")
    assert not errors, "\n".join(errors)
    assert all(p.poll() is not None for p in procs)

    got = json.loads(out.read_text())
    assert [len(s) for s in got["shards"]] == [6, 6]
    idx, mo, reads = _dataset()
    torch.set_num_threads(1)
    want = _lines(MappingEngine(idx, mo, batch_size=8, device="cpu",
                                dtw_device_max_n=256, dtw_device_max_b=256),
                  reads)
    assert sorted(got["shards"][0] + got["shards"][1]) == want
    assert got["mapped"] == sum(ln.split("\t")[5] != "*" for ln in want) > 0
