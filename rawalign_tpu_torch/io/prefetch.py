"""Copy of rawalign_tpu/io/prefetch.py for the port.

Threaded signal-file ingest.

The reference overlaps FAST5 reading with compute via kt_pipeline step0
(rmap.cpp:824-875, kthread.c:97-159). Here a small thread pool parses
signal files into a bounded queue while the mapping engine consumes it —
host I/O rides worker threads, the GIL is released inside h5py/numpy.

File-level parallelism keeps ordering simple: each worker owns whole
files; reads are yielded file-by-file in the input order (matching the
single-threaded iteration), so output is deterministic.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from rawalign_tpu_torch.io import fast5

_END = object()


def prefetch_signals(
    paths: list[str], n_threads: int = 2, depth: int = 4
) -> Iterator[tuple[str, np.ndarray]]:
    """Yield (read_id, signal) across ``paths`` with background parsing.

    ``depth`` bounds the number of fully-parsed files held in memory.
    Falls back to synchronous iteration for a single file or one thread.
    """
    if n_threads <= 1 or len(paths) <= 1:
        yield from fast5.read_signals(paths)
        return

    results: list[queue.Queue] = [queue.Queue(maxsize=1) for _ in paths]
    next_file = [0]
    lock = threading.Lock()
    sem = threading.Semaphore(depth)  # bound parsed-but-unconsumed files

    def worker():
        while True:
            # Acquire the depth slot BEFORE claiming a file index: every
            # claimed (in-flight) file then holds a slot, so the lowest
            # unconsumed file is always parsed or being parsed and the
            # consumer always makes progress. (Claiming first could let
            # later files exhaust all slots while the lowest-index worker
            # waits on the semaphore -> deadlock.)
            sem.acquire()
            with lock:
                i = next_file[0]
                if i >= len(paths):
                    sem.release()
                    return
                next_file[0] = i + 1
            try:
                batch = list(fast5.read_signals([paths[i]]))
                results[i].put(batch)
            except Exception as e:  # surfaced on the consumer side
                results[i].put(e)

    threads = [
        threading.Thread(target=worker, daemon=True)
        for _ in range(min(n_threads, len(paths)))
    ]
    for t in threads:
        t.start()
    try:
        for i in range(len(paths)):
            batch = results[i].get()
            sem.release()
            if isinstance(batch, Exception):
                raise batch
            yield from batch
    finally:
        with lock:
            next_file[0] = len(paths)  # stop workers early on break
        # unblock any worker waiting on the semaphore
        for _ in threads:
            sem.release()
