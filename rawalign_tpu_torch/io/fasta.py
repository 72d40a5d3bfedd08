"""Copy of rawalign_tpu/io/fasta.py for the port.

Minimal FASTA/FASTQ reader (host side).

Replaces the reference's minimap2-derived batch reader (src/bseq.{h,c},
src/kseq.h) with a plain Python generator; sequences feed the host-side
index build, so throughput here is not on the mapping hot path.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator


@dataclasses.dataclass
class Sequence:
    name: str
    seq: str
    rid: int = -1


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def read_fasta(path: str) -> Iterator[Sequence]:
    """Yield sequences from a FASTA or FASTQ file (plain or gzipped)."""
    with _open(path) as f:
        name, parts, mode = None, [], None
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line[0] == ">":
                mode = "fasta"
                if name is not None:
                    yield Sequence(name, "".join(parts))
                name = line[1:].split()[0]
                parts = []
            elif line[0] == "@" and mode != "fasta":
                name = line[1:].split()[0]
                seq = f.readline().strip()
                f.readline()  # '+' separator
                f.readline()  # quality line
                yield Sequence(name, seq)
                name = None
            else:
                parts.append(line)
        if mode == "fasta" and name is not None:
            yield Sequence(name, "".join(parts))


def write_fasta(path: str, seqs: list[tuple[str, str]], width: int = 80) -> None:
    with open(path, "w") as f:
        for name, seq in seqs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + "\n")
