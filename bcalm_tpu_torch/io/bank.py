"""Sequence banks: FASTA/FASTQ readers with gzip and file-of-files support.

The TPU-native analog of gatb's bank layer (bank/impl/BankFasta,
BankAlbum, Bank factory — reconstructed, SURVEY.md §3.2; user-facing
format contract: reference/README.md:45-50: "fasta, fastq, either
gzipped or not", and file-of-filenames via `ls -1 *.fastq > list_reads`).

Readers yield raw sequence strings; Sequence objects (with ids/quality)
are available for API parity with gatb's `Sequence` but the hot path
streams plain strings into io.packing.

Copy of ``bcalm_tpu/io/bank.py`` with the imports pointed at this package
(and the reference's paths given from its root):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional


@dataclass
class Sequence:
    """gatb Sequence analog: comment/data(/quality)."""

    comment: str
    data: str
    quality: Optional[str] = None

    def __len__(self) -> int:
        return len(self.data)


def _open_text(path: str):
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "r", encoding="ascii")


def _sniff_format(path: str) -> str:
    """Detect fasta/fastq by first non-empty character (like gatb's Bank
    factory dispatching on content/extension)."""
    with _open_text(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                return "fasta"
            if line.startswith("@"):
                return "fastq"
            break
    raise ValueError(f"unrecognized sequence format: {path}")


def iter_fasta(path: str) -> Iterator[Sequence]:
    comment = None
    chunks: List[str] = []
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if comment is not None:
                    yield Sequence(comment, "".join(chunks))
                comment = line[1:]
                chunks = []
            elif line:
                chunks.append(line.strip())
        if comment is not None:
            yield Sequence(comment, "".join(chunks))


def iter_fastq(path: str) -> Iterator[Sequence]:
    with _open_text(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            header = header.rstrip("\n")
            if not header:
                continue
            if not header.startswith("@"):
                raise ValueError(f"malformed fastq record header: {header!r}")
            data = f.readline().rstrip("\n")
            plus = f.readline()
            if not plus.startswith("+"):
                raise ValueError("malformed fastq: missing '+' line")
            qual = f.readline().rstrip("\n")
            yield Sequence(header[1:], data, qual)


def is_album(path: str) -> bool:
    """A 'file of filenames' (BankAlbum): plain text lines naming files."""
    if path.endswith(".gz"):
        return False
    try:
        with open(path, "r", encoding="ascii") as f:
            first = ""
            for line in f:
                first = line.strip()
                if first:
                    break
        if not first or first[0] in ">@;":
            return False
        cand = first
        if not os.path.isabs(cand):
            cand = os.path.join(os.path.dirname(path), cand)
        return os.path.exists(cand)
    except (UnicodeDecodeError, OSError):
        return False


class Bank:
    """Factory + iterator over one or more sequence files (gatb Bank +
    BankAlbum analog): transparent multi-file concatenation."""

    def __init__(self, paths: List[str]):
        self.paths = paths

    @classmethod
    def open(cls, path: str) -> "Bank":
        if is_album(path):
            base = os.path.dirname(path)
            paths = []
            with open(path, "r", encoding="ascii") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if not os.path.isabs(line):
                        line = os.path.join(base, line)
                    paths.append(line)
            return cls(paths)
        return cls([path])

    def __iter__(self) -> Iterator[Sequence]:
        for p in self.paths:
            fmt = _sniff_format(p)
            it = iter_fasta(p) if fmt == "fasta" else iter_fastq(p)
            yield from it

    def sequences(self) -> Iterator[str]:
        for s in self:
            yield s.data

    def estimate(self, max_records: int = 5000):
        """Rough (#sequences, #bases) estimate by sampling (gatb
        BankEstimator analog, used for progress bars + config sizing)."""
        n = 0
        total = 0
        for s in self:
            n += 1
            total += len(s)
            if n >= max_records:
                break
        if n < max_records:
            return n, total
        # extrapolate by file size ratio
        seen_bytes = sum(os.path.getsize(p) for p in self.paths[:1])
        all_bytes = sum(os.path.getsize(p) for p in self.paths)
        scale = max(1.0, all_bytes / max(1, seen_bytes))
        return int(n * scale), int(total * scale)

    def sample_max_len(self, max_records: int = 5000) -> int:
        """Longest read among the first max_records (block-geometry
        sizing: a max_len far above the real read length leaves chunk
        slots sentinel-filled and wastes sort capacity; longer outlier
        reads simply stream as overlapping windows)."""
        longest = 0
        n = 0
        for s in self:
            longest = max(longest, len(s))
            n += 1
            if n >= max_records:
                break
        return longest
