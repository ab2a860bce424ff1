"""Unitig FASTA writer with reference-compatible headers.

Header grammar (the reference bcalm README):

    ><id> LN:i:<length> KC:i:<total> km:f:<mean> L:<+/->:<other>:<+/-> [..]

and with -all-abundance-counts:

    ><id> LN:i:<length> ab:Z:<a_0> .. <a_(len-k)> L:...

IDs are dense integers from 0.

Counterpart of bcalm_tpu/io/fasta_writer.py that takes any object with the
UnitigSet fields (k, seqs, kc, abundances, links), so it imports no
engine.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import IO, List


def _link_index(us):
    """Links grouped by source id.  links are emitted sorted by (src, ...)
    (engine.unitig_links), so the per-unitig slice is a binary search and the
    writer is O(U + E) total."""
    srcs = [l[0] for l in us.links]
    if any(srcs[i] > srcs[i + 1] for i in range(len(srcs) - 1)):
        order = sorted(range(len(srcs)), key=lambda t: srcs[t])
        us_links = [us.links[t] for t in order]
        srcs = [l[0] for l in us_links]
    else:
        us_links = us.links
    return srcs, us_links


def format_header(us, i: int, all_abundance_counts: bool = False,
                  link_index=None) -> str:
    fields = [f"LN:i:{len(us.seqs[i])}"]
    if all_abundance_counts:
        ab = " ".join(str(int(a)) for a in us.abundances[i])
        fields.append(f"ab:Z:{ab}")
    else:
        n_kmers = max(1, len(us.abundances[i]))
        fields.append(f"KC:i:{int(us.kc[i])}")
        fields.append(f"km:f:{us.kc[i] / n_kmers:.1f}")
    srcs, links = link_index if link_index is not None else _link_index(us)
    for t in range(bisect_left(srcs, i), bisect_right(srcs, i)):
        _, su, v, sv = links[t]
        fields.append(f"L:{su}:{v}:{sv}")
    return f">{i} " + " ".join(fields)


def write_fasta(us, out: IO[str], all_abundance_counts: bool = False,
                line_width: int = 0) -> None:
    li = _link_index(us)
    for i, seq in enumerate(us.seqs):
        out.write(format_header(us, i, all_abundance_counts, link_index=li)
                  + "\n")
        if line_width and line_width > 0:
            for j in range(0, len(seq), line_width):
                out.write(seq[j : j + line_width] + "\n")
        else:
            out.write(seq + "\n")


def parse_unitigs_fasta(path: str):
    """Parse a bcalm-format unitigs FASTA back into (seqs, headers) — used
    by resume (-redo-links) and by tests."""
    seqs: List[str] = []
    headers: List[str] = []
    cur: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
                headers.append(line[1:])
            elif line:
                cur.append(line)
        if cur:
            seqs.append("".join(cur))
    return seqs, headers
