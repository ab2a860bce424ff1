"""Navigation API over a built compacted graph.

The analog of gatb's GraphUnitigsTemplate<span> node/edge navigation
(debruijn/impl/GraphUnitigs — reconstructed, SURVEY.md §3.2), which
downstream tools (minia-style traversals) use on top of bcalm's output.
The reference CLI itself builds with load=false
(the reference's src/bcalm_1.cpp:57); this API is the load=true side:
query nodes (oriented unitigs), degrees, successors, and spell walks.

Backed by plain host data (unitig strings + link tuples), so it can be
constructed either from a live engine.UnitigSet or by loading a unitigs
FASTA written earlier.

Copy of ``bcalm_tpu/graph/unitigs.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from ..utils import dna


@dataclass(frozen=True)
class Node:
    """An oriented unitig (the node of the compacted bi-directed graph)."""

    uid: int
    strand: str  # '+' or '-'

    def reverse(self) -> "Node":
        return Node(self.uid, "-" if self.strand == "+" else "+")


class UnitigGraph:
    def __init__(self, k: int, seqs: List[str],
                 links: List[Tuple[int, str, int, str]]):
        self.k = k
        self.seqs = seqs
        self._out: Dict[Tuple[int, str], List[Node]] = {}
        for (u, su, v, sv) in links:
            self._out.setdefault((u, su), []).append(Node(v, sv))

    @classmethod
    def from_unitig_set(cls, us) -> "UnitigGraph":
        return cls(us.k, list(us.seqs), list(us.links))

    @classmethod
    def load(cls, unitigs_fasta: str, k: int) -> "UnitigGraph":
        from ..io.fasta_writer import parse_unitigs_fasta

        seqs, headers = parse_unitigs_fasta(unitigs_fasta)
        links = []
        for i, h in enumerate(headers):
            for tok in h.split(" "):
                if tok.startswith("L:"):
                    _, su, v, sv = tok.split(":")
                    links.append((i, su, int(v), sv))
        return cls(k, seqs, links)

    # --- node queries -----------------------------------------------------

    def __len__(self) -> int:
        return len(self.seqs)

    def nodes(self) -> Iterator[Node]:
        for u in range(len(self.seqs)):
            yield Node(u, "+")

    def sequence(self, node: Node) -> str:
        s = self.seqs[node.uid]
        return s if node.strand == "+" else dna.revcomp(s)

    def length(self, node: Node) -> int:
        return len(self.seqs[node.uid])

    def successors(self, node: Node) -> List[Node]:
        return list(self._out.get((node.uid, node.strand), []))

    def predecessors(self, node: Node) -> List[Node]:
        # in-edges of (u,s) are mirrors of out-edges of (u,!s)
        return [n.reverse() for n in self.successors(node.reverse())]

    def out_degree(self, node: Node) -> int:
        return len(self.successors(node))

    def in_degree(self, node: Node) -> int:
        return len(self.predecessors(node))

    def is_branching(self, node: Node) -> bool:
        return self.out_degree(node) > 1 or self.in_degree(node) > 1

    # --- walks ------------------------------------------------------------

    def spell_walk(self, walk: List[Node]) -> str:
        """Spell the string of a walk (k-1 overlaps between consecutive
        nodes; spelling rule of bidirected-graphs-in-bcalm2.md:39-53)."""
        if not walk:
            return ""
        out = self.sequence(walk[0])
        for prev, cur in zip(walk, walk[1:]):
            if cur not in self.successors(prev):
                raise ValueError(f"not an edge: {prev} -> {cur}")
            out += self.sequence(cur)[self.k - 1:]
        return out

    def simple_path_forward(self, node: Node, max_steps: int = 10**6) -> List[Node]:
        """Extend through non-branching successors (minia-style traversal)."""
        walk = [node]
        seen = {node.uid}
        cur = node
        for _ in range(max_steps):
            succs = self.successors(cur)
            if len(succs) != 1:
                break
            nxt = succs[0]
            if nxt.uid in seen or len(self.predecessors(nxt)) != 1:
                break
            walk.append(nxt)
            seen.add(nxt.uid)
            cur = nxt
        return walk
