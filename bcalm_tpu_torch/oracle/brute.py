"""Brute-force compacted-dBG oracle (pure python, dict-based).

Implements the bi-directed node-centric de Bruijn graph semantics of the
reference EXACTLY as specified in
reference/bidirected-graphs-in-bcalm2/bidirected-graphs-in-bcalm2.md:
  - nodes = canonical solid k-mers (k-mer == its reverse complement,
    README.md:84-85), canonical order is the encoded order A<C<T<G,
  - edges = all (k-1)-overlaps between oriented node spellings (:39-46),
    including self-mirror edges (:30,57),
  - unitigs = maximal bi-directed paths per the degree conditions (:83-88),
  - circular components are emitted as a single unitig broken at the
    minimum-id node (the behavior the reference's
    example/circular_unitigs_unittests fixtures demand).

This stands in for the reference binary (which is not runnable here — the
gatb-core submodule is absent, SURVEY.md §0) as the ground truth that the
TPU engine must match on every fixture, up to orientation/ID permutation.

O(n*k) per dataset: test-scale only.

Copy of ``bcalm_tpu/oracle/brute.py`` with the imports pointed at this package
(and the reference's paths given from its root):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
CHAR = "ACTG"


def str2num(s: str) -> int:
    x = 0
    for c in s:
        x = (x << 2) | CODE[c]
    return x


def num2str(x: int, k: int) -> str:
    return "".join(CHAR[(x >> (2 * (k - 1 - i))) & 3] for i in range(k))


def revcomp_num(x: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | ((x & 3) ^ 2)
        x >>= 2
    return out


def revcomp_str(s: str) -> str:
    m = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(m[c] for c in reversed(s))


def canonical_num(x: int, k: int) -> int:
    return min(x, revcomp_num(x, k))


def count_kmers(seqs: Iterable[str], k: int) -> Dict[int, int]:
    """Canonical k-mer -> count over all reads (non-ACGT splits reads)."""
    counts: Dict[int, int] = {}
    for seq in seqs:
        seq = seq.upper()
        for i in range(len(seq) - k + 1):
            sub = seq[i : i + k]
            if any(c not in "ACGT" for c in sub):
                continue
            c = canonical_num(str2num(sub), k)
            counts[c] = counts.get(c, 0) + 1
    return counts


def solid_kmers(counts: Dict[int, int], abundance_min: int, abundance_max: int = 2**31 - 1):
    return {x: c for x, c in counts.items() if abundance_min <= c <= abundance_max}


@dataclass
class Unitig:
    seq: str
    kc: int                     # total k-mer abundance (KC:i:)
    abundances: List[int]       # per-k-mer abundance along the output orientation
    is_circular: bool = False

    @property
    def km(self) -> float:      # mean abundance (km:f:)
        return self.kc / len(self.abundances)


@dataclass
class CompactedGraph:
    k: int
    unitigs: List[Unitig]
    # links[(u, su, v, sv)] — edge entry L:su:v:sv on unitig u's header
    links: List[Tuple[int, str, int, str]] = field(default_factory=list)


class _BiGraph:
    """Oriented-node adjacency over canonical solid k-mers."""

    def __init__(self, solid: Dict[int, int], k: int):
        self.k = k
        self.solid = solid
        self.mask = (1 << (2 * (k - 1))) - 1

    def spell(self, x: int, o: int) -> int:
        return x if o == 0 else revcomp_num(x, self.k)

    def out_edges(self, x: int, o: int) -> List[Tuple[int, int]]:
        """All oriented out-neighbors of (x, o), including self/mirror loops."""
        k = self.k
        v = self.spell(x, o)
        out = []
        for b in range(4):
            w = ((v << 2) | b) & ((1 << (2 * k)) - 1)
            rw = revcomp_num(w, k)
            cw = min(w, rw)
            if cw not in self.solid:
                continue
            if w == rw:  # palindromic successor (even k only): both orientations
                out.append((cw, 0))
                out.append((cw, 1))
            else:
                out.append((cw, 0 if w == cw else 1))
        return out

    def succ(self, x: int, o: int):
        """Unitig-successor: unique out-edge whose head has in-degree 1 and
        is a different vertex (spec end conditions,
        bidirected-graphs-in-bcalm2.md:83-88)."""
        outs = self.out_edges(x, o)
        if len(outs) != 1:
            return None
        j, q = outs[0]
        if j == x:
            return None  # self-loop or self-mirror: vertex repetition
        # in-degree of (j, q) == out-degree of (j, 1-q) (mirror symmetry)
        if len(self.out_edges(j, 1 - q)) != 1:
            return None
        return (j, q)


def compact(solid: Dict[int, int], k: int) -> CompactedGraph:
    """Maximal unitigs + all mirror link entries of the compacted graph."""
    g = _BiGraph(solid, k)
    nodes = sorted(solid.keys())
    succ: Dict[Tuple[int, int], Tuple[int, int]] = {}
    has_pred: Dict[Tuple[int, int], bool] = {}
    for x in nodes:
        for o in (0, 1):
            s = g.succ(x, o)
            if s is not None:
                succ[(x, o)] = s
                has_pred[s] = True

    visited = set()
    chains: List[Tuple[List[Tuple[int, int]], bool]] = []

    def walk(start):
        chain = [start]
        visited.add(start[0])
        cur = start
        while cur in succ:
            nxt = succ[cur]
            if nxt[0] in visited:  # closed a cycle
                break
            chain.append(nxt)
            visited.add(nxt[0])
            cur = nxt
        return chain

    # path chains from start nodes (deterministic order)
    for x in nodes:
        for o in (0, 1):
            v = (x, o)
            if x in visited:
                continue
            if not has_pred.get(v, False):
                chains.append((walk(v), False))
    # remaining vertices are in cycles: break at the min-id vertex
    for x in nodes:
        if x in visited:
            continue
        chain = walk((x, 0))
        # circular iff the last node's successor closes back to the start
        last = chain[-1]
        circ = succ.get(last) == (x, 0)
        chains.append((chain, circ))

    unitigs: List[Unitig] = []
    ends = []  # (prefix (k-1)-mer str, suffix (k-1)-mer str) per unitig
    for chain, circ in chains:
        x0, o0 = chain[0]
        s = num2str(g.spell(x0, o0), k)
        ab = [solid[x0]]
        for (x, o) in chain[1:]:
            s += CHAR[g.spell(x, o) & 3]
            ab.append(solid[x])
        unitigs.append(Unitig(seq=s, kc=sum(ab), abundances=ab, is_circular=circ))

    # links: all (k-1)-overlaps between unitig extremities
    # (all mirror edges recorded: bidirected-graphs-in-bcalm2.md:101)
    prefix_map: Dict[str, List[Tuple[int, str]]] = {}
    for i, u in enumerate(unitigs):
        for sign, s in (("+", u.seq), ("-", revcomp_str(u.seq))):
            prefix_map.setdefault(s[: k - 1], []).append((i, sign))
    links = []
    for i, u in enumerate(unitigs):
        for sign, s in (("+", u.seq), ("-", revcomp_str(u.seq))):
            for (j, q) in prefix_map.get(s[-(k - 1):], []):
                links.append((i, sign, j, q))
    # deduplicate identical tuples (palindromic prefix==suffix cases)
    links = sorted(set(links))
    return CompactedGraph(k=k, unitigs=unitigs, links=links)


def build(seqs: Iterable[str], k: int, abundance_min: int = 2,
          abundance_max: int = 2**31 - 1) -> CompactedGraph:
    """Full oracle pipeline: count -> solidity filter -> compact."""
    counts = count_kmers(seqs, k)
    return compact(solid_kmers(counts, abundance_min, abundance_max), k)


# ---------------------------------------------------------------------------
# comparison helpers (content-equality oracle, the reference's test semantics:
# reference/test/simple_test.sh compares k-mer content, and BASELINE
# demands equality up to orientation/ID permutation)
# ---------------------------------------------------------------------------

def unitig_key(seq: str) -> str:
    """Orientation-invariant identity of a unitig sequence."""
    return min(seq, revcomp_str(seq))


def circular_key(seq: str, k: int) -> str:
    """Rotation- AND orientation-invariant identity of a CIRCULAR unitig
    (seq carries the k-1 wrap suffix).  A circular unitig's break point is
    algorithm-dependent (the reference gives no stability promise there
    either, cf. its orientation caveat reference/README.md:87), so
    cross-algorithm comparisons must normalize rotation."""
    core = seq[: len(seq) - (k - 1)]
    best = None
    for s in (core, revcomp_str(core)):
        for r in range(len(s)):
            cand = s[r:] + s[:r]
            if best is None or cand < best:
                best = cand
    return best + best[: k - 1]


def content_key(seq: str, k: int, is_circular: bool) -> str:
    """unitig_key for path unitigs, circular_key for circular ones."""
    return circular_key(seq, k) if is_circular else unitig_key(seq)


def canonical_unitig_set(unitigs: Iterable[str]) -> List[str]:
    return sorted(unitig_key(s) for s in unitigs)


def content_unitig_set(seqs, circular, k: int) -> List[str]:
    """canonical_unitig_set with circular unitigs normalized for rotation."""
    return sorted(content_key(s, k, bool(c)) for s, c in zip(seqs, circular))


def unitig_kmer_decomposition(unitigs: Iterable[str], k: int) -> List[int]:
    """All canonical k-mers across unitigs; must equal the solid set with no
    repeats (invariant checked by the reference's unitigEvaluator.cpp:214)."""
    out = []
    for s in unitigs:
        for i in range(len(s) - k + 1):
            out.append(canonical_num(str2num(s[i : i + k]), k))
    return sorted(out)


def canonical_link_set(graph: CompactedGraph) -> List[Tuple]:
    """Orientation/ID-invariant link multiset: each link mapped to
    (key_from, sign_from, key_to, sign_to) with unitig keys and signs
    normalized for the orientation chosen by unitig_key."""
    keys = []
    flips = []
    for u in graph.unitigs:
        # circular unitigs: rotation-invariant identity (their break point
        # is algorithm-dependent); sign normalization is orientation-only
        keys.append(content_key(u.seq, graph.k, u.is_circular))
        flips.append(unitig_key(u.seq) != u.seq)

    def norm(i, s):
        flip = flips[i]
        s2 = s if not flip else ("+" if s == "-" else "-")
        return keys[i], s2

    out = []
    for (i, si, j, sj) in graph.links:
        a = norm(i, si)
        b = norm(j, sj)
        out.append((a[0], a[1], b[0], b[1]))
    return sorted(out)
