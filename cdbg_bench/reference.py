"""Plain PyTorch reference of a compacted de Bruijn graph build, and the
comparison that judges a unitigs FASTA against it.

It imports nothing of the program: it reads the generated reads file and,
to judge it, the FASTA that a build wrote.  Every step is a handful of
torch operations (sorts, gathers, scans), so it runs on the card after the
measured window, or on the CPU at a test's size.

Semantics (BCALM 2's bi-directed node-centric graph, as the program's
docs state them): nodes are canonical k-mers with count in
[abundance_min, ABUNDANCE_MAX]; an oriented node (v, o) spells v (o = 0)
or its reverse complement (o = 1); (v, o) -> (w, q) when the last k-1
bases of one spelling are the first k-1 of the other; the unitig successor
of (v, o) is its only out-neighbour (w, q) when (w, q) has one in-neighbour
and w != v.  Unitigs are the maximal paths of unitig successors (a cycle
is one unitig), and a unitig's links (``L:s:v:q``) are every out-edge of
its last k-mer in orientation s to the first k-mer of unitig v in
orientation q.

K-mers are packed into int64 words of 31 bases (62 bits, so signed order
is lexicographic order), the first base most significant; the last word
holds the k mod 31 remaining bases.  Codes here are A=0 C=1 G=2 T=3, so a
base's complement is 3 - code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

BASES_PER_WORD = 31
ASCII_TO_CODE = np.full(256, -1, np.int8)
for _c, _v in zip(b"ACGT", range(4)):
    ASCII_TO_CODE[_c] = _v
    ASCII_TO_CODE[_c + 32] = _v
CODE_TO_ASCII = np.frombuffer(b"ACGT", np.uint8)
HASH_MUL = 0x9E3779B97F4A7C15 - (1 << 64)   # as a signed int64
ABUNDANCE_MAX = 2**31 - 1   # the CLI's default -abundance-max


def word_lens(k: int) -> List[int]:
    full, rest = divmod(k, BASES_PER_WORD)
    return [BASES_PER_WORD] * full + ([rest] if rest else [])


# ---------------------------------------------------------------------------
# packed words
# ---------------------------------------------------------------------------

def window_words(codes: torch.Tensor, k: int) -> List[torch.Tensor]:
    """The packed words of the k-mer starting at each position of a 1-D
    code sequence: W tensors of len(codes) - k + 1 (k-mers that cross
    the end of a record are the caller's to drop)."""
    T = codes.numel()
    n = max(T - k + 1, 0)
    packed = {}
    for l in set(word_lens(k)):
        m = max(T - l + 1, 0)
        p = torch.zeros(m, dtype=torch.int64, device=codes.device)
        for t in range(l):
            p <<= 2
            p |= codes[t:t + m].to(torch.int64)
        packed[l] = p
    return [packed[l][BASES_PER_WORD * j:BASES_PER_WORD * j + n]
            for j, l in enumerate(word_lens(k))]


def unpack(words: List[torch.Tensor], k: int) -> torch.Tensor:
    """(N, k) int8 codes of packed k-mers."""
    cols = []
    for w, l in zip(words, word_lens(k)):
        for t in range(l):
            cols.append(((w >> (2 * (l - 1 - t))) & 3).to(torch.int8))
    return torch.stack(cols, dim=1)


def push_back(words, b, k: int):
    """The spelling's last k-1 bases followed by base b."""
    lens = word_lens(k)
    out = []
    for j, l in enumerate(lens):
        nxt = (words[j + 1] >> (2 * (lens[j + 1] - 1))
               if j + 1 < len(lens) else b)
        out.append(((words[j] << 2) | nxt) & ((1 << (2 * l)) - 1))
    return out


def push_front(words, b, k: int):
    """Base b followed by the spelling's first k-1 bases."""
    out = []
    for j, l in enumerate(word_lens(k)):
        prv = words[j - 1] & 3 if j else b
        out.append((prv << (2 * (l - 1))) | (words[j] >> 2))
    return out


def lex_less(a, b):
    """(a < b, a == b) columnwise over word lists, most significant first."""
    lt = torch.zeros_like(a[0], dtype=torch.bool)
    eq = torch.ones_like(lt)
    for x, y in zip(a, b):
        lt |= eq & (x < y)
        eq &= x == y
    return lt, eq


def lexsort(words: List[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting columns by the words, most significant
    first."""
    perm = torch.arange(words[0].numel(), device=words[0].device)
    for w in reversed(words):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    return perm


def lookup(keys: List[torch.Tensor], query: List[torch.Tensor]) -> torch.Tensor:
    """Index of each query column among the sorted distinct keys, -1 where
    it is absent."""
    n, m = keys[0].numel(), query[0].numel()
    dev = keys[0].device
    if m == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    if n == 0:
        return torch.full((m,), -1, dtype=torch.int64, device=dev)
    if len(keys) == 1:
        pos = torch.searchsorted(keys[0], query[0]).clamp(max=n - 1)
        return torch.where(keys[0][pos] == query[0], pos, -1)
    tag = torch.cat([torch.zeros(n, dtype=torch.int64, device=dev),
                     torch.ones(m, dtype=torch.int64, device=dev)])
    perm = lexsort([torch.cat([a, b]) for a, b in zip(keys, query)] + [tag])
    is_key = perm < n
    at = torch.arange(n + m, device=dev)
    last = torch.where(is_key, at, -1).cummax(0).values
    sel = ~is_key
    qi = perm[sel] - n
    cand = perm[last[sel].clamp(min=0)]
    ok = last[sel] >= 0
    cand = torch.where(ok, cand, 0)
    for kw, qw in zip(keys, query):
        ok &= kw[cand] == qw[qi]
    out = torch.full((m,), -1, dtype=torch.int64, device=dev)
    out[qi] = torch.where(ok, cand, -1)
    return out


def canonical(fwd, rc):
    """(canonical words, the other strand's words, orientation: 1 where
    the canonical form is the reverse complement)."""
    lt, eq = lex_less(rc, fwd)
    canon = [torch.where(lt, r, f) for f, r in zip(fwd, rc)]
    other = [torch.where(lt, f, r) for f, r in zip(fwd, rc)]
    return canon, other, lt.to(torch.int64), eq


def kmers_of(codes: torch.Tensor, starts: torch.Tensor, n_kmers: torch.Tensor,
             k: int):
    """Forward and reverse-complement words of every k-mer that lies
    inside a record of the 1-D code sequence (records at `starts`, with
    n_kmers k-mers each), in record order."""
    fwd_all = window_words(codes, k)
    rc_all = [w.flip(0) for w in window_words((3 - codes).flip(0), k)]
    total = int(n_kmers.sum())
    rec_first = torch.cumsum(n_kmers, 0) - n_kmers
    pos = (torch.arange(total, device=codes.device)
           + torch.repeat_interleave(starts - rec_first, n_kmers))
    return [w[pos] for w in fwd_all], [w[pos] for w in rc_all]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def read_records(path: str):
    """(codes uint8 1-D, starts, lengths) of a FASTA file of one-line
    records; a base outside ACGT raises (the generator writes none)."""
    data = np.fromfile(path, dtype=np.uint8)
    nl = np.flatnonzero(data == 10)
    line_start = np.concatenate([[0], nl[:-1] + 1])
    is_seq = data[line_start] != ord(">")
    s, e = line_start[is_seq], nl[is_seq]
    if len(s) > 1 and np.all(np.diff(s) == s[1] - s[0]) and np.all(
            e - s == e[0] - s[0]):
        L = int(e[0] - s[0])
        stride = int(s[1] - s[0])
        seq = np.lib.stride_tricks.as_strided(
            data[s[0]:], shape=(len(s), L), strides=(stride, 1)).reshape(-1)
        starts = np.arange(len(s), dtype=np.int64) * L
        lengths = np.full(len(s), L, np.int64)
    else:
        lengths = (e - s).astype(np.int64)
        starts = np.cumsum(lengths) - lengths
        seq = np.concatenate([data[a:b] for a, b in zip(s, e)]) if len(s) \
            else np.zeros(0, np.uint8)
    codes = ASCII_TO_CODE[seq]
    if (codes < 0).any():
        raise ValueError(f"{path}: a base outside ACGT")
    return codes.astype(np.uint8), starts, lengths


# ---------------------------------------------------------------------------
# counting, solidity, graph
# ---------------------------------------------------------------------------

@dataclass
class Solid:
    """The solid canonical k-mers, sorted: words, the reverse complement's
    words, counts, and the graph's unitig successor of each oriented node
    (state 2 v + o; -1 where none)."""
    k: int
    keys: List[torch.Tensor]
    other: List[torch.Tensor]
    counts: torch.Tensor
    succ: Optional[torch.Tensor] = None
    label: Optional[torch.Tensor] = None
    stats: Dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.counts.numel())

    def spell(self, states: torch.Tensor) -> List[torch.Tensor]:
        v, o = states // 2, (states % 2).bool()
        return [torch.where(o, b[v], a[v]) for a, b in zip(self.keys, self.other)]


def count_kmers(reads_path: str, k: int, device):
    """Distinct canonical k-mers of the reads, sorted: (keys, other, counts,
    occurrences)."""
    codes, starts, lengths = read_records(reads_path)
    codes = torch.from_numpy(codes).to(device)
    n_k = torch.from_numpy(np.maximum(lengths - k + 1, 0)).to(device)
    fwd, rc = kmers_of(codes, torch.from_numpy(starts).to(device), n_k, k)
    del codes
    canon, other, _, _ = canonical(fwd, rc)
    del fwd, rc
    occ = canon[0].numel()
    perm = lexsort(canon)
    canon = [w[perm] for w in canon]
    head = torch.ones(occ, dtype=torch.bool, device=device)
    if occ > 1:
        diff = torch.zeros(occ - 1, dtype=torch.bool, device=device)
        for w in canon:
            diff |= w[1:] != w[:-1]
        head[1:] = diff
    first = torch.nonzero(head).flatten()
    counts = torch.diff(first, append=torch.tensor([occ], device=device))
    keys = [w[first] for w in canon]
    other = [w[perm[first]] for w in other]
    return keys, other, counts, occ


def sketch_counts(keys, counts: torch.Tensor, bits: int) -> torch.Tensor:
    """The count of each distinct k-mer as a one-row count sketch of
    2**bits counters keyed by a hash of the k-mer would give it: the sum
    over every k-mer that shares its counter (the control's counts)."""
    h = torch.zeros_like(keys[0])
    for w in keys:
        h = (h ^ w) * HASH_MUL
        h ^= h >> 29
    h = (h >> 3) & ((1 << bits) - 1)
    uniq, inv = torch.unique(h, return_inverse=True)
    tot = torch.zeros(uniq.numel(), dtype=counts.dtype, device=counts.device)
    tot.index_add_(0, inv, counts)
    return tot[inv]


def solid_of(keys, other, counts, k: int, amin: int) -> Solid:
    keep = (counts >= amin) & (counts <= ABUNDANCE_MAX)
    return Solid(k=k, keys=[w[keep] for w in keys],
                 other=[w[keep] for w in other], counts=counts[keep])


def out_edges(sol: Solid, spell, rc_spell):
    """For spelled oriented k-mers: per base b, the out-neighbour's state
    (2 v + q, -1 where not solid) and its multiplicity (2 for a
    self-complementary neighbour, which both orientations reach)."""
    res = []
    for b in range(4):
        ext = push_back(spell, b, sol.k)
        rext = push_front(rc_spell, 3 - b, sol.k)
        canon, _, q, pal = canonical(ext, rext)
        v = lookup(sol.keys, canon)
        res.append((torch.where(v >= 0, 2 * v + q, -1),
                    (v >= 0).to(torch.int64) * (1 + pal.to(torch.int64))))
    return res


def build_graph(sol: Solid) -> None:
    """sol.succ (unitig successor of each state) and sol.label (the least
    node of each node's unitig)."""
    dev = sol.counts.device
    N = 2 * sol.n
    outdeg = torch.zeros(N, dtype=torch.int64, device=dev)
    target = torch.full((N,), -1, dtype=torch.int64, device=dev)
    for o, (sp, rs) in enumerate(((sol.keys, sol.other),
                                  (sol.other, sol.keys))):
        for t, mult in out_edges(sol, sp, rs):
            outdeg[o::2] += mult
            target[o::2] = torch.where(t >= 0, t, target[o::2])
    s = torch.arange(N, device=dev)
    tgt = target.clamp(min=0)
    glued = ((outdeg == 1) & (target >= 0) & (outdeg[tgt ^ 1] == 1)
             & (tgt // 2 != s // 2))
    sol.succ = torch.where(glued, target, -1)
    sol.label = _labels(sol.succ)
    sol.stats["unitigs"] = int(torch.unique(sol.label).numel())


def _rounds(n: int) -> int:
    return max(1, int(n).bit_length() + 1)


def _labels(succ: torch.Tensor) -> torch.Tensor:
    """Least node reachable from either orientation of each node: the
    same for every node of one unitig (path or cycle), by doubling."""
    N = succ.numel()
    s = torch.arange(N, device=succ.device)
    nxt = torch.where(succ >= 0, succ, s)
    lab = s // 2
    for _ in range(_rounds(N)):
        lab = torch.minimum(lab, lab[nxt])
        nxt = nxt[nxt]
    return torch.minimum(lab[0::2], lab[1::2])


def reference(reads_path: str, k: int, amin: int, device,
              sketch_bits: Optional[int] = None) -> Solid:
    """The reference's solid graph of the reads (with sketch_bits, the
    control's: counts from a count sketch of that many bits)."""
    keys, other, counts, occ = count_kmers(reads_path, k, device)
    distinct = counts.numel()
    if sketch_bits is not None:
        counts = sketch_counts(keys, counts, sketch_bits)
    sol = solid_of(keys, other, counts, k, amin)
    del keys, other, counts
    build_graph(sol)
    sol.stats.update(kmer_occurrences=occ, distinct_kmers=distinct,
                     solid_kmers=sol.n)
    return sol


# ---------------------------------------------------------------------------
# unitigs of the reference (the control's output)
# ---------------------------------------------------------------------------

def unitig_order(sol: Solid):
    """The reference's unitigs: (states in unitig order, unitig of each,
    position in it), each path read from its least start state, each
    cycle cut before its least node in orientation 0."""
    dev = sol.counts.device
    N = 2 * sol.n
    s = torch.arange(N, device=dev)
    succ = sol.succ.clone()
    lab = sol.label[s // 2]
    start = succ[s ^ 1] < 0
    has_start = torch.zeros(sol.n, dtype=torch.bool, device=dev)
    has_start[lab[start]] = True
    x0 = torch.nonzero(~has_start[sol.label]
                       & (sol.label == torch.arange(sol.n, device=dev))).flatten()
    if x0.numel():
        pred = succ[2 * x0 + 1] ^ 1
        succ[pred] = -1
        succ[2 * x0 + 1] = -1
    nxt = torch.where(succ >= 0, succ, s)
    dist = (succ >= 0).to(torch.int64)
    for _ in range(_rounds(N)):
        dist = dist + dist[nxt]
        nxt = nxt[nxt]
    start = succ[s ^ 1] < 0
    big = torch.full((sol.n,), N, dtype=torch.int64, device=dev)
    s0 = big.scatter_reduce(0, lab[start], s[start], "amin")
    first = s0[sol.label]                       # per node
    o = (nxt[2 * torch.arange(sol.n, device=dev)] != nxt[first]).to(torch.int64)
    state = 2 * torch.arange(sol.n, device=dev) + o
    pos = dist[first] - dist[state]
    order = lexsort([first, pos])
    starts_sorted = torch.unique(first)
    uid = torch.searchsorted(starts_sorted, first)
    return state[order], uid[order], pos[order]


def emit_fasta(sol: Solid, path: str) -> None:
    """Write the reference's unitigs as the program writes them: dense
    ids, LN, KC, km and the links."""
    k = sol.k
    states, uid, pos = unitig_order(sol)
    U = int(uid.max()) + 1 if uid.numel() else 0
    n_u = torch.bincount(uid, minlength=U)
    is_first = pos == 0
    is_last = torch.ones_like(is_first)
    if uid.numel() > 1:
        is_last[:-1] = uid[1:] != uid[:-1]
    s_first, s_last = states[is_first], states[is_last]
    kc = torch.zeros(U, dtype=torch.int64, device=uid.device)
    kc.index_add_(0, uid, sol.counts[states // 2])
    spells = sol.spell(states)
    last_base = (spells[-1] & 3).to(torch.int8)
    prefix = unpack(sol.spell(s_first), k)[:, :k - 1]
    lens = (n_u + k - 1).cpu().numpy()
    off = np.cumsum(lens) - lens
    buf = np.empty(int(lens.sum()), np.int8)
    pre_idx = off[:, None] + np.arange(k - 1)[None, :]
    buf[pre_idx.reshape(-1)] = prefix.cpu().numpy().reshape(-1)
    buf[off[uid.cpu().numpy()] + k - 1 + pos.cpu().numpy()] = \
        last_base.cpu().numpy()
    text = CODE_TO_ASCII[buf].tobytes().decode()
    links = expected_links(sol, sol.spell(s_first), sol.spell(s_first ^ 1),
                           sol.spell(s_last), sol.spell(s_last ^ 1),
                           s_first, s_last)
    links = np.sort(links)
    src = links >> 33
    lo = np.searchsorted(src, np.arange(2 * U))
    hi = np.searchsorted(src, np.arange(2 * U), side="right")
    kc_h = kc.cpu().numpy()
    n_h = n_u.cpu().numpy()
    with open(path, "w") as f:
        for u in range(U):
            fields = [f"LN:i:{lens[u]}", f"KC:i:{kc_h[u]}",
                      f"km:f:{kc_h[u] / n_h[u]:.1f}"]
            for sign in (0, 1):
                for c in links[lo[2 * u + sign]:hi[2 * u + sign]]:
                    dst = int(c & ((1 << 33) - 1)) - 1
                    fields.append(f"L:{'+-'[sign]}:{dst // 2}:{'+-'[dst % 2]}")
            f.write(f">{u} {' '.join(fields)}\n"
                    f"{text[off[u]:off[u] + lens[u]]}\n")


# ---------------------------------------------------------------------------
# links
# ---------------------------------------------------------------------------

def expected_links(sol: Solid, first_fwd, first_rc, last_fwd, last_rc,
                   s_first, s_last) -> np.ndarray:
    """The links of unitigs whose first and last k-mers are spelled as
    given (states s_first, s_last, -1 where a k-mer is not solid), as
    codes (2 u + s) << 33 | (2 v + q + 1); a link to a k-mer that starts
    no unitig in any orientation has v q = -1 (no FASTA can match it)."""
    U = s_first.numel()
    dev = s_first.device
    start_of = torch.full((2 * sol.n,), -1, dtype=torch.int64, device=dev)
    u = torch.arange(U, device=dev)
    ok = s_first >= 0
    start_of[s_first[ok]] = 2 * u[ok]
    ok = s_last >= 0
    start_of[s_last[ok] ^ 1] = 2 * u[ok] + 1
    out = []
    for sign, (sp, rs) in enumerate(((last_fwd, last_rc),
                                     (first_rc, first_fwd))):
        for t, mult in out_edges(sol, sp, rs):
            hit = mult > 0
            dst = torch.where(hit, start_of[t.clamp(min=0)], -1)
            code = ((2 * u + sign) << 33) | (dst + 1)
            out.append(code[hit])
            # a self-complementary neighbour is linked in both orientations
            pal = mult == 2
            if pal.any():
                dst2 = start_of[(t ^ 1).clamp(min=0)]
                out.append((((2 * u + sign) << 33) | (dst2 + 1))[pal])
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.int64)


# ---------------------------------------------------------------------------
# judging a unitigs FASTA
# ---------------------------------------------------------------------------

CHECKS = ("kmer_errors", "unitig_errors", "abundance_errors", "link_errors")


def parse_fasta(path: str):
    """(headers, sequences) of a unitigs FASTA (one-line or wrapped)."""
    headers, seqs, cur = [], [], []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if headers:
                    seqs.append("".join(cur))
                cur = []
                headers.append(line[1:])
            elif line:
                cur.append(line)
    if headers:
        seqs.append("".join(cur))
    return headers, seqs


def _multiset_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Size of the symmetric difference of two multisets of codes."""
    ua, ca = np.unique(a, return_counts=True)
    ub, cb = np.unique(b, return_counts=True)
    both = np.union1d(ua, ub)
    na = np.zeros(both.size, np.int64)
    nb = np.zeros(both.size, np.int64)
    na[np.searchsorted(both, ua)] = ca
    nb[np.searchsorted(both, ub)] = cb
    return int(np.abs(na - nb).sum())


def judge(sol: Solid, fasta_path: str):
    """Compare a unitigs FASTA with the reference graph: (the compared
    numbers, the parts they were summed from).  Every compared number is
    a count of disagreements (0 when the FASTA is the reference's graph):

    kmer_errors: k-mers of the unitigs that are not solid, solid k-mers
      in no unitig, and repeats;
    unitig_errors: adjacent k-mers of a unitig that are not unitig
      successors in the reference, the gap between the number of unitigs
      and the reference's, ids that are not 0..U-1 in order, and LN fields
      that are not the length;
    abundance_errors: KC fields that are not the sum of the reference's
      counts of the unitig's k-mers, and km fields that are not KC over
      the k-mers to one decimal;
    link_errors: the symmetric difference of the L: records and the
      reference's links of these unitigs."""
    k = sol.k
    dev = sol.counts.device
    headers, seqs = parse_fasta(fasta_path)
    U = len(seqs)
    fields = [h.split() for h in headers]
    head_err = 0
    kc_prog, km_prog, prog_links = [], [], []
    for u, (f, seq) in enumerate(zip(fields, seqs)):
        tags = {}
        for x in f[1:]:
            if x.startswith("L:"):
                _, su, v, sv = x.split(":")
                prog_links.append(((2 * u + (su == "-")) << 33)
                                  | (2 * int(v) + (sv == "-") + 1))
            else:
                tags[x[:4]] = x[5:]
        head_err += (f[0] != str(u)) + (tags.get("LN:i") != str(len(seq)))
        kc_prog.append(int(tags.get("KC:i", -1)))
        km_prog.append(tags.get("km:f"))
    lens = np.array([len(s) for s in seqs], np.int64)
    n_k = np.maximum(lens - k + 1, 0)
    head_err += int((lens < k).sum())
    raw = np.frombuffer("".join(seqs).encode(), np.uint8)
    codes = ASCII_TO_CODE[raw]
    bad_base = int((codes < 0).sum())
    codes = torch.from_numpy(np.maximum(codes, 0).astype(np.uint8)).to(dev)
    starts = torch.from_numpy(np.cumsum(lens) - lens).to(dev)
    n_kt = torch.from_numpy(n_k).to(dev)
    fwd, rc = kmers_of(codes, starts, n_kt, k)
    canon, _, o, _ = canonical(fwd, rc)
    vid = lookup(sol.keys, canon)
    state = torch.where(vid >= 0, 2 * vid + o, -1)
    uid = torch.repeat_interleave(torch.arange(U, device=dev), n_kt)

    hit = vid >= 0
    mult = torch.bincount(vid[hit], minlength=sol.n)
    kmer_errors = (int((~hit).sum()) + int((mult == 0).sum())
                   + int((mult - 1).clamp(min=0).sum()) + bad_base)

    same = uid[1:] == uid[:-1]
    a, b = state[:-1][same], state[1:][same]
    order_err = int(((a < 0) | (b < 0)
                     | (sol.succ[a.clamp(min=0)] != b)).sum())
    unitig_errors = order_err + abs(U - sol.stats["unitigs"]) + head_err

    kc = torch.zeros(U, dtype=torch.int64, device=dev)
    kc.index_add_(0, uid, torch.where(hit, sol.counts[vid.clamp(min=0)], 0))
    kc = kc.cpu().numpy()
    abundance_errors = int((kc != np.array(kc_prog, np.int64)).sum())
    abundance_errors += sum(
        km != f"{c / max(1, n):.1f}" for km, c, n in zip(km_prog, kc, n_k))

    first = torch.from_numpy(np.cumsum(n_k) - n_k).to(dev)
    last = first + n_kt - 1
    has = n_kt > 0
    first, last = first[has], last[has]
    exp = expected_links(
        sol, [w[first] for w in fwd], [w[first] for w in rc],
        [w[last] for w in fwd], [w[last] for w in rc],
        state[first], state[last])
    if not bool(has.all()):   # ids of unitigs too short to hold a k-mer
        exp_u = np.flatnonzero(has.cpu().numpy())
        src = exp >> 33
        exp = (exp_u[src // 2] * 2 + src % 2) << 33 | (exp & ((1 << 33) - 1))
    link_errors = _multiset_diff(exp, np.array(prog_links, np.int64))
    detail = {"not_solid": int((~hit).sum()), "solid_missing":
              int((mult == 0).sum()), "repeated":
              int((mult - 1).clamp(min=0).sum()), "bad_bases": bad_base,
              "unitigs": U, "reference_unitigs": sol.stats["unitigs"],
              "unglued_adjacent": order_err, "header_errors": head_err,
              "links": len(prog_links), "reference_links": len(exp)}
    return {"kmer_errors": kmer_errors, "unitig_errors": unitig_errors,
            "abundance_errors": abundance_errors,
            "link_errors": link_errors}, detail
