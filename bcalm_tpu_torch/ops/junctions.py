"""Junction classification: the (k-1)-overlap successor array (K3).

Counterpart of ``bcalm_tpu/ops/junctions.py:successor_arrays``.  Oriented
node (i, +) = i and (i, -) = i + C.  Each k-mer side (suffix, prefix)
emits its strand-0 representative entry keyed by its canonical (k-1)-mer
with payload ``oid | role << 30``; palindromic sides are dropped.  After
the sort, a group of exactly two entries, one OUT and one IN on distinct
vertices, is a unitig edge: ``succ[src] = dst`` and its mirror edge.

The key is always the exact (k-1)-mer.  Up to 3 lanes (k-1 <= 48) K3a
writes its lanes as rows and ``sort.lex_sort`` packs them (one or two
words); past 3 lanes it writes the W = ceil(L2/2) packed words itself
(models.lanes.pack_keys) and ``sort.lex_sort_words`` sorts them.  The JAX
package keys k-1 > 48 by a 96-bit hash instead, in which two (k-1)-mers
can collide (a flip of bit 31 in two adjacent lanes cancels): the port's
groups differ from JAX's only at such collisions.

:func:`junction_keys` and :func:`junction_pairs` launch the CUDA kernels
(csrc/junctions.cu) for CUDA tensors and run their plain versions for
CPU tensors; the sort between them is ``torch.sort``, whose sorted top
word, permutation, the lower words and the unsorted payload are what the
pair step reads.
"""

from __future__ import annotations

import functools

import torch

from bcalm_tpu_torch.models import lanes as ln
from bcalm_tpu_torch.ops import _kernels
from bcalm_tpu_torch.ops import sort as sort_op
from bcalm_tpu_torch.utils.timeinfo import span

SENTINEL = ln.SENTINEL
ROLE_OUT = 0
_ROLE_SHIFT = 30
_OID_MASK = (1 << 30) - 1


def packed_keys(k: int) -> bool:
    """K3a writes the packed key words when the key has more than 3 lanes
    (k-1 > 48), else the key lanes as rows."""
    return ln.num_lanes(k - 1) > 3


def key_words(k: int) -> int:
    """Packed words a junction key sorts on: ceil(L2 / 2) of its L2 lanes."""
    return (ln.num_lanes(k - 1) + 1) // 2


def key_rows(k: int) -> int:
    """Rows of K3a's key output: the packed words past 3 lanes, else the
    lanes."""
    return key_words(k) if packed_keys(k) else ln.num_lanes(k - 1)


def junction_keys_plain(solid: torch.Tensor, n_solid: int, k: int):
    """Plain PyTorch version of the key-build kernel: returns
    (keys (key_rows(k), 2C), payload (2C,)), suffix entries at [0, C),
    prefix entries at [C, 2C); an invalid or palindromic side's lanes are
    all the sentinel."""
    C = solid.shape[1]
    suf = ln.suffix_kminus1(solid, k)
    pre = ln.prefix_kminus1(solid, k)
    suf_c, sig = ln.canonical(suf, k - 1)
    pre_c, tau = ln.canonical(pre, k - 1)
    ids = torch.arange(C, device=solid.device)
    valid = ids < n_solid
    vs = valid & ~ln.is_palindrome(suf, k - 1)
    vp = valid & ~ln.is_palindrome(pre, k - 1)
    oid_s = torch.where(sig, ids + C, ids)
    oid_p = torch.where(tau, ids + C, ids)
    payload = torch.cat([oid_s | (sig.to(torch.int64) << _ROLE_SHIFT),
                         oid_p | ((~tau).to(torch.int64) << _ROLE_SHIFT)])
    keys = torch.cat([torch.where(vs[None], suf_c, SENTINEL),
                      torch.where(vp[None], pre_c, SENTINEL)], dim=1)
    return (ln.pack_rows(keys) if packed_keys(k) else keys), payload


def junction_keys(solid: torch.Tensor, n_solid: int, k: int):
    if solid.device.type == "cpu":
        return junction_keys_plain(solid, n_solid, k)
    return _kernels.junction_keys(solid, n_solid, k, packed_keys(k),
                                  key_rows(k))


@functools.lru_cache(maxsize=None)
def sentinel_words(K: int):
    """(sent0, shift) of a key of K lanes: the top packed word of an
    all-sentinel key (models.lanes.pack_keys) and the shift that takes a
    top word to its first lane (32 when it packs two lanes).  A key is a
    sentinel when top_word >> shift equals sent0 >> shift: its first lane
    is the sentinel."""
    word = int(ln.pack_keys([torch.tensor(SENTINEL)] * min(K, 2))[0])
    return word, 32 if K >= 2 else 0


def exact_sentinel(K: int) -> bool:
    """Whether a junction key of K lanes is the sentinel only where its
    last lane is too.  Past 3 lanes (packed keys) it is: a valid canonical
    (k-1)-mer whose first lane is 16 G ends in 16 C, so its last lane is
    never the sentinel.  Up to 3 lanes the first lane decides alone, as in
    bcalm_tpu, whose FASTA the port matches byte for byte there."""
    return K > 3


def pair_heads(s_word: torch.Tensor, s_lower, K: int, exact: bool = False):
    """Pair heads of the sorted entries: the first entry of each group of
    exactly two equal keys, the key not a sentinel (bcalm_tpu
    junctions.successor_arrays :207-216).  s_word: the top packed words in
    sorted order; s_lower: the lower packed words in sorted order (W-1,
    E), or None; K: the key's lanes; exact: the last lane decides too
    (:func:`exact_sentinel`).  Equal packed words mean equal keys:
    pack_keys is a bijection on u32 pairs."""
    sent0, shift = sentinel_words(K)
    s_valid = (s_word >> shift) != (sent0 >> shift)
    if exact:
        last = s_word if s_lower is None else s_lower[-1]
        s_valid |= (last & SENTINEL) != SENTINEL
    f = torch.zeros((1,), dtype=torch.bool, device=s_word.device)
    eq = s_word[1:] == s_word[:-1]
    if s_lower is not None:
        eq &= (s_lower[:, 1:] == s_lower[:, :-1]).all(dim=0)
    eq_prev = torch.cat([f, eq])
    eq_next = torch.cat([eq, f])
    return s_valid & ~eq_prev & eq_next & ~torch.cat([eq_next[1:], f])


def junction_pairs_plain(s_word: torch.Tensor, perm: torch.Tensor,
                         payload: torch.Tensor, C: int, K: int,
                         lower=None) -> torch.Tensor:
    """Plain PyTorch version of the pair kernel: s_word is the most
    significant packed key word in sorted order (sort.lex_sort or
    lex_sort_words), perm the sort's permutation, payload and lower (the
    key's other packed words, (W-1, 2C), or None) in entry order; K the
    key's lanes."""
    dev = s_word.device
    s_lower = None if lower is None else lower[:, perm]
    pair_head = pair_heads(s_word, s_lower, K, exact_sentinel(K))
    s_pay = payload[perm]
    nxt_pay = torch.cat([s_pay[1:], torch.zeros((1,), dtype=torch.int64,
                                                device=dev)])
    role_a, role_b = s_pay >> _ROLE_SHIFT, nxt_pay >> _ROLE_SHIFT
    oid_a, oid_b = s_pay & _OID_MASK, nxt_pay & _OID_MASK
    vert_a = torch.where(oid_a >= C, oid_a - C, oid_a)
    vert_b = torch.where(oid_b >= C, oid_b - C, oid_b)
    ok = pair_head & (role_a != role_b) & (vert_a != vert_b)
    src = torch.where(role_a == ROLE_OUT, oid_a, oid_b)[ok]
    dst = torch.where(role_a == ROLE_OUT, oid_b, oid_a)[ok]
    succ = torch.full((2 * C,), -1, dtype=torch.int64, device=dev)
    succ[src] = dst
    succ[torch.where(dst >= C, dst - C, dst + C)] = torch.where(
        src >= C, src - C, src + C)
    return succ


def junction_pairs(s_word, perm, payload, C: int, K: int,
                   lower=None) -> torch.Tensor:
    if s_word.device.type == "cpu":
        return junction_pairs_plain(s_word, perm, payload, C, K, lower)
    return _kernels.junction_pairs(s_word, perm, payload, C, K, lower)


def successor_arrays(solid: torch.Tensor, n_solid: int, k: int) -> torch.Tensor:
    """(2C,) int64 unitig-successor oriented id per oriented node, -1 if
    none (solid: (L, C), columns >= n_solid ignored).  The pair step gets
    the sort's own top word, its permutation, the key's lower words and
    the unsorted payload: no sorted copy of the keys or the payload is
    made.  Timed as the span compaction.junctions."""
    with span("compaction.junctions"):
        C = solid.shape[1]
        keys, payload = junction_keys(solid, n_solid, k)
        if packed_keys(k):
            perm, s_word = sort_op.lex_sort_words(list(keys))
            lower = keys[1:]
        else:
            perm, s_word = sort_op.lex_sort([keys[r] for r in range(keys.shape[0])])
            # pack_keys keeps an odd third row as a word of its own
            lower = keys[2:] if keys.shape[0] == 3 else None
        return junction_pairs(s_word, perm, payload, C, ln.num_lanes(k - 1),
                              lower)


# ---- global mode: the sharded junction matching of the -devices N build
# (bcalm_tpu/parallel/distcompact.py:_local_succ_shard) ----

def strand_folded(k: int) -> bool:
    """The strand bit fits the spare bits of the top key lane."""
    return ln.top_lane_bases(k - 1) < 16


def entry_key_rows(k: int) -> int:
    """Rows of a global-mode entry key: the (k-1)-mer lanes, plus a strand
    row when k-1 is a multiple of 16."""
    return ln.num_lanes(k - 1) + (0 if strand_folded(k) else 1)


def _make_keys(keys: torch.Tensor, strand: torch.Tensor, valid: torch.Tensor,
               k: int) -> torch.Tensor:
    """Fold the strand (and the validity sentinel) into (L2, N) key lanes
    (bcalm_tpu junctions._make_keys)."""
    if strand_folded(k):
        r = ln.top_lane_bases(k - 1)
        out = torch.cat([(keys[0] | (strand << (2 * r)))[None], keys[1:]])
    else:
        out = torch.cat([strand[None], keys])
    return torch.where(valid[None], out, SENTINEL)


def junction_entries_plain(solid: torch.Tensor, n_local: int, k: int,
                           gbase: int, tot: int, n_dev: int):
    """Plain version of K3a's global mode: the four junction entries of
    each local k-mer, (entries (K+1, 4N): the K key rows, then the
    payload; valid (4N,); owner (4N,)); suffix entries at [0, 2N), prefix
    entries at [2N, 4N); oriented ids global (gbase + i, + tot for the -
    strand); valid where i < n_local; owner = hash_lanes(key) % n_dev."""
    from bcalm_tpu_torch.ops import hashing

    N = solid.shape[1]
    dev = solid.device
    suf = ln.suffix_kminus1(solid, k)
    pre = ln.prefix_kminus1(solid, k)
    suf_c, sig = ln.canonical(suf, k - 1)
    pre_c, tau = ln.canonical(pre, k - 1)
    suf_pal = ln.is_palindrome(suf, k - 1)
    pre_pal = ln.is_palindrome(pre, k - 1)
    sig = torch.where(suf_pal, False, sig).to(torch.int64)
    tau = torch.where(pre_pal, False, tau).to(torch.int64)
    inv_sig = torch.where(suf_pal, 0, 1 - sig)
    inv_tau = torch.where(pre_pal, 0, 1 - tau)
    ids = torch.arange(N, device=dev)
    valid1 = ids < n_local
    keys = torch.cat([_make_keys(suf_c, sig, valid1, k),
                      _make_keys(suf_c, inv_sig, valid1, k),
                      _make_keys(pre_c, tau, valid1, k),
                      _make_keys(pre_c, inv_tau, valid1, k)], dim=1)
    g = gbase + ids
    oid = torch.cat([g, g + tot, g, g + tot])
    role = torch.cat([torch.zeros(N, dtype=torch.int64, device=dev),
                      torch.ones(N, dtype=torch.int64, device=dev),
                      torch.ones(N, dtype=torch.int64, device=dev),
                      torch.zeros(N, dtype=torch.int64, device=dev)])
    payload = oid | (role << _ROLE_SHIFT)
    return (torch.cat([keys, payload[None]]), valid1.repeat(4),
            hashing.hash_lanes(keys) % n_dev)


def junction_entries(solid: torch.Tensor, n_local: int, k: int, gbase: int,
                     tot: int, n_dev: int):
    """K3a global-mode entry: kernel for CUDA tensors, plain version for
    CPU tensors."""
    if solid.device.type == "cpu":
        return junction_entries_plain(solid, n_local, k, gbase, tot, n_dev)
    return _kernels.junction_entries(solid, n_local, k, gbase, tot, n_dev,
                                     entry_key_rows(k))


def junction_words_plain(rows: torch.Tensor, valid: torch.Tensor):
    """Plain version of the compaction in front of the global mode's sort
    (the contract of _kernels.junction_words): of the received (K+1, E)
    stack (K key rows, then the payload), the valid columns in receive
    order, as (words (ceil(K/2), n): their packed sort words
    (models.lanes.pack_keys), payload (n,), n (1,)).  bcalm_tpu
    _local_succ_shard fills the empty slots with the sentinel and sorts
    all of them; no valid key is the sentinel, so the empty ones sort
    last and the stable sort's first n entries are these."""
    kept = rows[:, valid]
    K = rows.shape[0] - 1
    words = torch.stack(ln.pack_keys([kept[j] for j in range(K)]))
    return words, kept[K], torch.tensor([kept.shape[1]], dtype=torch.int64,
                                        device=rows.device)


def junction_words(rows: torch.Tensor, valid: torch.Tensor):
    """Compaction entry: kernel for CUDA tensors (words and payload of
    capacity E, written at [0, n)), plain version for CPU tensors (of
    width n)."""
    if valid.device.type == "cpu":
        return junction_words_plain(rows, valid)
    return _kernels.junction_words(rows, valid)


def junction_edges_plain(s_word: torch.Tensor, perm: torch.Tensor,
                         words: torch.Tensor, payload: torch.Tensor, K: int,
                         tot: int, slot_cap: int):
    """Plain version of K3b's global mode on the sort's own output (the
    contract of _kernels.junction_edges): per sorted entry, (ok, edges (2,
    E): src, dst, owner of src's slot) of the pair rule (a group of
    exactly two equal keys, one OUT and one IN, on distinct vertices);
    (-1, -1, 0) where not ok."""
    pair_head = pair_heads(s_word, words[1:, perm] if words.shape[0] > 1
                           else None, K)
    s_pay = payload[perm]
    nxt_pay = torch.cat([s_pay[1:], torch.zeros((1,), dtype=torch.int64,
                                                device=s_word.device)])
    role_a, role_b = s_pay >> _ROLE_SHIFT, nxt_pay >> _ROLE_SHIFT
    oid_a, oid_b = s_pay & _OID_MASK, nxt_pay & _OID_MASK
    vert_a = torch.where(oid_a >= tot, oid_a - tot, oid_a)
    vert_b = torch.where(oid_b >= tot, oid_b - tot, oid_b)
    ok = pair_head & (role_a != role_b) & (vert_a != vert_b)
    src = torch.where(ok, torch.where(role_a == ROLE_OUT, oid_a, oid_b), -1)
    dst = torch.where(ok, torch.where(role_a == ROLE_OUT, oid_b, oid_a), -1)
    owner = torch.where(ok, torch.where(src >= tot, src - tot, src) // slot_cap,
                        0)
    return ok, torch.stack([src, dst]), owner


def junction_edges(s_word: torch.Tensor, perm: torch.Tensor,
                   words: torch.Tensor, payload: torch.Tensor, K: int,
                   tot: int, slot_cap: int):
    """K3b global-mode entry: kernel for CUDA tensors, plain version for
    CPU tensors."""
    if s_word.device.type == "cpu":
        return junction_edges_plain(s_word, perm, words, payload, K, tot,
                                    slot_cap)
    return _kernels.junction_edges(s_word, perm, words, payload, K, tot,
                                   slot_cap)


def junction_scatter_plain(edges: torch.Tensor, ev: torch.Tensor, tot: int,
                           base: int, slot_cap: int) -> torch.Tensor:
    """Plain version of the successor shard's scatter (bcalm_tpu
    _local_succ_shard's scatter_edges after its exchange): each received
    edge (a, b) with ev set writes b at a's local oriented id (a's slot
    less base, plus slot_cap on the - strand) of a (2*slot_cap,) table of
    -1; an id outside the table is dropped."""
    ea, eb = edges[0][ev], edges[1][ev]
    eslot = torch.where(ea >= tot, ea - tot, ea) - base
    lidx = torch.where(ea >= tot, eslot + slot_cap, eslot)
    keep = (lidx >= 0) & (lidx < 2 * slot_cap)
    table = torch.full((2 * slot_cap,), -1, dtype=torch.int64,
                       device=edges.device)
    table[lidx[keep]] = eb[keep]
    return table


def junction_scatter(edges: torch.Tensor, ev: torch.Tensor, tot: int,
                     base: int, slot_cap: int) -> torch.Tensor:
    """Scatter entry: kernel for CUDA tensors, plain version for CPU
    tensors."""
    if ev.device.type == "cpu":
        return junction_scatter_plain(edges, ev, tot, base, slot_cap)
    return _kernels.junction_scatter(edges, ev, tot, base, slot_cap)
