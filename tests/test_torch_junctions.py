"""K3 successor_arrays (plain path on the CPU) vs bcalm_tpu.ops.junctions.

The solid sets come from reads over a repeat-seeded genome plus reads
holding palindromic (k-1)-mers and hairpins (a sequence followed by its
reverse complement); past 3 key lanes (k-1 > 48) the keys are the exact
(k-1)-mers' packed words, where bcalm_tpu hashes them (its 96-bit hash
does not collide on these sets, so the arrays still agree).  The
table is shuffled and padded with sentinel columns past n_solid, as the
engine hands it over.  The pair step reads the sort's own top word
(sort.lex_sort, held against JAX's stable sort); the edge cases put groups
of exactly two and three equal keys at both ends of the sorted entries, a
hairpin (one k-mer's two sides in one group) and sentinel columns.  The long-k cases take (k-1) mod 16 to 0, 1 and 15
and the lane counts 2-32, where the kernel's word-parallel reverse
complement shifts whole words and bits.  The global mode of the
-devices build (junction entries, their sort words, the pair rule on the
sort's output, the successor shard's scatter) is held against the lines
of bcalm_tpu's _local_succ_shard on received entries with empty slots.
Exact equality.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bcalm_tpu.models import lanes as jln
from bcalm_tpu.ops import junctions as jjunc
from bcalm_tpu.ops import sort_tpu
from bcalm_tpu.oracle import brute
from bcalm_tpu_torch import convert
from bcalm_tpu_torch.models import lanes as tln
from bcalm_tpu_torch.ops import junctions as tjunc
from bcalm_tpu_torch.ops import sort as tsort
from bcalm_tpu_torch.ops.runchains import round_capacity
from bcalm_tpu_torch.parallel import distcompact

_RC = str.maketrans("ACGT", "TGCA")


def solid_table(k: int, seed: int):
    rng = np.random.RandomState(seed)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 300))
    genome += genome[40:40 + k + 5] + genome[:200]          # repeats
    half = "".join("ACGT"[c] for c in rng.randint(0, 4, (k - 1) // 2))
    pal = half + half.translate(_RC)[::-1]                   # even-length palindrome
    arm = "".join("ACGT"[c] for c in rng.randint(0, 4, k + 3))
    seqs = [genome, "ACG" + pal + "TTGCA", arm + arm.translate(_RC)[::-1]]
    kmers = sorted(brute.count_kmers(seqs, k))
    lanes = jln.ints_to_lanes(kmers, k)[:, rng.permutation(len(kmers))]
    n = lanes.shape[1]
    C = round_capacity(n)
    pad = np.full((lanes.shape[0], C - n), 0xFFFFFFFF, np.uint32)
    return np.concatenate([lanes, pad], axis=1), n


# (k-1) mod 16 in {0, 1, 15}, both sides of the packed-key threshold (k-1 > 48),
# 2, 4, 5, 9, 11, 17 and 32 lanes
LONG_K = [17, 49, 50, 65, 129, 161, 257, 512]


@pytest.mark.parametrize("k", [13, 21, 31, 32, 33, 51, 63] + LONG_K)
def test_successor_arrays_match(k):
    solid, n = solid_table(k, k)
    assert tjunc.packed_keys(k) == (k - 1 > 48)
    js, _ = jjunc.successor_arrays(jnp.asarray(solid), jnp.asarray(n, jnp.int32), k)
    ts = tjunc.successor_arrays(convert.lanes_from_numpy(solid, "cpu"), n, k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts >= 0).sum() > n // 2


@pytest.mark.parametrize("k", [31, 63])
def test_successor_arrays_partial_window(k):
    """A successor array of 2C = 16,538 slots, one whole 16,384-slot
    window of the card's scatter and a partial one (a key of two lanes,
    and of four lanes in two packed words), against bcalm_tpu's
    successor_arrays."""
    rng = np.random.RandomState(k)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 8260))
    kmers = sorted(brute.count_kmers([genome, genome[:3000]], k))
    lanes = jln.ints_to_lanes(kmers, k)[:, rng.permutation(len(kmers))]
    n, C = lanes.shape[1], 8192 + 77
    assert 16384 - C < n < C and 2 * C % 16384
    solid = np.concatenate([lanes, np.full((lanes.shape[0], C - n), 0xFFFFFFFF,
                                           np.uint32)], axis=1)
    js, _ = jjunc.successor_arrays(jnp.asarray(solid), jnp.asarray(n, jnp.int32), k)
    ts = tjunc.successor_arrays(convert.lanes_from_numpy(solid, "cpu"), n, k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int((ts[16384:] >= 0).sum()) > 0 and (ts >= 0).sum() > n


def jax_junction_keys(solid: np.ndarray, n: int, k: int):
    """The exact key lanes and the payload of bcalm_tpu.ops.junctions'
    entries, built from its own lane functions (what its exact path
    sorts; past 3 lanes it sorts a hash of these lanes instead)."""
    C = solid.shape[1]
    suf = jln.suffix_kminus1(jnp.asarray(solid), k)
    pre = jln.prefix_kminus1(jnp.asarray(solid), k)
    suf_c, sig = jln.canonical(suf, k - 1)
    pre_c, tau = jln.canonical(pre, k - 1)
    ids = np.arange(C)
    vs = (ids < n) & ~np.asarray(jln.is_palindrome(suf, k - 1))
    vp = (ids < n) & ~np.asarray(jln.is_palindrome(pre, k - 1))
    sig, tau = np.asarray(sig), np.asarray(tau)
    payload = np.concatenate([np.where(sig, ids + C, ids) | (sig.astype(np.int64) << 30),
                              np.where(tau, ids + C, ids) | ((~tau).astype(np.int64) << 30)])
    keys = np.concatenate([np.where(vs[None], np.asarray(suf_c), 0xFFFFFFFF),
                           np.where(vp[None], np.asarray(pre_c), 0xFFFFFFFF)], axis=1)
    return keys.astype(np.uint32), payload


@pytest.mark.parametrize("k", LONG_K)
def test_junction_keys_plain_match(k):
    """K3a's plain version (what the kernel is held against on the card):
    keys and payload of every entry, palindromic and past n_solid
    included; past 3 lanes the keys are the packed words of JAX's exact
    lanes (models.lanes.pack_keys)."""
    solid, n = solid_table(k, k + 1)
    keys, payload = tjunc.junction_keys_plain(
        convert.lanes_from_numpy(solid, "cpu"), n - 2, k)
    want_keys, want_payload = jax_junction_keys(solid, n - 2, k)
    assert keys.shape[0] == tjunc.key_rows(k)
    if tjunc.packed_keys(k):
        want = torch.stack(tln.pack_keys(
            [torch.from_numpy(r.astype(np.int64)) for r in want_keys]))
        assert keys.shape[0] == tjunc.key_words(k) == (want_keys.shape[0] + 1) // 2
        assert torch.equal(keys, want)
    else:
        np.testing.assert_array_equal(convert.lanes_to_numpy(keys), want_keys)
    np.testing.assert_array_equal(payload.numpy(), want_payload)
    assert (want_keys[0] == 0xFFFFFFFF).sum() >= 4  # the two cut columns' sides


@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_lex_sort_word_and_perm(K):
    """sort.lex_sort: its permutation is JAX's stable sort's (the entry
    index sorted along as a payload) and lex_argsort's, and its word is the
    top packed key (pack_keys) gathered through it; ties, the sentinel and
    a top-bit lane value included."""
    rng = np.random.RandomState(K)
    pool = rng.randint(0, 2**32, size=(K, 40), dtype=np.uint64).astype(np.uint32)
    pool[:, 0] = 0xFFFFFFFF
    pool[0, 1] = 0x80000000
    x = pool[:, rng.randint(0, 40, 500)]
    cols = [torch.from_numpy(x[j].astype(np.int64)) for j in range(K)]
    perm, top = tsort.lex_sort(cols)
    out = sort_tpu.sort_ops([jnp.asarray(x[j]) for j in range(K)]
                            + [jnp.arange(500, dtype=jnp.uint32)], num_keys=K)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(out[K]))
    assert torch.equal(perm, tsort.lex_argsort(cols))
    assert torch.equal(top, tln.pack_keys(cols)[0][perm])


def test_sentinel_words_follow_pack_keys():
    """An all-sentinel key's top packed word, and the first lane read back
    from the top word by the shift, for keys of 1 to 10 lanes."""
    S = 0xFFFFFFFF
    assert tjunc.sentinel_words(1) == (S, 0)
    hi = (S - 2**31) << 32
    for K in (2, 3, 4, 10):
        assert tjunc.sentinel_words(K) == (hi | S, 32)
    for K in (1, 2, 3, 4, 10):
        sent0, shift = tjunc.sentinel_words(K)
        word = tln.pack_keys([torch.tensor([S, 7, 9, S][j % 4]) for j in range(K)])[0]
        assert int(word) >> shift == sent0 >> shift
        word = tln.pack_keys([torch.tensor([S - 1, S, S][j % 3]) for j in range(K)])[0]
        assert int(word) >> shift != sent0 >> shift


def _canonical(seq: str, k: int) -> int:
    return brute.canonical_num(brute.str2num(seq), k)


def edge_table(k: int, case: str):
    """Solid k-mers (numpy lanes) of a random genome plus a few chosen ones,
    and the group sizes the sorted entries must show: a group of `two` or
    `three` equal keys at each end (the least key, A^(k-1), and the largest
    canonical odd-length (k-1)-mer, G^h C^(h+1)), each pair an edge; or
    `hairpin`: A^k, whose two sides form one group on one vertex; then
    sentinel columns past n_solid."""
    m = k - 1
    h = (m - 1) // 2
    first, last = "A" * m, "G" * h + "C" * (h + 1)
    rng = np.random.RandomState(k)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 300))
    kmers = set(brute.count_kmers([genome], k))
    if case == "hairpin":
        chosen = ["A" * k]
    else:
        chosen = ["C" + first, first + "C", "A" + last, last + "A"]
        if case == "three":
            chosen += ["T" + first, "C" + last]
    kmers |= {_canonical(x, k) for x in chosen}
    lanes = jln.ints_to_lanes(sorted(kmers), k)[:, rng.permutation(len(kmers))]
    n = lanes.shape[1]
    pad = np.full((lanes.shape[0], 5 if case == "hairpin" else 0), 0xFFFFFFFF,
                  np.uint32)
    return np.concatenate([lanes, pad], axis=1), n


def sorted_groups(solid: np.ndarray, n: int, k: int):
    """Sizes of the runs of equal sorted keys (the port's plain key build,
    its lanes read back from packed words, and lex_sort), the number of
    sentinel entries and K3a's key rows."""
    keys, _ = tjunc.junction_keys_plain(convert.lanes_from_numpy(solid, "cpu"),
                                        n, k)
    K = keys.shape[0]
    if tjunc.packed_keys(k):
        keys = tln.unpack_keys(list(keys), tln.num_lanes(k - 1))
    perm, top = tsort.lex_sort(list(keys))
    s_keys = keys[:, perm]
    sent = s_keys[0] == tjunc.SENTINEL
    valid = s_keys[:, ~sent]
    change = torch.any(valid[:, 1:] != valid[:, :-1], dim=0)
    bounds = [0] + (torch.nonzero(change).flatten() + 1).tolist() + [valid.shape[1]]
    return np.diff(bounds).tolist(), int(sent.sum()), K


@pytest.mark.parametrize("k,case", [(16, "two"), (16, "three"), (32, "two"),
                                    (32, "three"), (34, "two"), (34, "three"),
                                    (32, "hairpin"), (50, "hairpin")])
def test_successor_arrays_edge_groups(k, case):
    """Groups of exactly two and three equal keys at both ends of the
    sorted entries (1, 2 and 3 key rows: one and two packed words; at k =
    50 four lanes in the two words K3a packs itself), a hairpin (rejected:
    equal vertices) and sentinel columns (never paired), against
    bcalm_tpu's successor_arrays."""
    solid, n = edge_table(k, case)
    sizes, n_sent, K = sorted_groups(solid, n, k)
    assert K == {16: 1, 32: 2, 34: 3, 50: 2}[k]
    want = {"two": 2, "three": 3}.get(case)
    if want:
        assert sizes[0] == sizes[-1] == want and n_sent == 0
    else:
        assert 2 in sizes and n_sent == 2 * (solid.shape[1] - n)
    js, _ = jjunc.successor_arrays(jnp.asarray(solid), jnp.asarray(n, jnp.int32), k)
    ts = tjunc.successor_arrays(convert.lanes_from_numpy(solid, "cpu"), n, k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    C = solid.shape[1]
    if case == "hairpin":
        hp = int(np.flatnonzero(np.all(solid == jln.ints_to_lanes(
            [_canonical("A" * k, k)], k), axis=0))[0])
        assert int(ts[hp]) == int(ts[hp + C]) == -1
    elif case == "two":
        assert int((ts >= 0).sum()) > 4


def _jax_pairing(ent: np.ndarray, ev: np.ndarray, K: int, tot: int):
    """bcalm_tpu _local_succ_shard's lines from the received entries to
    (ok, src, dst) per sorted entry: the fills, the stable sort on the K
    key rows with the payload along, the pair rule."""
    SENT = np.uint32(0xFFFFFFFF)
    e = jnp.asarray(ent.astype(np.uint32))
    jev = jnp.asarray(ev)
    e_keys = jnp.where(jev[None], e[:K], SENT)
    e_pay = jnp.where(jev, e[K], 0)
    out = jax.lax.sort([e_keys[j] for j in range(K)] + [e_pay], num_keys=K)
    s_keys = jnp.stack(out[:K], axis=0)
    s_pay = out[K]
    s_valid = s_keys[0] != SENT
    eq_prev = jnp.concatenate([jnp.zeros((1,), bool),
                               jnp.all(s_keys[:, 1:] == s_keys[:, :-1], axis=0)])
    eq_next = jnp.concatenate([eq_prev[1:], jnp.zeros((1,), bool)])
    pair_head = s_valid & ~eq_prev & eq_next & ~jnp.concatenate(
        [eq_next[1:], jnp.zeros((1,), bool)])
    nxt_pay = jnp.concatenate([s_pay[1:], jnp.zeros((1,), jnp.uint32)])
    role_a = (s_pay >> jjunc._ROLE_SHIFT).astype(jnp.int32)
    role_b = (nxt_pay >> jjunc._ROLE_SHIFT).astype(jnp.int32)
    oid_a = (s_pay & jjunc._OID_MASK).astype(jnp.int32)
    oid_b = (nxt_pay & jjunc._OID_MASK).astype(jnp.int32)
    vert_a = jnp.where(oid_a >= tot, oid_a - tot, oid_a)
    vert_b = jnp.where(oid_b >= tot, oid_b - tot, oid_b)
    ok = pair_head & (role_a != role_b) & (vert_a != vert_b)
    src = jnp.where(role_a == jjunc.ROLE_OUT, oid_a, oid_b)
    dst = jnp.where(role_a == jjunc.ROLE_OUT, oid_b, oid_a)
    return np.asarray(ok), np.asarray(src), np.asarray(dst)


def _received(ent: torch.Tensor, keep: torch.Tensor, n_dev: int, rng):
    """The kept columns of ent shuffled into an exchange's receive buffer
    of n_dev buckets: each bucket a valid prefix, zeros after (as K15 and
    the all_to_all leave them).  Returns (received (C, n_dev*cap), valid)."""
    cols = torch.nonzero(keep).flatten()
    cols = cols[torch.from_numpy(rng.permutation(cols.numel()))]
    cap = -(-cols.numel() // (n_dev - 1)) + 3
    recv = torch.zeros((ent.shape[0], n_dev * cap), dtype=torch.int64)
    ev = torch.zeros((n_dev * cap,), dtype=torch.bool)
    for b, part in enumerate(torch.tensor_split(cols, n_dev - 1)):
        recv[:, b * cap:b * cap + part.numel()] = ent[:, part]
        ev[b * cap:b * cap + part.numel()] = True
    return recv, ev


def _port_pairing(recv: torch.Tensor, ev: torch.Tensor, K: int, tot: int,
                  slot_cap: int):
    """The port's global step from the received entries to the edges: the
    compaction of the valid slots (junction_words), the sort of those n
    alone and the pair rule on its output.  Returns (n, words, ok, edges,
    src's owner)."""
    words, payload, n_t = tjunc.junction_words(recv, ev)
    n = int(n_t[0])
    assert n == int(ev.sum()) and words.shape == ((K + 1) // 2, n)
    assert payload.shape == (n,)
    ok, edges, owner = distcompact._pair_edges(words, payload, K, tot,
                                               slot_cap)
    return n, words, ok, edges, owner


def _assert_pairing_is_jax(recv, ev, K, tot, slot_cap):
    """The port's compacted step against bcalm_tpu's on the whole receive
    buffer: JAX's ok is False at every sorted position past n, and at the
    first n positions ok, src, dst and src's owner are the port's.
    Returns (the port's ok, edges, owner, words)."""
    n, words, ok, edges, owner = _port_pairing(recv, ev, K, tot, slot_cap)
    jok, jsrc, jdst = _jax_pairing(recv.numpy(), ev.numpy(), K, tot)
    assert not jok[n:].any()
    np.testing.assert_array_equal(ok.numpy(), jok[:n])
    okn = ok.numpy()
    np.testing.assert_array_equal(edges[0].numpy()[okn], jsrc[:n][okn])
    np.testing.assert_array_equal(edges[1].numpy()[okn], jdst[:n][okn])
    assert (edges.numpy()[:, ~okn] == -1).all() and (owner.numpy()[~okn] == 0).all()
    vert = np.where(jsrc[:n] >= tot, jsrc[:n] - tot, jsrc[:n])
    np.testing.assert_array_equal(owner.numpy()[okn], vert[okn] // slot_cap)
    return ok, edges, owner, words


@pytest.mark.parametrize("k", [13, 17, 31, 33, 63])
def test_global_edges_match_jax(k):
    """The global mode's pair step on the sort's own output against
    bcalm_tpu _local_succ_shard: the entries of this rank (1 of 3) in a
    receive buffer with empty (zero) slots; the valid slots compacted, in
    receive order, into their packed sort words and payloads, and only
    those n sorted by lex_sort_words; the pair rule reads the top word,
    the lower words (k = 33, 63: two words; k = 17, 33: a strand row) and
    the payload through perm.  ok, src, dst and src's owner at the n
    sorted positions equal JAX's first n, which sorts every slot, and
    JAX's ok is False past them; then the successor shard's scatter of the
    edges this rank owns against JAX's drop-mode scatter."""
    rng = np.random.RandomState(k)
    solid, n = solid_table(k, k + 7)
    slot_cap, n_dev, me = solid.shape[1], 3, 1
    tot = n_dev * slot_cap
    ent, valid, owner = tjunc.junction_entries(
        convert.lanes_from_numpy(solid, "cpu"), n - 2, k, me * slot_cap, tot,
        n_dev)
    K = ent.shape[0] - 1
    assert K == tjunc.entry_key_rows(k) and int(valid.sum()) == 4 * (n - 2)
    recv, ev = _received(ent, valid, n_dev, rng)
    ok, edges, src_owner, _ = _assert_pairing_is_jax(recv, ev, K, tot,
                                                     slot_cap)
    assert int(ok.sum()) > 10
    # the shard's scatter: the edges whose source slot this rank owns
    mine = ok & (src_owner == me)
    erecv, eev = _received(edges, mine, n_dev, rng)
    table = tjunc.junction_scatter(erecv, eev, tot, me * slot_cap, slot_cap)
    np.testing.assert_array_equal(table.numpy(),
                                  _jax_scatter(erecv, eev, tot, me, slot_cap))
    assert int((table >= 0).sum()) == int(mine.sum()) > 0


def _jax_scatter(erecv, eev, tot, me, slot_cap):
    """bcalm_tpu _local_succ_shard's scatter_edges after its exchange."""
    ea, eb = jnp.asarray(erecv[0].numpy()), jnp.asarray(erecv[1].numpy())
    jev = jnp.asarray(eev.numpy())
    eslot = jnp.where(ea >= tot, ea - tot, ea) - me * slot_cap
    lidx = jnp.where(ea >= tot, eslot + slot_cap, eslot)
    return np.asarray(jnp.full((2 * slot_cap,), -1, dtype=jnp.int32).at[
        jnp.where(jev, lidx, 2 * slot_cap)].set(jnp.where(jev, eb, -1),
                                                mode="drop"))


def _homopolymer_table(k: int):
    """The solid set of reads holding the four homopolymers beside a random
    genome's k-mers: (lanes, n)."""
    rng = np.random.RandomState(k)
    genome = "".join("ACGT"[c] for c in rng.randint(0, 4, 200))
    seqs = [b * (k + 3) for b in "ACGT"]
    seqs += [genome, "A" * (k - 1) + "C" + genome[:40] + "G" * k]
    kmers = sorted(brute.count_kmers(seqs, k))
    return jln.ints_to_lanes(kmers, k)[:, rng.permutation(len(kmers))], len(kmers)


@pytest.mark.parametrize("case", ["full", "none", "one", "scattered",
                                  "homopolymer"])
@pytest.mark.parametrize("k", [17, 31, 33])
def test_compaction_cases_match_jax(k, case):
    """The compaction in front of the sort on edge-case masks, each held
    against bcalm_tpu's sort of every slot: no empty slot ("full"), no
    valid slot, one valid slot, a mask that is not bucket prefixes (valid
    slots scattered over the buffer, empty ones holding garbage), and
    reads of the homopolymers A/C/G/T, whose (k-1)-mer T^(k-1) has the
    sentinel's lanes (it keys as its canonical A^(k-1), G^(k-1) as
    C^(k-1)), with the strand as a row of its own (k - 1 = 16, 32) or in
    the top lane's spare bits (k = 31): no valid slot's words are the
    sentinel packing, and the all-zero key A^(k-1) is among them."""
    rng = np.random.RandomState(k + len(case))
    if case == "homopolymer":
        solid, n = _homopolymer_table(k)
    else:
        solid, n = solid_table(k, k + 3)
    slot_cap, n_dev, me = solid.shape[1], 2, 0
    tot = n_dev * slot_cap
    ent, valid, _ = tjunc.junction_entries(
        convert.lanes_from_numpy(solid, "cpu"), n, k, me * slot_cap, tot,
        n_dev)
    K = ent.shape[0] - 1
    cols = ent[:, valid][:, torch.from_numpy(rng.permutation(int(valid.sum())))]
    E = cols.shape[1]
    if case in ("full", "homopolymer"):
        recv, ev = cols, torch.ones((E,), dtype=torch.bool)
    else:
        recv = torch.from_numpy(rng.randint(0, 2**32, size=(K + 1, 2 * E + 5),
                                            dtype=np.uint64).astype(np.int64))
        ev = torch.zeros((2 * E + 5,), dtype=torch.bool)
        at = {"none": [], "one": [E + 2],
              "scattered": sorted(rng.choice(2 * E + 5, E, replace=False))}[case]
        at = torch.tensor(at, dtype=torch.int64)
        recv[:, at] = cols[:, :at.numel()]
        ev[at] = True
    ok, _, _, words = _assert_pairing_is_jax(recv, ev, K, tot, slot_cap)
    sent = torch.tensor(ln_sentinel_packing(K))[:, None]
    assert not (words == sent).all(dim=0).any()
    sent0, shift = tjunc.sentinel_words(K)
    assert ((words[0] >> shift) != (sent0 >> shift)).all()
    if case in ("full", "scattered", "homopolymer"):
        assert int(ok.sum()) > 10
    if case == "homopolymer":
        assert (recv[:K] == 0).all(dim=0).any()


def ln_sentinel_packing(K: int):
    """The packed words of a key whose K rows are all the sentinel."""
    return [int(w) for w in tln.pack_keys([torch.tensor(tln.SENTINEL)] * K)]


def test_global_step_edges_name_distinct_slots():
    """What junction_scatter relies on: no two edges of the global step
    name one source slot (every oriented node has one out-end), nor one
    target (the predecessor shard's scatter); on the plain step of a
    repeat-seeded genome's k-mers (solid_table) at 4 ranks, every rank's
    sorted entries."""
    k = 31
    solid, n = solid_table(k, 3)
    solid = convert.lanes_from_numpy(solid[:, :n], "cpu")
    n_dev = 4
    slot_cap = -(-n // n_dev)
    tot = n_dev * slot_cap
    solid = torch.nn.functional.pad(solid, (0, tot - n))
    ents = [tjunc.junction_entries_plain(
        solid[:, r * slot_cap:(r + 1) * slot_cap], min(slot_cap, n - r * slot_cap),
        k, r * slot_cap, tot, n_dev) for r in range(n_dev)]
    srcs, dsts = [], []
    for d in range(n_dev):
        cols = [e[0][:, e[1] & (e[2] == d)] for e in ents]
        rows = torch.cat(cols, dim=1)
        words, payload, _ = tjunc.junction_words_plain(
            rows, torch.ones(rows.shape[1], dtype=torch.bool))
        ok, edges, _ = distcompact._pair_edges(words, payload, rows.shape[0] - 1,
                                               tot, slot_cap)
        srcs.append(edges[0][ok])
        dsts.append(edges[1][ok])
    src, dst = torch.cat(srcs), torch.cat(dsts)
    assert src.numel() > 500
    assert torch.unique(src).numel() == src.numel()
    assert torch.unique(dst).numel() == dst.numel()


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [31, 33, 63])
def test_pair_rule_bytes_counts_the_data(k):
    """chip_smoke.pair_rule_bytes, the bytes the global pair rule's bound
    counts, against a count entry by entry on the same sorted receive
    buffer: every top word, the lower words (k = 33, 63) of each valid
    neighbour pair whose top words tie, perm at those entries (k = 31: at
    each pair head's two) and the payload of each pair head's two
    entries, each as distinct 32-byte sectors or the valid entries' 8
    bytes, whichever is less; every edge the pair rule emits sits at a
    pair head."""
    rng = np.random.RandomState(k)
    solid, n = solid_table(k, k + 7)
    slot_cap, n_dev, me = solid.shape[1], 3, 1
    tot = n_dev * slot_cap
    ent, valid, _ = tjunc.junction_entries(
        convert.lanes_from_numpy(solid, "cpu"), n - 2, k, me * slot_cap, tot,
        n_dev)
    K = ent.shape[0] - 1
    recv, ev = _received(ent, valid, n_dev, rng)
    words, payload, _ = tjunc.junction_words(recv, ev)
    perm, top = tsort.lex_sort_words(words)
    got = _chip_smoke().pair_rule_bytes(top, perm, words, K)

    sent0, shift = tjunc.sentinel_words(K)
    E, W = top.numel(), words.shape[0]
    t, p, w = top.tolist(), perm.tolist(), words.tolist()
    ok_valid = [(x >> shift) != (sent0 >> shift) for x in t]
    n_valid = sum(ok_valid)
    key = [tuple(w[r][p[i]] for r in range(W)) for i in range(E)]
    eq = [i + 1 < E and ok_valid[i + 1] and key[i] == key[i + 1]
          for i in range(E)]
    ties = [i for i in range(E - 1) if ok_valid[i + 1] and t[i] == t[i + 1]]
    heads = [i for i in range(E) if ok_valid[i] and eq[i]
             and not (i and eq[i - 1]) and not eq[i + 1]]

    def sectors(idx):
        return min(8 * n_valid, 32 * len({j // 4 for j in idx}))

    pos = ([i + d for i in ties for d in (0, 1)] if W > 1
           else [i + d for i in heads for d in (0, 1)])
    lower = (W - 1) * sectors([p[i] for i in pos]) if W > 1 else 0
    want = (8 * E + lower + sectors(pos)
            + sectors([p[i + d] for i in heads for d in (0, 1)]))
    assert got == want
    ok, _, _ = tjunc.junction_edges(top, perm, words, payload, K, tot, slot_cap)
    assert set(torch.nonzero(ok).flatten().tolist()) <= set(heads)
    assert len(heads) > 10 and n_valid == E == int(ev.sum())
