"""The minimizer and superkmer layer of the port (K13, K14, K15 plain
versions, the lane hash, the repartition table) against bcalm_tpu, exact.

Inputs are made from seeds with numpy/random and go through both
packages; lane values cross as numpy arrays (JAX uint32, torch int64
holding u32).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bcalm_tpu.io import packing
from bcalm_tpu.models import minimizer as jmz
from bcalm_tpu.ops import extract as jextract
from bcalm_tpu.ops import hashing as jhash
from bcalm_tpu.ops import superkmer as jskm
from bcalm_tpu.parallel import pipeline as jpl
from bcalm_tpu_torch.models import minimizer as tmz
from bcalm_tpu_torch.ops import extract as textract
from bcalm_tpu_torch.ops import hashing as thash
from bcalm_tpu_torch.ops import superkmer as tskm
from bcalm_tpu_torch.parallel import pipeline as tpl
from bcalm_tpu_torch.parallel.mesh import Mesh


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(j, t) -> bool:
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return j.shape == t.shape and np.array_equal(j.astype(np.int64),
                                                 t.astype(np.int64))


def block(seed: int, k: int, n: int = 37, max_len: int = 128):
    rng = random.Random(seed)
    seqs = ["".join(rng.choice("ACGT")
                    for _ in range(rng.randint(5, max_len - 8)))
            for _ in range(n)]
    seqs.append("ACGT" * 30)          # low complexity: long runs of one key
    b = next(packing.iter_blocks(seqs, k, block_reads=64, max_len=max_len))
    return b.words, b.lengths


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_mix32_and_hash_lanes(L):
    rng = np.random.RandomState(L)
    lanes = rng.randint(0, 2**32, size=(L, 500), dtype=np.uint64).astype(np.uint32)
    lanes[:, :4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    assert same(jhash.mix32(jnp.asarray(lanes[0])), thash.mix32(t64(lanes[0])))
    h = jhash.hash_lanes(jnp.asarray(lanes))
    assert same(h, thash.hash_lanes(t64(lanes)))
    for n_dev in (2, 3, 4, 8):    # the owner of a routed entry
        assert same(np.asarray(h) % np.uint32(n_dev),
                    thash.hash_lanes(t64(lanes)) % n_dev)


@pytest.mark.parametrize("m", [1, 5, 10, 16])
def test_canonical_mmers_and_window_min(m):
    words, _ = block(m, 31)
    bases = jextract.decode_words(jnp.asarray(words))
    fwd, _ = jextract.window_packs(bases)
    tfwd = tskm.window_packs(textract.decode_words(t64(words)))
    assert same(fwd, tfwd)
    cm = jskm.canonical_mmers(fwd, m)
    assert same(cm, tskm.canonical_mmers(tfwd, m))
    for w in (1, 2, 7, 16, 22, 31):
        assert same(jskm.window_min_keys(cm, w),
                    tskm.window_min_keys(t64(cm), w))


def test_span_helpers():
    for k in (13, 15, 21, 31, 33, 63, 127, 151, 255, 512):
        ms = jskm.default_max_span(k)
        assert tskm.default_max_span(k) == ms
        for span in (1, 8, ms):
            assert tskm.span_words(k, span) == jskm.span_words(k, span)
            assert tskm.span_field_bits(span) == jskm.span_field_bits(span)
        for m in (5, 10, 16):
            assert tskm.est_span(k, m) == jskm.est_span(k, m)
            assert tpl.effective_m(k, m) == jpl.effective_m(k, m)
    for args in ((1024, 160, 31, 10, 1, 10), (64, 128, 21, 8, 4, 11)):
        for share in (None, 0.6):
            assert (tpl.superkmer_capacity(*args, max_share=share)
                    == jpl.superkmer_capacity(*args, max_share=share))


@pytest.mark.parametrize("k,m", [(31, 10), (21, 8), (15, 5), (63, 12),
                                 (13, 12)])
def test_sampling_histograms_and_tables(k, m):
    words, lengths = block(k + m, k)
    jw, jl = jnp.asarray(words), jnp.asarray(lengths)
    h = jskm.sample_cmmer_histogram(jw, jl, k, m)
    assert same(h, tskm.sample_cmmer_histogram(t64(words), t64(lengths), k, m))
    rank = jmz.frequency_rank(np.asarray(h))
    assert same(rank, tmz.frequency_rank(np.asarray(h)))
    for use_rank in (False, True):
        load = jskm.sample_minimizer_load(
            jw, jl, k, m, jnp.asarray(rank) if use_rank else None,
            use_rank=use_rank)
        tload = tskm.sample_minimizer_load(
            t64(words), t64(lengths), k, m, t64(rank) if use_rank else None,
            use_rank)
        assert same(load, tload)
        for n_parts in (1, 2, 4, 8):
            for rtype in (0, 1):
                assert same(jmz.build_repartition(np.asarray(load), n_parts,
                                                  rtype),
                            tmz.build_repartition(tload.numpy(), n_parts,
                                                  rtype))


@pytest.mark.parametrize("k,m,max_span", [(31, 10, None), (21, 8, 8),
                                          (15, 5, None), (63, 12, 3),
                                          (33, 11, None), (151, 10, None),
                                          (255, 12, 5)])
@pytest.mark.parametrize("use_rank", [False, True])
@pytest.mark.parametrize("with_pos", [False, True])
def test_form_superkmers(k, m, max_span, use_rank, with_pos):
    """K13's plain version; at k = 151 and 255 (Wn = 12 and 18 words) on
    reads of up to 312 bases."""
    words, lengths = block(k * m, k, max_len=128 if k < 128 else 320)
    jw, jl = jnp.asarray(words), jnp.asarray(lengths)
    rank = jmz.frequency_rank(np.asarray(jskm.sample_cmmer_histogram(
        jw, jl, k, m)))
    load = jskm.sample_minimizer_load(jw, jl, k, m, jnp.asarray(rank),
                                      use_rank=True)
    table = jmz.build_repartition(np.asarray(load), 4)
    ms = max_span or jskm.default_max_span(k)
    pos_base = 0xFFFFFF00     # the stream slot wraps inside the block
    out = jskm.form_superkmers(
        jw, jl, k, m, jnp.asarray(table),
        jnp.asarray(rank) if use_rank else None, max_span=ms,
        use_rank=use_rank, with_pos=with_pos,
        pos_base=np.uint32(pos_base) if with_pos else None)
    tout = tskm.form_superkmers(t64(words), t64(lengths), k, m, t64(table),
                                t64(rank) if use_rank else None, ms, use_rank,
                                with_pos, pos_base if with_pos else 0)
    names = ("skm_words", "owner", "start", "n_kmers")
    for name, a, b in zip(names, out, tout):
        assert same(np.asarray(a).reshape(-1), b.reshape(-1)), name
    spans = tskm.decode_span(tout[0][-2 if with_pos else -1], ms)[tout[2]]
    assert int(spans.sum()) == int(tout[3][0])


def route_case(seed: int, N: int, C: int, n_dev: int):
    rng = np.random.RandomState(seed)
    stacked = rng.randint(0, 2**32, size=(C, N), dtype=np.uint64).astype(np.uint32)
    valid = rng.rand(N) < 0.8
    # skewed owners: rank 0 takes half, so a small cap overflows there
    owner = np.where(rng.rand(N) < 0.5, 0, rng.randint(0, n_dev, N)).astype(np.int32)
    return stacked, valid, owner


def jax_send(want, n_dev: int, cap: int, fill: int = 0):
    """bcalm_tpu _route_to_buckets' (buckets (C, n_dev, cap), validity
    (n_dev, cap), dropped[, slots]) in K15's layout: (send (n_dev, C+1,
    cap), the validity as channel C, the empty slots of channels 0..C-1
    taken where(valid, ..., fill); dropped[, slots])."""
    bl = np.asarray(want[0]).astype(np.int64)
    bv = np.asarray(want[1])
    bl = np.where(bv[None], bl, fill)
    send = np.concatenate([bl, bv[None].astype(np.int64)]).transpose(1, 0, 2)
    return (send,) + tuple(np.asarray(x) for x in want[2:])


def assert_route(want, got, n_dev, cap, fill=0):
    for name, a, b in zip(("send", "dropped", "slots"),
                          jax_send(want, n_dev, cap, fill), got):
        assert same(a.reshape(-1), b.reshape(-1)), name
    assert got[0].shape == (n_dev, np.asarray(want[0]).shape[0] + 1, cap)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("overflow", [False, True])
def test_route_to_buckets(n_dev, overflow):
    N, C = 700, 3
    stacked, valid, owner = route_case(n_dev, N, C, n_dev)
    cap = N // (4 * n_dev) if overflow else N
    want = jpl._route_to_buckets(jnp.asarray(stacked), jnp.asarray(valid),
                                 jnp.asarray(owner), n_dev, cap,
                                 with_slots=True)
    got = tpl.route_to_buckets(t64(stacked), torch.from_numpy(valid),
                               t64(owner), n_dev, cap, with_slots=True)
    assert_route(want, got, n_dev, cap)
    assert (int(got[1][0]) > 0) == overflow
    plain = tpl.route_to_buckets(t64(stacked), torch.from_numpy(valid),
                                 t64(owner), n_dev, cap)
    assert len(plain) == 2 and all(torch.equal(a, b)
                                   for a, b in zip(plain, got[:2]))


@pytest.mark.parametrize("L,n_dev", [(1, 3), (2, 4), (3, 8), (10, 4),
                                     (32, 2)])
def test_route_to_buckets_hash_mode(L, n_dev):
    """No owner array: the owner is hash_lanes of the entry's lanes %
    n_dev, as bcalm_tpu's _local_shard_count routes its k-mers."""
    stacked, valid, _ = route_case(L, 700, L, n_dev)
    owner = (jhash.hash_lanes(jnp.asarray(stacked)) % np.uint32(n_dev)
             ).astype(jnp.int32)
    want = jpl._route_to_buckets(jnp.asarray(stacked), jnp.asarray(valid),
                                 owner, n_dev, 700 // n_dev, with_slots=True)
    got = tpl.route_to_buckets(t64(stacked), torch.from_numpy(valid), None,
                               n_dev, 700 // n_dev, with_slots=True)
    assert_route(want, got, n_dev, 700 // n_dev)


@pytest.mark.parametrize("n_dev", [3, 33])
def test_route_to_buckets_overflow_every_owner(n_dev):
    """Uniform owners and a cap of half each owner's share: every bucket
    overflows at once, and the drops are counted."""
    N, C = 900, 2
    rng = np.random.RandomState(n_dev)
    stacked = rng.randint(0, 2**32, size=(C, N), dtype=np.uint64).astype(np.uint32)
    valid = rng.rand(N) < 0.8
    owner = rng.randint(0, n_dev, N).astype(np.int32)
    cap = max(1, int(valid.sum()) // (2 * n_dev))
    assert np.bincount(owner[valid], minlength=n_dev).min() > cap
    want = jpl._route_to_buckets(jnp.asarray(stacked), jnp.asarray(valid),
                                 jnp.asarray(owner), n_dev, cap,
                                 with_slots=True)
    got = tpl.route_to_buckets(t64(stacked), torch.from_numpy(valid),
                               t64(owner), n_dev, cap, with_slots=True)
    assert_route(want, got, n_dev, cap)
    assert int(got[0][:, C].sum(1).min()) == cap


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_route_to_buckets_send_buffer(hashed, n_dev, C):
    """K15's plain version writes the exchange's send buffer: JAX's buckets
    and validity in the (n_dev, C+1, cap) layout, the empty slots holding
    the fill word (0, as JAX fills, or the sentinel), in the owner and the
    hash mode, with and without drops at cap, with and without slots."""
    N = 600
    stacked, valid, owner = route_case(100 * C + n_dev, N, C, n_dev)
    if hashed:
        owner = np.asarray(jhash.hash_lanes(jnp.asarray(stacked))
                           % np.uint32(n_dev)).astype(np.int32)
    n_valid = int(valid.sum())
    for cap in (n_valid, max(1, n_valid // (3 * n_dev))):
        want = jpl._route_to_buckets(jnp.asarray(stacked), jnp.asarray(valid),
                                     jnp.asarray(owner), n_dev, cap,
                                     with_slots=True)
        dropped = int(np.asarray(want[2]))
        assert (dropped > 0) == (cap < n_valid)
        for fill in (0, int(tpl.SENTINEL)):
            args = (t64(stacked), torch.from_numpy(valid),
                    None if hashed else t64(owner), n_dev, cap)
            got = tpl.route_to_buckets(*args, with_slots=True, fill=fill)
            assert_route(want, got, n_dev, cap, fill)
            plain = tpl.route_to_buckets(*args, fill=fill)
            assert len(plain) == 2 and all(torch.equal(a, b)
                                           for a, b in zip(plain, got[:2]))


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_route_to_buckets_without_validity(hashed, n_dev):
    """with_valid=False, as the per-k-mer count routes its k-mers: the send
    buffer (n_dev, C, cap) holds JAX's buckets where(valid, ..., fill) and
    no validity channel; with the sentinel as the fill word every empty
    slot is the sentinel in every lane, so the slots that hold no sentinel
    are JAX's valid ones."""
    N, C = 600, 2
    stacked, valid, owner = route_case(700 + n_dev, N, C, n_dev)
    if hashed:
        owner = np.asarray(jhash.hash_lanes(jnp.asarray(stacked))
                           % np.uint32(n_dev)).astype(np.int32)
    n_valid = int(valid.sum())
    for cap in (2 * n_valid // n_dev + 1, max(1, n_valid // (3 * n_dev))):
        want = jpl._route_to_buckets(jnp.asarray(stacked), jnp.asarray(valid),
                                     jnp.asarray(owner), n_dev, cap,
                                     with_slots=True)
        send, bvalid = jax_send(want, n_dev, cap, int(tpl.SENTINEL))[0][:, :C], \
            np.asarray(want[1])
        got = tpl.route_to_buckets(t64(stacked), torch.from_numpy(valid),
                                   None if hashed else t64(owner), n_dev, cap,
                                   with_slots=True, fill=int(tpl.SENTINEL),
                                   with_valid=False)
        assert got[0].shape == (n_dev, C, cap)
        assert same(send.reshape(-1), got[0].reshape(-1))
        assert same(np.asarray(want[2]).reshape(-1), got[1].reshape(-1))
        assert same(np.asarray(want[3]).reshape(-1), got[2].reshape(-1))
        np.testing.assert_array_equal(
            (got[0] != tpl.SENTINEL).any(1).numpy(), bvalid)


def test_form_superkmers_row_lengths():
    """K13's plain version on rows of length 0, k - 1, k and 16W (a whole
    row), an all-A row (one run of keys across the row) and a random one."""
    k, m, W = 31, 10, 8
    P = 16 * W
    rng = np.random.RandomState(5)
    words = rng.randint(0, 2**32, size=(6, W), dtype=np.uint64).astype(np.uint32)
    words[4] = 0
    lengths = np.array([0, k - 1, k, P, P, 77], np.int32)
    jw, jl = jnp.asarray(words), jnp.asarray(lengths)
    rank = jmz.frequency_rank(np.asarray(jskm.sample_cmmer_histogram(
        jw, jl, k, m)))
    table = rng.randint(0, 4, 4 ** m).astype(np.int32)
    ms = 4
    out = jskm.form_superkmers(jw, jl, k, m, jnp.asarray(table),
                               jnp.asarray(rank), max_span=ms, use_rank=True,
                               with_pos=True, pos_base=np.uint32(7))
    tout = tskm.form_superkmers(t64(words), t64(lengths), k, m, t64(table),
                                t64(rank), ms, True, True, 7)
    for name, a, b in zip(("skm_words", "owner", "start", "n_kmers"), out,
                          tout):
        assert same(np.asarray(a).reshape(-1), b.reshape(-1)), name
    assert int(tout[3][0]) == 0 + 0 + 1 + 2 * (P - k + 1) + (77 - k + 1)


class _OneRank(Mesh):
    """A mesh of one rank: psum is the identity, no process group."""

    def psum(self, x):
        return x.clone()


@pytest.mark.parametrize("k,m", [(31, 10), (21, 8), (63, 12)])
@pytest.mark.parametrize("minimizer_type", [0, 1])
def test_sample_tables_multi_rounds(k, m, minimizer_type):
    """sample_tables_multi over four buffered rounds, one of them narrower
    (its rows are padded to the widest round's words before the single
    histogram pass), against bcalm_tpu's round-by-round sums: the
    frequency rank, the repartition table and the load, exact."""
    rounds = [block(k + 7 * i, k, n=30 + 9 * i, max_len=128 if i != 2 else 96)
              for i in range(4)]
    assert len({w.shape[1] for w, _ in rounds}) == 2
    for rtype in (0, 1):
        want = jpl.sample_tables_multi(
            rounds, k, jpl.MinimizerConfig(m=m, minimizer_type=minimizer_type,
                                           repartition_type=rtype), 4)
        got = tpl.sample_tables_multi(
            _OneRank(1, 0, torch.device("cpu")), rounds, k,
            tpl.MinimizerConfig(m=m, minimizer_type=minimizer_type,
                                repartition_type=rtype), 4)
        assert (got[0] is None) == (want[0] is None) == (minimizer_type == 0)
        if want[0] is not None:
            assert same(want[0], got[0])
        assert same(want[1], got[1]) and same(want[2], got[2])
        assert int(got[2].sum()) > 0
