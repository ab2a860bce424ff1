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


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def same(j, t) -> bool:
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return j.shape == t.shape and np.array_equal(j.astype(np.int64),
                                                 t.astype(np.int64))


def block(seed: int, k: int, n: int = 37, max_len: int = 128):
    rng = random.Random(seed)
    seqs = ["".join(rng.choice("ACGT") for _ in range(rng.randint(5, 120)))
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
    for k in (13, 15, 21, 31, 33, 63, 127):
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
                                          (33, 11, None)])
@pytest.mark.parametrize("use_rank", [False, True])
@pytest.mark.parametrize("with_pos", [False, True])
def test_form_superkmers(k, m, max_span, use_rank, with_pos):
    words, lengths = block(k * m, k)
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
    for name, a, b in zip(("buckets", "bucket_valid", "dropped", "slots"),
                          want, got):
        assert same(np.asarray(a).reshape(-1), b.reshape(-1)), name
    assert (int(got[2][0]) > 0) == overflow
    plain = tpl.route_to_buckets(t64(stacked), torch.from_numpy(valid),
                                 t64(owner), n_dev, cap)
    assert len(plain) == 3 and all(torch.equal(a, b)
                                   for a, b in zip(plain, got[:3]))
