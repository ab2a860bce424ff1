"""Per-k-mer minimizers (K20 plain paths on the CPU) vs bcalm_tpu.

extract_mmers, minimizers (lexicographic and frequency-ranked),
mmer_histogram and partition_of of bcalm_tpu_torch.models.minimizer
against bcalm_tpu.models.minimizer on tests/test_minimizer.py's inputs,
and on k = 31, m = 10, k = 41 (three lanes), k = 151 (10 lanes) and
k = 255 (16 lanes), with and without a rank in which many m-mers tie (the
first minimal index must win).  Exact equality.
"""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bcalm_tpu.models import lanes as jln
from bcalm_tpu.models import minimizer as jmz
from bcalm_tpu_torch.models import minimizer as tmz


def kmers(k: int, n: int, seed: int):
    rng = random.Random(seed)
    arr = jln.ints_to_lanes([rng.getrandbits(2 * k) for _ in range(n)], k)
    return jnp.asarray(arr), torch.from_numpy(arr.astype(np.int64))


def tied_rank(m: int, seed: int) -> np.ndarray:
    """A (4^m,) rank with values in [0, 8): most m-mers of a k-mer tie."""
    return np.random.RandomState(seed).randint(0, 8, 4 ** m).astype(np.uint32)


@pytest.mark.parametrize("k,m", [(13, 5), (21, 8), (31, 10), (33, 10), (63, 10)])
def test_extract_mmers(k, m):
    jl, tl = kmers(k, 24, k * m)
    np.testing.assert_array_equal(tmz.extract_mmers(tl, k, m).numpy(),
                                  np.asarray(jmz.extract_mmers(jl, k, m)))


@pytest.mark.parametrize("k,m,n,ranked", [
    (21, 5, 50, False), (13, 3, 200, True), (31, 10, 500, False),
    (31, 10, 500, True), (41, 10, 300, False), (41, 10, 300, True),
    (151, 10, 120, False), (151, 11, 120, True), (255, 12, 80, False),
    (255, 11, 80, True)])
def test_minimizers_and_partition(k, m, n, ranked):
    jl, tl = kmers(k, n, k + n)
    rank = tied_rank(m, k) if ranked else None
    jr = None if rank is None else jnp.asarray(rank)
    tr = None if rank is None else torch.from_numpy(rank.astype(np.int64))
    want = np.asarray(jmz.minimizers(jl, k, m, jr))
    np.testing.assert_array_equal(tmz.minimizers(tl, k, m, tr).numpy(), want)
    table = (np.arange(4 ** m, dtype=np.int32) * 7) % 8
    np.testing.assert_array_equal(
        tmz.partition_of(tl, k, m, torch.from_numpy(table.astype(np.int64)),
                         tr).numpy(),
        np.asarray(jmz.partition_of(jl, k, m, jnp.asarray(table), jr)))


@pytest.mark.parametrize("k", [151, 255])
def test_minimizers_whole_lane(k):
    """m = 16: each m-mer a whole lane's width, at every offset into the
    lanes (lexicographic: a 4^16 rank or table would not fit)."""
    jl, tl = kmers(k, 100, k + 16)
    np.testing.assert_array_equal(tmz.minimizers(tl, k, 16).numpy(),
                                  np.asarray(jmz.minimizers(jl, k, 16)))


@pytest.mark.parametrize("k,m", [(13, 3), (31, 10), (41, 10), (151, 10),
                                 (255, 11)])
def test_mmer_histogram(k, m):
    jl, tl = kmers(k, 400, k)
    valid = np.random.RandomState(k).rand(400) < 0.8
    want = np.asarray(jmz.mmer_histogram(jl, jnp.asarray(valid), k, m))
    got = tmz.mmer_histogram(tl, torch.from_numpy(valid), k, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(valid.sum()) * (k - m + 1)


def test_frequency_minimizer_from_histogram():
    """tests/test_minimizer.py::test_frequency_minimizer's chain: the
    histogram, its frequency rank, the ranked minimizers."""
    k, m = 13, 3
    jl, tl = kmers(k, 200, 5)
    histo = tmz.mmer_histogram(tl, torch.ones(200, dtype=torch.bool), k, m)
    rank = tmz.frequency_rank(histo.numpy())
    np.testing.assert_array_equal(
        tmz.minimizers(tl, k, m, torch.from_numpy(rank.astype(np.int64))).numpy(),
        np.asarray(jmz.minimizers(jl, k, m, jnp.asarray(
            jmz.frequency_rank(np.asarray(jmz.mmer_histogram(
                jl, jnp.ones((200,), bool), k, m)))))))
