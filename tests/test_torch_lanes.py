"""bcalm_tpu_torch.models.lanes + ops.sort vs bcalm_tpu.models.lanes.

Inputs are numpy from a fixed seed, fed to both packages through
bcalm_tpu_torch.convert; every output is integer and must be equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bcalm_tpu.models import lanes as jln
from bcalm_tpu_torch import convert
from bcalm_tpu_torch.models import lanes as tln
from bcalm_tpu_torch.ops import sort as tsort

KS = [13, 21, 31, 32, 33, 63]
_RC = str.maketrans("ACGT", "TGCA")


def kmer_lanes(k: int, n: int, seed: int) -> np.ndarray:
    """Random k-mers plus, for even k, palindromes (s + revcomp(s))."""
    rng = np.random.RandomState(seed)
    seqs = ["".join("ACGT"[c] for c in rng.randint(0, 4, k)) for _ in range(n)]
    if k % 2 == 0:
        for _ in range(8):
            half = "".join("ACGT"[c] for c in rng.randint(0, 4, k // 2))
            seqs.append(half + half.translate(_RC)[::-1])
    seqs += ["G" * k, "A" * k, "C" * k]
    return jln.ints_to_lanes([jln.string_to_int(s) for s in seqs], k)


def tensor(x):
    return convert.lanes_from_numpy(x, "cpu")


@pytest.mark.parametrize("k", KS)
def test_lane_ops_match(k):
    x = kmer_lanes(k, 64, k)
    xj, xt = jnp.asarray(x), tensor(x)
    assert tln.num_lanes(k) == jln.num_lanes(k)
    assert tln.top_lane_bases(k) == jln.top_lane_bases(k)
    np.testing.assert_array_equal(
        convert.lanes_to_numpy(tln.revcomp(xt, k)), np.asarray(jln.revcomp(xj, k)))
    cj, rj = jln.canonical(xj, k)
    ct, rt = tln.canonical(xt, k)
    np.testing.assert_array_equal(convert.lanes_to_numpy(ct), np.asarray(cj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    pal = tln.is_palindrome(xt, k).numpy()
    np.testing.assert_array_equal(pal, np.asarray(jln.is_palindrome(xj, k)))
    assert pal.any() == (k % 2 == 0)
    for tf, jf in ((tln.suffix_kminus1, jln.suffix_kminus1),
                   (tln.prefix_kminus1, jln.prefix_kminus1)):
        np.testing.assert_array_equal(convert.lanes_to_numpy(tf(xt, k)),
                                      np.asarray(jf(xj, k)))
    np.testing.assert_array_equal(
        tln.less(xt[:, :-1], xt[:, 1:]).numpy(),
        np.asarray(jln.less(xj[:, :-1], xj[:, 1:])))


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5])
def test_lex_argsort_is_stable_lexicographic(L):
    """Packed int64 keys sort like numpy's unsigned lexicographic lexsort,
    stably, including the all-ones sentinel and top-bit lane values."""
    rng = np.random.RandomState(L)
    pool = rng.randint(0, 2**32, size=(L, 40), dtype=np.uint64).astype(np.uint32)
    pool[:, 0] = 0xFFFFFFFF
    pool[:, 1] = 0
    pool[0, 2] = 0x80000000
    x = pool[:, rng.randint(0, 40, 500)]
    perm = tsort.lex_argsort(list(tensor(x))).numpy()
    expect = np.lexsort(tuple(x[j] for j in reversed(range(L))))
    np.testing.assert_array_equal(perm, expect)
