"""K3 successor_arrays (plain path on the CPU) vs bcalm_tpu.ops.junctions.

The solid sets come from reads over a repeat-seeded genome plus reads
holding palindromic (k-1)-mers and hairpins (a sequence followed by its
reverse complement); k-1 > 48 takes the 96-bit hashed key path.  The
table is shuffled and padded with sentinel columns past n_solid, as the
engine hands it over.  The long-k cases take (k-1) mod 16 to 0, 1 and 15
and the lane counts 2-32, where the kernel's word-parallel reverse
complement shifts whole words and bits.  Exact equality.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from bcalm_tpu.models import lanes as jln
from bcalm_tpu.ops import junctions as jjunc
from bcalm_tpu.oracle import brute
from bcalm_tpu_torch import convert
from bcalm_tpu_torch.ops import junctions as tjunc
from bcalm_tpu_torch.ops.runchains import round_capacity

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


# (k-1) mod 16 in {0, 1, 15}, both sides of the hash threshold (k-1 > 48),
# 2, 4, 5, 9, 11, 17 and 32 lanes
LONG_K = [17, 49, 50, 65, 129, 161, 257, 512]


@pytest.mark.parametrize("k", [13, 21, 31, 32, 33, 51, 63] + LONG_K)
def test_successor_arrays_match(k):
    solid, n = solid_table(k, k)
    assert tjunc.use_hash_keys(k) == jjunc.use_hash_keys(k) == (k - 1 > 48)
    js, _ = jjunc.successor_arrays(jnp.asarray(solid), jnp.asarray(n, jnp.int32), k)
    ts = tjunc.successor_arrays(convert.lanes_from_numpy(solid, "cpu"), n, k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts >= 0).sum() > n // 2


def test_hash96_matches():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 2**32, size=(4, 257), dtype=np.uint64).astype(np.uint32)
    keys[:, 0] = 0xFFFFFFFF
    jh = jjunc._hash96(jnp.asarray(keys))
    th = tjunc.hash96(convert.lanes_from_numpy(keys, "cpu"))
    for a, b in zip(th, jh):
        np.testing.assert_array_equal(convert.lanes_to_numpy(a), np.asarray(b))


def jax_junction_keys(solid: np.ndarray, n: int, k: int):
    """The key rows and payload bcalm_tpu.ops.junctions.successor_arrays
    sorts, built from its own lane functions (before its sort)."""
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
    if jjunc.use_hash_keys(k):
        hs, hp = jjunc._hash96(suf_c), jjunc._hash96(pre_c)
        keys = np.stack([np.concatenate([np.where(vs, np.asarray(hs[i]), 0xFFFFFFFF),
                                         np.where(vp, np.asarray(hp[i]), 0xFFFFFFFF)])
                         for i in range(3)])
    else:
        keys = np.concatenate([np.where(vs[None], np.asarray(suf_c), 0xFFFFFFFF),
                               np.where(vp[None], np.asarray(pre_c), 0xFFFFFFFF)], axis=1)
    return keys.astype(np.uint32), payload


@pytest.mark.parametrize("k", LONG_K)
def test_junction_keys_plain_match(k):
    """K3a's plain version (what the kernel is held against on the card):
    keys and payload of every entry, palindromic and past n_solid
    included."""
    solid, n = solid_table(k, k + 1)
    keys, payload = tjunc.junction_keys_plain(
        convert.lanes_from_numpy(solid, "cpu"), n - 2, k)
    want_keys, want_payload = jax_junction_keys(solid, n - 2, k)
    assert keys.shape[0] == tjunc.key_rows(k)
    np.testing.assert_array_equal(convert.lanes_to_numpy(keys), want_keys)
    np.testing.assert_array_equal(payload.numpy(), want_payload)
    assert (want_keys[0] == 0xFFFFFFFF).sum() >= 4  # the two cut columns' sides
