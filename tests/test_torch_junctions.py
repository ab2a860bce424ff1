"""K3 successor_arrays (plain path on the CPU) vs bcalm_tpu.ops.junctions.

The solid sets come from reads over a repeat-seeded genome plus reads
holding palindromic (k-1)-mers and hairpins (a sequence followed by its
reverse complement); k-1 > 48 takes the 96-bit hashed key path.  The
table is shuffled and padded with sentinel columns past n_solid, as the
engine hands it over.  Exact equality.
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


@pytest.mark.parametrize("k", [13, 21, 31, 32, 33, 51, 63])
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
