"""K1 extract_insert (plain path on the CPU) vs bcalm_tpu engine._extract_insert.

Blocks hold N-split reads, reads shorter than k and reads longer than the
block width (windowed by io.packing); the stream slot base includes one
near 2**31, where (slot << 1) wraps and the key clamp below the sentinel
matters.  Outputs are integer: exact equality.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bcalm_tpu import engine as jengine
from bcalm_tpu.io import packing
from bcalm_tpu.models import lanes as jln
from bcalm_tpu_torch import convert
from bcalm_tpu_torch.ops import extract as textract


def reads(k: int, seed: int):
    rng = np.random.RandomState(seed)
    out = ["".join("ACGT"[c] for c in rng.randint(0, 4, rng.randint(k, 90)))
           for _ in range(14)]
    out.append(out[0][:10] + "N" + out[1])        # N split
    out.append("ACGTN" * 20)                      # N every 5 bases
    out.append(out[2][: k - 1])                   # shorter than k
    out.append("".join("ACGT"[c] for c in rng.randint(0, 4, 150)))  # windowed
    return out


@pytest.mark.parametrize("k", [13, 21, 31, 32, 33, 63])
def test_extract_insert_matches(k):
    L = jln.num_lanes(k)
    blocks = list(packing.iter_blocks(reads(k, k), k, block_reads=8,
                                      max_len=64))
    assert len(blocks) >= 2
    F = textract.block_slots(blocks[0].words.shape, k)
    cap = len(blocks) * F + 5
    for slot_base in (0, 12345, 0x7FFFFFFF - 3):
        jbuf = jnp.full((L + 1, cap), np.uint32(0xFFFFFFFF), jnp.uint32)
        tbuf = torch.full((L + 1, cap), 0xFFFFFFFF, dtype=torch.int64)
        offset = 5
        for i, b in enumerate(blocks):
            sb = (slot_base + i * F) & 0x7FFFFFFF
            jbuf = jengine._extract_insert(
                jbuf, jnp.asarray(b.words), jnp.asarray(b.lengths), k,
                np.uint32(sb), jnp.asarray(offset, jnp.int32))
            textract.extract_insert(
                tbuf, convert.lanes_from_numpy(b.words, "cpu"),
                torch.from_numpy(b.lengths.astype(np.int64)), k, sb, offset)
            offset += F
        np.testing.assert_array_equal(convert.lanes_to_numpy(tbuf),
                                      np.asarray(jbuf))
    assert (np.asarray(jbuf)[L] != 0xFFFFFFFF).any()
