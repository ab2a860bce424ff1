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


def long_reads(k: int, seed: int):
    """Reads for k past the 64-base width of reads(): some shorter than
    k, one empty, one N-split."""
    rng = np.random.RandomState(seed)
    out = ["".join("ACGT"[c] for c in rng.randint(0, 4, rng.randint(k, k + 50)))
           for _ in range(10)]
    out.append(out[0][: k - 3])                   # shorter than k
    out.append(out[1][:40] + "N" + out[2])        # N split
    return out


@pytest.mark.parametrize("k", [13, 31, 151])    # L = 1, 2, 10
def test_extract_insert_range_mode_matches_jax(k):
    """Range mode: bcalm_tpu's _extract_insert followed by the fold of
    _count_chunk_ranged over the block's columns.  lo and hi are keys of
    the block itself, so some columns equal a bound exactly (lo kept, hi
    folded)."""
    L = jln.num_lanes(k)
    rng = np.random.RandomState(k)
    max_len = 64 if k < 64 else k + 64
    src = reads(k, k) if k < 64 else long_reads(k, k)
    blocks = list(packing.iter_blocks(src, k, block_reads=8, max_len=max_len))
    n_checked = 0
    for b in blocks:
        F = textract.block_slots(b.words.shape, k)
        words = jnp.asarray(b.words)
        jbuf = jengine._extract_insert(
            jnp.full((L + 1, F + 3), np.uint32(7), jnp.uint32), words,
            jnp.asarray(b.lengths), k, np.uint32(0x7FFFFF00),
            jnp.asarray(3, jnp.int32))
        body = np.asarray(jbuf)[:, 3:]
        live = np.flatnonzero(body[L] != 0xFFFFFFFF)
        if live.size < 4:
            continue
        keys = sorted({tuple(body[:L, i]) for i in rng.choice(live, 4)})
        for lo, hi in [(keys[0], keys[-1]), (keys[1], (0xFFFFFFFF,) * L),
                       ((0,) * L, keys[-2])]:
            jlo, jhi = (jnp.asarray(np.array(x, np.uint32)) for x in (lo, hi))
            keep = (~jengine._lex_lt(jnp.asarray(body[:L]), jlo)
                    & jengine._lex_lt(jnp.asarray(body[:L]), jhi))
            want = np.asarray(jbuf).copy()
            want[:, 3:] = np.asarray(jnp.where(keep[None], body,
                                               np.uint32(0xFFFFFFFF)))
            tbuf = torch.full((L + 1, F + 3), 7, dtype=torch.int64)
            textract.extract_insert(
                tbuf, convert.lanes_from_numpy(b.words, "cpu"),
                torch.from_numpy(b.lengths.astype(np.int64)), k, 0x7FFFFF00,
                3, lo=[int(x) for x in lo], hi=[int(x) for x in hi])
            np.testing.assert_array_equal(convert.lanes_to_numpy(tbuf), want)
            kept = np.asarray(keep)
            assert kept.any() and not kept.all()
            on_bound = [(body[:L, i] == np.array(lo, np.uint32)).all()
                        for i in np.flatnonzero(kept)]
            assert any(on_bound) or lo == (0,) * L
            n_checked += 1
    assert n_checked >= 3
