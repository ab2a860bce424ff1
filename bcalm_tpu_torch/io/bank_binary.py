"""Binary packed-block bank (gatb BankBinary analog).

The reference converts text banks to a compact binary sequence format for
repeated passes (bank/impl/BankBinary — reconstructed, SURVEY.md §3.2).
Here the natural binary form IS the device block layout: 2-bit packed
uint32 words + lengths.  Writing the block stream to an npz container lets
repeated runs (or the multi-pass counting of datasets much larger than
HBM) skip parsing entirely.

Copy of ``bcalm_tpu/io/bank_binary.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator

import numpy as np

from bcalm_tpu_torch.io.packing import ReadBlock

MAGIC = "btpu-bank-v1"


def write_bank(blocks: Iterable[ReadBlock], path: str) -> int:
    """Serialize a block stream; returns number of blocks written."""
    words = []
    lengths = []
    for b in blocks:
        words.append(b.words)
        lengths.append(b.lengths)
    n = len(words)
    np.savez_compressed(
        path,
        magic=np.array(MAGIC),
        n_blocks=np.array(n),
        **{f"w{i}": w for i, w in enumerate(words)},
        **{f"l{i}": l for i, l in enumerate(lengths)},
    )
    return n


def read_bank(path: str) -> Iterator[ReadBlock]:
    data = np.load(path)
    if str(data["magic"]) != MAGIC:
        raise ValueError(f"not a bcalm-tpu binary bank: {path}")
    n = int(data["n_blocks"])
    for i in range(n):
        yield ReadBlock(data[f"w{i}"], data[f"l{i}"])


def is_binary_bank(path: str) -> bool:
    return path.endswith(".btpu.npz") and os.path.exists(path)
