"""Host-side DNA string helpers (ASCII <-> 2-bit code, reverse complement).

Copy of ``bcalm_tpu/utils/dna.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# code order A=0 C=1 T=2 G=3 (gatb convention, complement = code ^ 2)
CODE_TO_ASCII = np.frombuffer(b"ACTG", dtype=np.uint8)
_RC = {"A": "T", "C": "G", "G": "C", "T": "A",
       "a": "t", "c": "g", "g": "c", "t": "a"}


def revcomp(s: str) -> str:
    return "".join(_RC[c] for c in reversed(s))


def codes_to_str(codes: np.ndarray) -> str:
    """uint8/int array of 2-bit codes -> ACTG string."""
    return CODE_TO_ASCII[np.asarray(codes, dtype=np.int64)].tobytes().decode()
