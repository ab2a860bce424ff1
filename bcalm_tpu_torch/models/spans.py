"""Runtime k -> static lane-span dispatch (Integer::apply analog).

The reference instantiates its algorithms per KSIZE_LIST compile-time span
and dispatches at runtime (`Integer::apply<Functor>(k, ...)`,
the reference's src/bcalm_1.cpp:95; KSIZE contract README.md:93-99:
multiples of 32, larger spans run slower).  Here every op is already
parameterized by the static pair (k, L=ceil(k/16)); jit tracing per (k, L)
IS the instantiation, so any k up to MAX_K works without a rebuild —
the TPU analog of recompiling with a bigger KSIZE_LIST is just a new trace.

This module centralizes validation and exposes the span table for tools
that want to enumerate supported configurations.

Copy of ``bcalm_tpu/models/spans.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from . import lanes as ln

# practical ceiling: beyond this the L-lane sorts dominate and block sizes
# need retuning (the reference's README documents the same slowdown trend
# for large KSIZE spans)
MAX_K = 512


def validate_k(k: int) -> int:
    if not isinstance(k, int):
        raise TypeError(f"k must be an int, got {type(k).__name__}")
    if k < 2:
        raise ValueError(f"k-mer size must be >= 2, got {k}")
    if k > MAX_K:
        raise ValueError(
            f"k-mer size {k} exceeds MAX_K={MAX_K}; raise bcalm_tpu_torch.models."
            f"spans.MAX_K if you really need this (expect slow sorts)"
        )
    return k


def span_of(k: int) -> int:
    """Lane count for k (the 'span' of the compiled kernel family)."""
    return ln.num_lanes(validate_k(k))


def span_table(max_k: int = MAX_K):
    """[(span_lanes, k_min, k_max)] — the analog of the KSIZE_LIST table."""
    out = []
    k = 2
    while k <= max_k:
        L = ln.num_lanes(k)
        k_max = min(max_k, L * ln.BASES_PER_LANE)
        out.append((L, k, k_max))
        k = k_max + 1
    return out
