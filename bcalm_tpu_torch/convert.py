"""Carry state between the JAX package's numpy arrays and the port's tensors.

The system has no weights; its state is the lane tables and count arrays.
Lanes and first-occurrence keys are u32 in the JAX package and int64
tensors holding values in [0, 2**32) in the port; counts are int32 in the
JAX package and int64 in the port (sums accumulate in int64).
"""

from __future__ import annotations

import numpy as np
import torch


def lanes_from_numpy(lanes: np.ndarray, device) -> torch.Tensor:
    """(L, N) np.uint32 -> (L, N) torch.int64 on `device`."""
    return torch.from_numpy(np.asarray(lanes, np.uint32).astype(np.int64)).to(device)


def lanes_to_numpy(lanes: torch.Tensor) -> np.ndarray:
    """Inverse of lanes_from_numpy."""
    return lanes.cpu().numpy().astype(np.uint32)


def counts_from_numpy(counts: np.ndarray, device) -> torch.Tensor:
    """(N,) np.int32 -> (N,) torch.int64."""
    return torch.from_numpy(np.asarray(counts, np.int32).astype(np.int64)).to(device)


def counts_to_numpy(counts: torch.Tensor) -> np.ndarray:
    """(N,) int64 counts -> np.int32, clamped at 2**31 - 1 like the JAX
    package's host merge (engine._host_range_merge)."""
    return np.minimum(counts.cpu().numpy(), 2**31 - 1).astype(np.int32)


def pos_from_numpy(pos: np.ndarray, device) -> torch.Tensor:
    """(N,) np.uint32 first-occurrence keys -> torch.int64."""
    return lanes_from_numpy(pos, device)


def pos_to_numpy(pos: torch.Tensor) -> np.ndarray:
    return lanes_to_numpy(pos)


_SHARED_CONFIG_FIELDS = ("k", "abundance_min", "abundance_max", "block_reads",
                         "max_len", "histo_max")


def engine_config_from_jax(cfg):
    """bcalm_tpu.engine.EngineConfig -> bcalm_tpu_torch.engine.EngineConfig.

    Carries the fields that define the output (k, solidity bounds, block
    geometry, histogram size).  The TPU memory-sizing fields (chunk and
    resident budgets, spill and block-cache settings) are not carried: the
    port sizes its own for the GPU, and its output does not depend on them."""
    from bcalm_tpu_torch.engine import EngineConfig

    return EngineConfig(**{f: getattr(cfg, f) for f in _SHARED_CONFIG_FIELDS})
