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


# the chain decomposition's arrays: int32 in the JAX package (bool for
# circular), int64 (bool) tensors in the port
_CHAIN_KEYS = ("uid", "rank", "n_unitigs", "start_oid", "length", "circular")


def chain_info_to_numpy(info) -> dict:
    """Chain dict of tensors -> JAX's numpy form, as -only-uf stores it in
    chains.npz: int32 arrays (uid and rank of length 2C), a 0-d int32
    n_unitigs, bool circular."""
    out = {}
    for key in _CHAIN_KEYS:
        arr = info[key].cpu().numpy()
        if key == "n_unitigs":
            arr = arr.reshape(())
        out[key] = arr.astype(bool if key == "circular" else np.int32)
    return out


def chain_info_from_numpy(info, device) -> dict:
    """A chain dict in JAX's numpy form (chains.npz of either package) ->
    int64 tensors (bool circular) on `device`."""
    out = {}
    for key in _CHAIN_KEYS:
        arr = np.asarray(info[key])
        dtype = bool if key == "circular" else np.int64
        out[key] = torch.from_numpy(arr.astype(dtype).reshape(
            arr.shape if key != "n_unitigs" else (1,))).to(device)
    return out
