"""Stage storage: the checkpoint/resume layer.

The reference persists counted solid k-mers, the abundance histogram, the
minimizer repartition table and config into a `.h5` HDF5 store (or
`_gatb/` directory) which doubles as the checkpoint for the stage-skipping
flags `-skip-bcalm -skip-bglue -redo-links`
(reference/README.md:103, scripts/pufferize.py:143), and deletes it
after a successful run (reference/src/bcalm_1.cpp:64-77).

Here the store is a `<prefix>_btpu/` directory holding npz arrays + a JSON
manifest — same lifecycle, same resume semantics, no 300k-LoC HDF5 vendor
dependency.

Copy of ``bcalm_tpu/storage/store.py`` with the imports pointed at this package
(and the reference's paths given from its root):
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np

SUFFIX = "_btpu"
MANIFEST = "manifest.json"


class Store:
    def __init__(self, prefix: str):
        self.path = prefix + SUFFIX

    def exists(self) -> bool:
        return os.path.isfile(os.path.join(self.path, MANIFEST))

    def _manifest(self) -> Dict:
        with open(os.path.join(self.path, MANIFEST)) as f:
            return json.load(f)

    def write_counts(self, solid: np.ndarray, counts: np.ndarray, k: int,
                     histogram: Optional[np.ndarray] = None,
                     config: Optional[Dict] = None,
                     minpos: Optional[np.ndarray] = None) -> None:
        os.makedirs(self.path, exist_ok=True)
        arrays = {"lanes": solid, "counts": counts}
        if minpos is not None:
            # first-occurrence keys: persisted so a -skip-bcalm resume
            # keeps the locality-ordered compaction fast path (and the
            # deterministic reorder that chain checkpoints rely on)
            arrays["minpos"] = minpos
        # UNcompressed: packed canonical k-mers are near-incompressible,
        # and single-core zlib on a 2.4 GB genome-scale table costs
        # minutes; np.load reads both formats, so old stores stay valid
        np.savez(os.path.join(self.path, "solid.npz"), **arrays)
        if histogram is not None:
            np.save(os.path.join(self.path, "histogram.npy"), histogram)
        manifest = {
            "k": k,
            "n_solid": int(solid.shape[1]),
            "lanes": int(solid.shape[0]),
            "config": config or {},
        }
        with open(os.path.join(self.path, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)

    def read_counts(
        self, k: int
    ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        m = self._manifest()
        if m["k"] != k:
            raise ValueError(
                f"stored counts are for k={m['k']}, requested k={k}"
            )
        data = np.load(os.path.join(self.path, "solid.npz"))
        minpos = data["minpos"] if "minpos" in data.files else None
        return data["lanes"], data["counts"], minpos

    def config(self) -> Dict:
        """Stored counting parameters (abundance_min/max, solidity kind) —
        validated on resume so a stale store can never silently produce
        wrong output (a lower new cutoff cannot be served from post-filter
        counts; a higher one is re-filtered by the caller)."""
        return self._manifest().get("config", {})

    # -- chain-decomposition checkpoint (the glue-file analog:
    # -only-uf persists it, -skip-bglue resumes from it; reference stage
    # boundary evidenced by scripts/pufferize.py:143 + the on-disk
    # *.glue* files of test/simple_test.sh:6) --

    def write_chains(self, info: Dict, k: int, n_solid: int) -> None:
        os.makedirs(self.path, exist_ok=True)
        arrays = {key: np.asarray(val) for key, val in info.items()}
        np.savez_compressed(os.path.join(self.path, "chains.npz"),
                            k=np.int64(k), n_solid=np.int64(n_solid),
                            **arrays)

    def has_chains(self) -> bool:
        return os.path.exists(os.path.join(self.path, "chains.npz"))

    def read_chains(self, k: int, n_solid: int) -> Dict:
        data = np.load(os.path.join(self.path, "chains.npz"))
        if int(data["k"]) != k:
            raise ValueError(
                f"stored chains are for k={int(data['k'])}, requested k={k}"
            )
        if int(data["n_solid"]) != n_solid:
            raise ValueError(
                f"chain checkpoint is stale (built for {int(data['n_solid'])} "
                f"solid k-mers, current set has {n_solid}); rerun without "
                f"-skip-bglue"
            )
        return {key: data[key] for key in data.files
                if key not in ("k", "n_solid")}

    # -- minimizer repartition table (the reference persists
    # `minimizers/repartition` in its .h5 store — SURVEY.md §3.2 Storage
    # row; lets resumed/incremental runs reuse the frequency-balanced
    # routing instead of resampling) --

    def write_repartition(self, table: np.ndarray,
                          freq_rank: Optional[np.ndarray], m: int) -> None:
        os.makedirs(self.path, exist_ok=True)
        arrays = {"table": np.asarray(table), "m": np.int64(m)}
        if freq_rank is not None:
            arrays["freq_rank"] = np.asarray(freq_rank)
        np.savez_compressed(os.path.join(self.path, "repartition.npz"),
                            **arrays)

    def read_repartition(self):
        p = os.path.join(self.path, "repartition.npz")
        if not os.path.exists(p):
            return None
        data = np.load(p)
        return {
            "table": data["table"],
            "freq_rank": (data["freq_rank"]
                          if "freq_rank" in data.files else None),
            "m": int(data["m"]),
        }

    def read_histogram(self) -> Optional[np.ndarray]:
        p = os.path.join(self.path, "histogram.npy")
        return np.load(p) if os.path.exists(p) else None

    def remove(self) -> None:
        """End-of-run cleanup (the reference removes its .h5,
        src/bcalm_1.cpp:64-77)."""
        if os.path.isdir(self.path):
            shutil.rmtree(self.path)
