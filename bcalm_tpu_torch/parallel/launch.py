"""Ranks of a ``-devices N`` build: one process per device.

The JAX package runs its mesh as one program over N devices
(``bcalm_tpu/parallel/pipeline.py:make_mesh``).  Here each rank is a
process spawned with ``torch.multiprocessing`` (start method ``spawn``),
joined into one ``torch.distributed`` group: NCCL with rank r on
``cuda:r``, or gloo on the CPU (``BCALM_TORCH_DEVICE=cpu``), where the N
ranks stand in for the JAX package's N virtual CPU devices.

The group meets through a ``file://`` store in a fresh temporary
directory rather than a TCP port, so concurrent builds (parallel test
workers among them) cannot collide.  A CPU rank runs torch on one thread:
N ranks share the host's cores.

The function each rank runs must be importable by name (a module-level
function of this package): the spawned interpreters import it afresh.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bcalm_tpu_torch.parallel.mesh import Mesh


def init_group(n_dev: int, rank: int, device_kind: str,
               init_file: str) -> Mesh:
    """Join this process to the group of n_dev ranks meeting at init_file
    and return its mesh."""
    if device_kind == "cuda":
        torch.cuda.set_device(rank)
        backend, device = "nccl", torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        backend, device = "gloo", torch.device("cpu")
    dist.init_process_group(backend, init_method="file://" + init_file,
                            world_size=n_dev, rank=rank)
    return Mesh(n_dev, rank, device)


def _rank_main(rank: int, n_dev: int, device_kind: str, init_file: str, fn,
               args) -> None:
    mesh = init_group(n_dev, rank, device_kind, init_file)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn(n_dev: int, device_kind: str, fn, *args) -> None:
    """Run fn(mesh, *args) on n_dev spawned ranks and wait for all of
    them.  A rank that raises ends the others and re-raises here
    (torch.multiprocessing.ProcessRaisedException)."""
    with tempfile.TemporaryDirectory(prefix="bcalm_torch_group_") as tmp:
        mp.start_processes(
            _rank_main, args=(n_dev, device_kind, os.path.join(tmp, "group"),
                              fn, args),
            nprocs=n_dev, join=True, start_method="spawn")


def run_builds(mesh: Mesh, jobs, out_dir: str) -> None:
    """Run pipeline.distributed_build for each job on this rank and pickle
    what it produced to ``out_dir/<name>.<rank>.pkl``: the probe (the
    repartition table, this rank's solid run, on rank 0 the glue outputs),
    the abundance cutoff, and on rank 0 the stats and the FASTA text.

    A job is a dict: name, reads (strings), cfg (engine.EngineConfig);
    optional mcfg (pipeline.MinimizerConfig), reread (bool: allow the
    multi-pass key ranges), auto_amin_cap, store (a store prefix)."""
    import copy
    import io
    import pickle

    from bcalm_tpu_torch.io import fasta_writer
    from bcalm_tpu_torch.parallel import pipeline
    from bcalm_tpu_torch.storage.store import Store

    for job in jobs:
        reads = job["reads"]
        cfg = copy.deepcopy(job["cfg"])
        probe: dict = {}
        us = pipeline.distributed_build(
            mesh, reads, cfg, job.get("mcfg"),
            auto_amin_cap=job.get("auto_amin_cap"),
            store=Store(job["store"]) if job.get("store") else None,
            reread=(lambda: iter(reads)) if job.get("reread") else None,
            probe=probe)
        out = {"probe": probe, "abundance_min": cfg.abundance_min}
        if us is not None:
            text = io.StringIO()
            fasta_writer.write_fasta(us, text)
            out.update(fasta=text.getvalue(), stats=us.stats)
        path = os.path.join(out_dir, f"{job['name']}.{mesh.rank}.pkl")
        with open(path, "wb") as f:
            pickle.dump(out, f)
