"""Ranks of a ``-devices N`` build: one process per device.

The JAX package runs its mesh as one program over N devices
(``bcalm_tpu/parallel/pipeline.py:make_mesh``).  Here each rank is a
process spawned with ``torch.multiprocessing`` (start method ``spawn``),
joined into one ``torch.distributed`` group: NCCL with rank r on
``cuda:r``, or gloo on the CPU (``BCALM_TORCH_DEVICE=cpu``), where the N
ranks stand in for the JAX package's N virtual CPU devices.

On one host (``spawn``) the group meets through a ``file://`` store in a
fresh temporary directory rather than a TCP port, so concurrent builds
(parallel test workers among them) cannot collide.  Across hosts (the
JAX package's ``jax.distributed.initialize`` over several processes,
``tests/multihost_worker.py``) each host runs one launcher,
``spawn_host``, whose ranks meet at ``tcp://<first host>:<port>``; or each
rank is started by an outside launcher and joins with ``init_from_env``
(``env://``: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK).  A
CUDA rank takes the card of its local rank, its index on its own host.  A
CPU rank runs torch on one thread: the ranks share the host's cores.

The function each rank runs must be importable by name (a module-level
function of this package): the spawned interpreters import it afresh.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from bcalm_tpu_torch.parallel.mesh import Mesh


def init_group(n_dev: int, rank: int, device_kind: str, init_method: str,
               local_rank: Optional[int] = None) -> Mesh:
    """Join this process, rank `rank` of n_dev, to the group meeting at
    init_method (``file://<path>``, ``tcp://<host>:<port>`` or ``env://``)
    and return its mesh.  A CUDA rank uses ``cuda:<local_rank>`` (default:
    rank, all ranks on one host)."""
    local = rank if local_rank is None else local_rank
    if device_kind == "cuda":
        torch.cuda.set_device(local)
        backend, device = "nccl", torch.device("cuda", local)
    else:
        torch.set_num_threads(1)
        backend, device = "gloo", torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=n_dev, rank=rank)
    return Mesh(n_dev, rank, device)


def init_from_env(device_kind: str) -> Mesh:
    """Join the group the environment describes, one rank per process
    started by an outside launcher (torchrun's variables): RANK,
    WORLD_SIZE, LOCAL_RANK, and MASTER_ADDR, MASTER_PORT for ``env://``."""
    rank = int(os.environ["RANK"])
    return init_group(int(os.environ["WORLD_SIZE"]), rank, device_kind,
                      "env://", int(os.environ.get("LOCAL_RANK", rank)))


def _rank_main(local: int, n_dev: int, rank_base: int, device_kind: str,
               init_method: str, fn, args) -> None:
    mesh = init_group(n_dev, rank_base + local, device_kind, init_method,
                      local)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn_host(n_local: int, n_dev: int, rank_base: int, init_method: str,
               device_kind: str, fn, *args) -> None:
    """This host's share of a group of n_dev ranks: run fn(mesh, *args) on
    n_local spawned ranks, global ranks rank_base .. rank_base + n_local - 1
    on local ranks 0 .. n_local - 1, meeting the other hosts' ranks at
    init_method (``tcp://<host of rank 0>:<port>``), and wait for them.  A
    rank that raises ends this host's others and re-raises here
    (torch.multiprocessing.ProcessRaisedException)."""
    mp.start_processes(
        _rank_main, args=(n_dev, rank_base, device_kind, init_method, fn,
                          args),
        nprocs=n_local, join=True, start_method="spawn")


def spawn(n_dev: int, device_kind: str, fn, *args) -> None:
    """Run fn(mesh, *args) on n_dev spawned ranks of this host, meeting
    through a ``file://`` store, and wait for all of them."""
    with tempfile.TemporaryDirectory(prefix="bcalm_torch_group_") as tmp:
        spawn_host(n_dev, n_dev, 0, "file://" + os.path.join(tmp, "group"),
                   device_kind, fn, *args)


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


def run_entry_points(mesh: Mesh, jobs, out_dir: str) -> None:
    """Run the per-k-mer mesh entry points for each job on this rank and
    pickle what they gave to ``out_dir/<name>.<rank>.pkl``.

    A job is a dict with a name and a kind:
      "count": words, lengths (a global packed block), k, cap, amin, amax;
        pipeline.distributed_count then gather_solid: this rank's unique
        and counts (numpy), n_unique, dropped, and the gathered solid set;
      "compact_pos": solid, counts, pos (per-device host lists), k;
        distcompact.distributed_compact_pos;
      "compact": solid, counts, k; distcompact.distributed_compact.
    The compactions pickle, on rank 0, the UnitigSet's seqs, kc,
    abundances, circular and links."""
    import pickle

    from bcalm_tpu_torch.parallel import distcompact, pipeline

    for job in jobs:
        kind = job["kind"]
        if kind == "count":
            res = pipeline.distributed_count(mesh, job["words"], job["lengths"],
                                             job["k"], job["cap"])
            solid, counts = pipeline.gather_solid(res, job["amin"], job["amax"])
            out = {"unique": res.unique.cpu().numpy(),
                   "counts": res.counts.cpu().numpy(),
                   "n_unique": res.n_unique, "dropped": res.dropped,
                   "solid": solid, "solid_counts": counts}
        else:
            if kind == "compact_pos":
                us = distcompact.distributed_compact_pos(
                    mesh, job["solid"], job["counts"], job["pos"], job["k"])
            else:
                us = distcompact.distributed_compact(mesh, job["solid"],
                                                     job["counts"], job["k"])
            out = None if us is None else {
                "seqs": us.seqs, "kc": us.kc, "abundances": us.abundances,
                "circular": us.circular, "links": us.links, "stats": us.stats}
        path = os.path.join(out_dir, f"{job['name']}.{mesh.rank}.pkl")
        with open(path, "wb") as f:
            pickle.dump(out, f)
