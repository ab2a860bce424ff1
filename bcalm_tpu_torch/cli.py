"""Command line of the port: the single-device build.

    python -m bcalm_tpu_torch -in reads.fa -kmer-size 31 -abundance-min 2 \
        [-out prefix] [-max-memory MiB] [-max-disk MB]

The option surface, the input block stream, the output naming and the
store are the JAX package's (bcalm_tpu.cli.build_parser, _input_blocks,
default_prefix; bcalm_tpu.storage.store.Store), so both packages read the
same blocks, write the same ``<prefix>.unitigs.fa`` and read each other's
``<prefix>_btpu/`` checkpoint.  As in bcalm_tpu.cli.main:

- the build checkpoints its solid k-mers in ``<prefix>_btpu/`` and removes
  it at the end; ``-only-uf`` stops after the chain decomposition and
  keeps the store with ``chains.npz``; ``-skip-bcalm`` resumes from the
  stored counts (refiltering at a higher cutoff, refusing a lower one),
  ``-skip-bglue`` also from the stored chains; ``-redo-links`` rewrites
  the links of an existing unitigs file;
- a file of filenames with ``-solidity-kind min|max`` counts each sample
  at abundance 1 and combines the counts (combine_sample_counts);
- ``-abundance-min auto`` takes the histogram's first valley, capped by
  ``-abundance-min-threshold``; ``-solid-kmers-out`` lists the solid
  k-mers with their counts; ``-uf-stats`` adds chain statistics.

The device is ``cuda`` unless ``BCALM_TORCH_DEVICE`` names another; a
requested CUDA device that is absent is an error, never a silent CPU run.
``-max-memory`` sizes the counting chunk and the resident budget
(engine.configure_chunk; without it, the device's memory does); a distinct
set past that budget is counted in several passes over key ranges, each
re-reading the input.  ``-server``/``-connect`` and ``-devices > 1`` exit
1 and name their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import torch

from bcalm_tpu.cli import build_parser, default_prefix
from bcalm_tpu.utils.options import OptionFailure
from bcalm_tpu.utils.timeinfo import TimeInfo, peak_rss_mb
from bcalm_tpu.version import version_string

DEVICE_ENV = "BCALM_TORCH_DEVICE"


def _not_ported(what: str, item: str) -> int:
    print(f"{what}: not yet ported (ROADMAP {item})", file=sys.stderr)
    return 1


def adapt_max_len(bank, cfg) -> None:
    """Block geometry and occurrence estimate from the bank: the max_len
    and est_total_occ rules of bcalm_tpu.cli._adapt_max_len, so both
    packages cut the input into identical blocks (first-occurrence keys
    depend on it).  The chunk stays configure_chunk's: the JAX rule's
    2^24 chunk at >= 2^26 occurrences was measured on a TPU."""
    sampled = bank.sample_max_len()
    if sampled >= cfg.k:
        cfg.max_len = max(cfg.k + 1, min(512, -(-sampled // 16) * 16))
    raw = sum(os.path.getsize(p) for p in bank.paths if os.path.exists(p))
    mult = 3.0 if any(str(p).endswith(".gz") for p in bank.paths) else 1.0
    bases = raw * mult * 0.9
    if sampled > 0 and bases > 0:
        cfg.est_total_occ = int(
            bases * max(0.1, 1.0 - (cfg.k - 1) / max(cfg.k, sampled)))


def redo_links(unitigs_path: str, k: int, verbose: int) -> None:
    """Recompute every L: field of an existing unitigs file in place, the
    other header fields kept (bcalm_tpu.cli.redo_links)."""
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.io import fasta_writer

    seqs, headers = fasta_writer.parse_unitigs_fasta(unitigs_path)
    by_src: dict = {}
    for (u, su, v, sv) in engine.link_join(seqs, k):
        by_src.setdefault(u, []).append(f"L:{su}:{v}:{sv}")
    with open(unitigs_path, "w") as f:
        for i, s in enumerate(seqs):
            toks = [t for t in headers[i].split(" ") if t and not t.startswith("L:")]
            toks.extend(by_src.get(i, ()))
            f.write(">" + " ".join(toks) + "\n" + s + "\n")
    if verbose:
        print(f"re-linked {len(seqs)} unitigs -> {unitigs_path}")


def _load_store(store, cfg, k: int, auto_amin: bool, verbose: int):
    """-skip-bcalm: the stored counts, validated against the requested
    abundance bounds and refiltered at a higher cutoff.  Returns (solid,
    counts, minpos, histogram), or an exit code."""
    if not store.exists():
        print(f"-skip-bcalm: no stored counts at {store.path}", file=sys.stderr)
        return 1
    try:
        solid, counts, minpos = store.read_counts(k)
    except ValueError as e:
        print(f"-skip-bcalm: {e}", file=sys.stderr)
        return 1
    scfg = store.config()
    stored_amin = int(scfg.get("abundance_min", 1))
    stored_amax = int(scfg.get("abundance_max", 2**31 - 1))
    if auto_amin:
        cfg.abundance_min = stored_amin
    if cfg.abundance_min < stored_amin or cfg.abundance_max > stored_amax:
        print(f"-skip-bcalm: stored counts were filtered at abundance "
              f"[{stored_amin}, {stored_amax}]; cannot widen to "
              f"[{cfg.abundance_min}, {cfg.abundance_max}] — recount "
              f"without -skip-bcalm", file=sys.stderr)
        return 1
    if cfg.abundance_min > stored_amin or cfg.abundance_max < stored_amax:
        keep = (counts >= cfg.abundance_min) & (counts <= cfg.abundance_max)
        solid, counts = solid[:, keep], counts[keep]
        if minpos is not None:
            minpos = minpos[keep]
    if verbose:
        print(f"reusing stored counts: {solid.shape[1]} solid k-mers "
              f"({store.path})")
    return solid, counts, minpos, store.read_histogram()


def _count_samples(bank, cfg, props, verbose: int, device, auto_amin: bool):
    """Multi-sample solidity: each bank counted on its own at abundance 1,
    the counts combined by -solidity-kind, the histogram and the cutoff
    taken over the combination.  Returns (solid, counts, histogram,
    stats)."""
    import numpy as np

    from bcalm_tpu.cli import _input_blocks
    from bcalm_tpu.io import bank as bank_mod
    from bcalm_tpu_torch import engine

    cfg1 = dataclasses.replace(cfg, abundance_min=1, abundance_max=2**31 - 1)
    nb_cores = props.get_int("-nb-cores")
    runs, stats = [], {}
    for p in bank.paths:
        sub = bank_mod.Bank([p])

        def blocks(sub=sub):
            return _input_blocks(sub, cfg, verbose, nb_cores=nb_cores)

        s_i, c_i, _, _, st = engine.count_and_filter(blocks(), cfg1, device,
                                                     reread=blocks)
        runs.append((s_i, c_i))
        for key in ("reads", "bases", "kmer_occurrences"):
            stats[key] = stats.get(key, 0) + st.get(key, 0)
    lanes, agg = engine.combine_sample_counts(
        runs, props.get_str("-solidity-kind"), k=cfg.k)
    histo = np.bincount(np.minimum(agg, cfg.histo_max),
                        minlength=cfg.histo_max + 1).astype(np.int32)
    if auto_amin:
        cfg.abundance_min = engine.auto_abundance_min(
            histo, props.get_int("-abundance-min-threshold"))
    keep = (agg >= cfg.abundance_min) & (agg <= cfg.abundance_max)
    stats["distinct_kmers"] = int(lanes.shape[1])
    stats["solid_kmers"] = int(keep.sum())
    return lanes[:, keep], agg[keep], histo, stats


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "-version" in argv or "--version" in argv:
        print(version_string())
        return 0
    for flag in ("-server", "-connect"):
        if flag in argv:
            return _not_ported(flag, "A12")
    parser = build_parser()
    try:
        props = parser.parse(argv)
    except OptionFailure as e:
        print(str(e), file=sys.stderr)
        return 1
    if props.get_bool("-help") or props.get_bool("-h"):
        print(parser.usage())
        return 0
    if props.get_int("-devices") > 1:
        return _not_ported("-devices > 1", "A14")

    k = props.get_int("-kmer-size")
    verbose = props.get_int("-verbose")
    in_path = props.get_str("-in")
    prefix = props.get_str("-out") or default_prefix(in_path)
    unitigs_path = prefix + ".unitigs.fa"

    if props.get_bool("-redo-links"):
        if not os.path.exists(unitigs_path):
            print(f"-redo-links: {unitigs_path} not found", file=sys.stderr)
            return 1
        redo_links(unitigs_path, k, verbose)
        return 0

    device = torch.device(os.environ.get(DEVICE_ENV, "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"CUDA device requested ({DEVICE_ENV} unset or 'cuda') but "
              f"torch.cuda.is_available() is false; set {DEVICE_ENV}=cpu "
              f"to run on the CPU", file=sys.stderr)
        return 1

    from bcalm_tpu.cli import _input_blocks
    from bcalm_tpu.io import bank as bank_mod
    from bcalm_tpu.storage.store import Store
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.io import fasta_writer
    from bcalm_tpu_torch.models import lanes as ln

    amin_raw = props.get_str("-abundance-min")
    auto_amin = amin_raw == "auto"
    cfg = engine.EngineConfig(
        k=k,
        abundance_min=1 if auto_amin else int(amin_raw),
        abundance_max=props.get_int("-abundance-max"),
        histo_max=props.get_int("-histo-max"),
        max_disk_mb=props.get_int("-max-disk"),
    )
    engine.configure_chunk(cfg, props.get_int("-max-memory"), device)
    solidity_kind = props.get_str("-solidity-kind")
    store = Store(prefix)
    cfg.spill_dir = store.path
    skip_bcalm = props.get_bool("-skip-bcalm")
    skip_bglue = props.get_bool("-skip-bglue")
    only_uf = props.get_bool("-only-uf")
    uf_stats = props.get_bool("-uf-stats")
    if skip_bglue and not skip_bcalm:
        print("-skip-bglue requires -skip-bcalm (resume workflow: run "
              "with -only-uf, then -skip-bcalm -skip-bglue)", file=sys.stderr)
        return 1

    ti = TimeInfo()
    solid = counts = minpos = histo = None
    built_us = None
    stats = {}
    if skip_bcalm:
        with ti.timer("load_counts"):
            loaded = _load_store(store, cfg, k, auto_amin, verbose)
        if isinstance(loaded, int):
            return loaded
        solid, counts, minpos, histo = loaded
    else:
        if not os.path.exists(in_path):
            print(f"input not found: {in_path}", file=sys.stderr)
            return 1
        for flag, default in (("-minimizer-size", "10"),
                              ("-minimizer-type", "1"),
                              ("-repartition-type", "1")):
            if props.get_str(flag) != default:
                print(f"note: {flag} is ignored by the single-device port",
                      file=sys.stderr)
        bank = bank_mod.Bank.open(in_path)
        adapt_max_len(bank, cfg)
        nb_cores = props.get_int("-nb-cores")

        def blocks():
            return _input_blocks(bank, cfg, verbose, nb_cores=nb_cores)

        with ti.timer("build"):
            if solidity_kind != "sum" and len(bank.paths) > 1:
                solid, counts, histo, stats = _count_samples(
                    bank, cfg, props, verbose, device, auto_amin)
            else:
                # reread re-opens the bank for each further pass of a
                # multi-pass count, with the same block geometry
                built_us = engine.build_from_blocks(
                    blocks(), cfg, device, reread=blocks, store=store,
                    auto_amin_cap=(props.get_int("-abundance-min-threshold")
                                   if auto_amin else None),
                    only_uf=only_uf, uf_stats=uf_stats,
                    solidity_kind=solidity_kind)
        if auto_amin and verbose:
            print(f"auto abundance-min = {cfg.abundance_min}")
        if solid is not None:
            with ti.timer("store"):
                store.write_counts(
                    solid, counts, k, histogram=histo, minpos=minpos,
                    config={"abundance_min": cfg.abundance_min,
                            "abundance_max": cfg.abundance_max,
                            "solidity_kind": solidity_kind})

    solid_out = props.get_str("-solid-kmers-out")
    if solid_out:
        if solid is None:   # resident build: read the checkpoint
            solid, counts, _ = store.read_counts(k)
        with open(solid_out, "w") as f:
            for i in range(solid.shape[1]):
                f.write(f"{ln.int_to_string(ln.lanes_to_int(solid[:, i]), k)}"
                        f"\t{int(counts[i])}\n")

    if built_us is not None:
        us = built_us
    else:
        chain_info = None
        if skip_bglue:
            if not (skip_bcalm and store.has_chains()):
                print("-skip-bglue: no chain checkpoint in store (run with "
                      "-only-uf first, resume with -skip-bcalm -skip-bglue)",
                      file=sys.stderr)
                return 1
            try:
                chain_info = store.read_chains(k, int(solid.shape[1]))
            except ValueError as e:
                print(f"-skip-bglue: {e}", file=sys.stderr)
                return 1
            if verbose:
                print("reusing stored chain decomposition (skip-bglue)")
        with ti.timer("compact"):
            try:
                us = engine.compact_from_counts(
                    solid, counts, cfg, device, only_uf=only_uf,
                    uf_stats=uf_stats, chain_info=chain_info,
                    minpos_np=minpos)
            except ValueError as e:
                print(f"-skip-bglue: {e}", file=sys.stderr)
                return 1
        us.stats.update(stats)
        us.histogram = histo
    if only_uf and us.chain_info is not None:
        store.write_chains(us.chain_info, k, int(us.stats.get("solid_kmers", 0)))

    if not only_uf:
        with ti.timer("write"):
            with open(unitigs_path, "w") as f:
                fasta_writer.write_fasta(
                    us, f,
                    all_abundance_counts=props.get_bool("-all-abundance-counts"))
        # a finished run removes its checkpoint; -only-uf keeps it for the
        # resume stages
        with ti.timer("remove_store"):
            store.remove()

    if verbose:
        if only_uf:
            print(f"-only-uf: stopped after chain labeling "
                  f"({us.stats.get('uf_classes', 0)} classes)")
        else:
            print(f"wrote {len(us.seqs)} unitigs -> {unitigs_path} ({device})")
        for key, val in sorted(us.stats.items()):
            print(f"    [{key}] {val}")
        for name, secs in ti.report().items():
            print(f"    [time:{name}] {secs:.2f}s")
        print(f"    [peak_rss_mb] {peak_rss_mb():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
