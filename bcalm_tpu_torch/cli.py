"""Command line of the port: the single-device build.

    python -m bcalm_tpu_torch -in reads.fa -kmer-size 31 -abundance-min 2 [-out prefix]

The option surface, the input block stream and the output naming are the
JAX package's (bcalm_tpu.cli.build_parser, _input_blocks, default_prefix),
so both packages read the same blocks and write the same
``<prefix>.unitigs.fa``.  The device is ``cuda`` unless
``BCALM_TORCH_DEVICE`` names another; a requested CUDA device that is
absent is an error, never a silent CPU run.  Options whose paths are not
ported yet exit 1 and name their ROADMAP item.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import torch

from bcalm_tpu.cli import build_parser, default_prefix
from bcalm_tpu.utils.options import OptionFailure
from bcalm_tpu.utils.timeinfo import TimeInfo, peak_rss_mb
from bcalm_tpu.version import version_string

DEVICE_ENV = "BCALM_TORCH_DEVICE"

# boolean options whose paths are not ported yet -> ROADMAP item
_NOT_PORTED_FLAGS = {"-skip-bcalm": "A11", "-skip-bglue": "A11",
                     "-redo-links": "A11", "-only-uf": "A12",
                     "-uf-stats": "A12"}


def _not_ported(what: str, item: str) -> int:
    print(f"{what}: not yet ported (ROADMAP {item})", file=sys.stderr)
    return 1


def adapt_max_len(bank, cfg) -> None:
    """Block geometry from the bank's sampled read length: the same
    max_len rule as bcalm_tpu.cli._adapt_max_len, so both packages cut the
    input into identical blocks (first-occurrence keys depend on it)."""
    sampled = bank.sample_max_len()
    if sampled >= cfg.k:
        cfg.max_len = max(cfg.k + 1, min(512, -(-sampled // 16) * 16))


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
    for flag, item in _NOT_PORTED_FLAGS.items():
        if props.get_bool(flag):
            return _not_ported(flag, item)
    if props.get_int("-devices") > 1:
        return _not_ported("-devices > 1", "A14")
    if props.get_str("-abundance-min") == "auto":
        return _not_ported("-abundance-min auto", "A12")
    if props.get_str("-solid-kmers-out"):
        return _not_ported("-solid-kmers-out", "A12")

    device = torch.device(os.environ.get(DEVICE_ENV, "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"CUDA device requested ({DEVICE_ENV} unset or 'cuda') but "
              f"torch.cuda.is_available() is false; set {DEVICE_ENV}=cpu "
              f"to run on the CPU", file=sys.stderr)
        return 1

    from bcalm_tpu.cli import _input_blocks
    from bcalm_tpu.io import bank as bank_mod
    from bcalm_tpu_torch import engine
    from bcalm_tpu_torch.io import fasta_writer

    k = props.get_int("-kmer-size")
    verbose = props.get_int("-verbose")
    in_path = props.get_str("-in")
    unitigs_path = (props.get_str("-out") or default_prefix(in_path)) \
        + ".unitigs.fa"
    if not os.path.exists(in_path):
        print(f"input not found: {in_path}", file=sys.stderr)
        return 1
    bank = bank_mod.Bank.open(in_path)
    if props.get_str("-solidity-kind") != "sum" and len(bank.paths) > 1:
        return _not_ported("multi-bank -solidity-kind min|max", "A12")
    for flag, default in (("-minimizer-size", "10"), ("-minimizer-type", "1"),
                          ("-repartition-type", "1"), ("-max-memory", "0"),
                          ("-max-disk", "0")):
        if props.get_str(flag) != default:
            print(f"note: {flag} is ignored by the single-device port",
                  file=sys.stderr)

    cfg = engine.EngineConfig(
        k=k,
        abundance_min=int(props.get_str("-abundance-min")),
        abundance_max=props.get_int("-abundance-max"),
        histo_max=props.get_int("-histo-max"),
    )
    adapt_max_len(bank, cfg)
    ti = TimeInfo()
    with ti.timer("build"):
        us = engine.build_from_blocks(
            _input_blocks(bank, cfg, verbose,
                          nb_cores=props.get_int("-nb-cores")),
            cfg, device)
    with ti.timer("write"):
        with open(unitigs_path, "w") as f:
            fasta_writer.write_fasta(
                us, f,
                all_abundance_counts=props.get_bool("-all-abundance-counts"))
    if verbose:
        print(f"wrote {len(us.seqs)} unitigs -> {unitigs_path} ({device})")
        for key, val in sorted(us.stats.items()):
            print(f"    [{key}] {val}")
        for name, secs in ti.report().items():
            print(f"    [time:{name}] {secs:.2f}s")
        print(f"    [peak_rss_mb] {peak_rss_mb():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
