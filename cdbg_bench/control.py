#!/usr/bin/env python3
"""The control of ``correct``: the reference itself put in the program's
place, with the one guarantee that a later change would be tempted to
drop broken: its k-mer counts come from a one-row count sketch of 2**32
counters keyed by a hash of the k-mer (the step below exact counting),
so k-mers that share a counter share their count.  Its FASTA is judged
by the comparison that a run makes, against the exact reference, and has
to come out not correct.  Run on the card at a cell's own size:

    python3 cdbg_bench/control.py --workload ecoli_k31.resident \
        --seeds 101 102 103

One JSON line per seed: the compared numbers, their parts, and whether
the control came out correct.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import gen  # noqa: E402
import reference  # noqa: E402
import run  # noqa: E402

SKETCH_BITS = 32


def control(spec: dict, seed: int, device, bits: int = SKETCH_BITS):
    """(compared numbers, their parts) of the control's FASTA for seed."""
    cfg = spec["config"]
    tmp = tempfile.mkdtemp(prefix="cdbg_control-")
    try:
        reads = os.path.join(tmp, "reads.fa")
        gen.write_reads(reads, cfg["reads"], seed)
        sketched = reference.reference(reads, cfg["k"], cfg["abundance_min"],
                                       device, sketch_bits=bits)
        out = os.path.join(tmp, "control.unitigs.fa")
        reference.emit_fasta(sketched, out)
        del sketched
        exact = reference.reference(reads, cfg["k"], cfg["abundance_min"],
                                    device)
        return reference.judge(exact, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = run.load_spec(args.workload)
    for seed in args.seeds:
        checks, detail = control(spec, seed, args.device)
        correct = all(checks[n] <= run.LIMITS[n] for n in checks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "checks": checks, "detail": detail,
                          "correct": correct}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
