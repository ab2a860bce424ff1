"""FASTA -> GFA1 conversion (capability port of the reference's
scripts/convertToGFA.py — semantics re-implemented, not copied):

- header line `H  VN:Z:1.0  ks:i:<k>` (convertToGFA.py:74)
- one S record per unitig, one L record per L: header entry with overlap
  `<k-1>M` (convertToGFA.py:105-112)
- --single-directed keeps one edge per mirror pair: name < other, or
  name == other and not a '-/-' self-link (convertToGFA.py:106-110)
- legacy `MA=x` tags re-emitted as `MA:f:x` (convertToGFA.py:101-102)

Copy of ``bcalm_tpu/io/gfa.py`` with the imports pointed at this package:
the port imports nothing of the JAX package.  ``main`` is the converter
CLI of ``scripts/convert_to_gfa.py``, with the same arguments:

    python -m bcalm_tpu_torch.io.gfa in.unitigs.fa out.gfa K [--single-directed]
"""

from __future__ import annotations

import argparse
from typing import IO, Iterable, List, Tuple


def convert_header_fields(name: str, fields: List[str], k: int,
                          single_directed: bool):
    optional = []
    links = []
    k1 = k - 1
    for tok in fields:
        if not tok:
            continue
        if tok.startswith("MA="):
            optional.append("MA:f:" + tok[3:])
        elif tok.startswith("L:"):
            parts = tok.split(":")
            _, sfrom, other, sto = parts[0], parts[1], parts[2], parts[3]
            if single_directed:
                if name < other:
                    pass
                elif name == other and not (sfrom == sto == "-"):
                    pass
                else:
                    continue
            links.append(f"L\t{name}\t{sfrom}\t{other}\t{sto}\t{k1}M")
        else:
            optional.append(tok)
    return optional, links


def fasta_to_gfa(in_path: str, out: IO[str], k: int,
                 single_directed: bool = False) -> None:
    out.write(f"H\tVN:Z:1.0\tks:i:{k}\n")
    name = None
    optional: List[str] = []
    links: List[str] = []
    seq_parts: List[str] = []

    def flush():
        if name is None:
            return
        seq = "".join(seq_parts)
        line = f"S\t{name}\t{seq}"
        if optional:
            line += "\t" + "\t".join(optional)
        out.write(line + "\n")
        for l in links:
            out.write(l + "\n")

    with open(in_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith(">"):
                flush()
                toks = line[1:].split(" ")
                name = toks[0]
                optional, links = convert_header_fields(
                    name, toks[1:], k, single_directed
                )
                seq_parts = []
            else:
                seq_parts.append(line)
        flush()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a bcalm-format unitigs FASTA to GFA1.")
    p.add_argument("inputFilename")
    p.add_argument("outputFilename")
    p.add_argument("kmerSize", type=int)
    p.add_argument("-s", "--single-directed", action="store_true",
                   dest="single_directed",
                   help="emit only one edge per mirror pair")
    args = p.parse_args(argv)
    with open(args.outputFilename, "w") as out:
        fasta_to_gfa(args.inputFilename, out, args.kmerSize,
                     single_directed=args.single_directed)
    print("done")


if __name__ == "__main__":
    main()
