"""Assembly and links: the program's t_assemble_s, mean over the
window's builds."""


def read(rec):
    vals = [b["stats"]["t_assemble_s"] for b in rec["builds"]
            if "t_assemble_s" in b["stats"]]
    return sum(vals) / len(vals) if vals else None
