"""Spelling: the program's assemble.spell span (K11, its copies to the
host, the unitig strings, KC and the abundances), mean over the window's
builds."""


def read(rec):
    vals = [b["stats"]["time:assemble.spell"] for b in rec["builds"]
            if "time:assemble.spell" in b["stats"]]
    return sum(vals) / len(vals) if vals else None
