"""Counting: the program's t_count_s (host clock after a device
synchronise), mean over the window's builds."""


def read(rec):
    vals = [b["stats"]["t_count_s"] for b in rec["builds"]
            if "t_count_s" in b["stats"]]
    return sum(vals) / len(vals) if vals else None
