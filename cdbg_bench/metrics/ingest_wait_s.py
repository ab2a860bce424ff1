"""Ingest: the program's count.ingest_wait span, the time counting waited
for each next block of reads from the host (the parser, its prefetch, the
CLI's progress), mean over the window's builds."""


def read(rec):
    vals = [b["stats"]["time:count.ingest_wait"] for b in rec["builds"]
            if "time:count.ingest_wait" in b["stats"]]
    return sum(vals) / len(vals) if vals else None
