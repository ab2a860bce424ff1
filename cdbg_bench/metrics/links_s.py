"""Links: the program's assemble.links span (engine.link_join on the
host), mean over the window's builds."""


def read(rec):
    vals = [b["stats"]["time:assemble.links"] for b in rec["builds"]
            if "time:assemble.links" in b["stats"]]
    return sum(vals) / len(vals) if vals else None
