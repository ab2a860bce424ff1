"""The CLI's output: the program's time:write (the FASTA) plus t_store_s
(the checkpoint of the solid set), mean over the window's builds."""


def read(rec):
    vals = [b["stats"]["time:write"] + b["stats"].get("t_store_s", 0.0)
            for b in rec["builds"] if "time:write" in b["stats"]]
    return sum(vals) / len(vals) if vals else None
