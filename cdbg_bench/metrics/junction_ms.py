"""Junction matching: the host time of the harness's span around
ops.junctions.successor_arrays (K3a, the sort of the key words, K3b),
synchronised at both edges, in ms, over the traced build.  The span sits
inside compact_ms's span around engine.compact_solid_pos, and its syncs
would add to that reading: list it only in cells that do not report
compact_ms."""

SPANS = [{"target": "bcalm_tpu_torch.ops.junctions:successor_arrays",
          "name": "cdbg.junction_step", "sync": True,
          "work": "junction_step"}]


def read(rec):
    spans = rec["host_spans"].get("cdbg.junction_step")
    return 1e3 * sum(spans) if spans else None
