"""Compaction: the host time of the harness's span around
engine.compact_solid_pos, synchronised at both edges, in ms, over the
traced build."""

SPANS = [{"target": "bcalm_tpu_torch.engine:compact_solid_pos",
          "name": "cdbg.compact", "sync": True}]


def read(rec):
    spans = rec["host_spans"].get("cdbg.compact")
    return 1e3 * sum(spans) if spans else None
