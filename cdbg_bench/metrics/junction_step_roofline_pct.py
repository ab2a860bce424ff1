"""The junction step's share of its roofline: the bytes the step has to
move (work/junction_step.py, summed over its calls) at the card's memory
bandwidth (peaks.json), over the device time of the operations that ran
inside the harness's synchronised span around
ops.junctions.successor_arrays (profiler trace; the span of junction_ms,
listed in the same cells)."""

SPANS = [{"target": "bcalm_tpu_torch.ops.junctions:successor_arrays",
          "name": "cdbg.junction_step", "sync": True,
          "work": "junction_step"}]


def read(rec):
    tr = rec["trace"]
    work = rec["work"].get("junction_step")
    peak = rec["peaks"].get(rec["device_kind"])
    if not tr or not work or not peak:
        return None
    dev_s = tr["span_device_s"].get("cdbg.junction_step", 0.0)
    if dev_s <= 0:
        return None
    return 100.0 * sum(work) / peak["hbm_bytes_per_s"] / dev_s
