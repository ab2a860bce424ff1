"""The count step's share of its roofline: the bytes the step has to move
(work/count_step.py, summed over its calls) at the card's memory
bandwidth (peaks.json), over the device time of the operations that ran
inside the harness's synchronised spans around ops.count.count_canonical
(profiler trace)."""

SPANS = [{"target": "bcalm_tpu_torch.ops.count:count_canonical",
          "name": "cdbg.count_step", "sync": True, "work": "count_step"}]


def read(rec):
    tr = rec["trace"]
    work = rec["work"].get("count_step")
    peak = rec["peaks"].get(rec["device_kind"])
    if not tr or not work or not peak:
        return None
    dev_s = tr["span_device_s"].get("cdbg.count_step", 0.0)
    if dev_s <= 0:
        return None
    return 100.0 * sum(work) / peak["hbm_bytes_per_s"] / dev_s
