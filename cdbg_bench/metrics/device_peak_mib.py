"""The largest torch.cuda.max_memory_allocated() of any build of the
window, in MiB: the harness resets the peak before each build and reads it
after it, so the reference, which runs later, never counts."""


def read(rec):
    peaks = [b["peak_bytes"] for b in rec["builds"] if b["peak_bytes"]]
    return max(peaks) / 2**20 if peaks else None
