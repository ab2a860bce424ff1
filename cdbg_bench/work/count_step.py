"""The work of one count step (ops.count.count_canonical, whatever
implements it): each occurrence's key, rounded up to 64-bit words, its
weight and its position where the call has them, read once; each distinct
key, its count and its least position, written once.  Bytes."""


def bytes_moved(lanes: int, columns: int, weighted: bool, has_pos: bool,
                distinct: int) -> int:
    key = 8 * ((lanes + 1) // 2)   # 32-bit lanes, two to a 64-bit word
    return (columns * (key + 8 * weighted + 8 * has_pos)
            + distinct * (key + 8 + 8 * has_pos))


def of_call(args, kwargs, out) -> int:
    """bytes_moved of one call of count_canonical(lanes, weights=None,
    pos=None), whose fourth output is the number of distinct keys."""
    call = dict(zip(("lanes", "weights", "pos"), args), **kwargs)
    lanes, columns = call["lanes"].shape
    return bytes_moved(lanes, columns, call.get("weights") is not None,
                       call.get("pos") is not None, int(out[3]))
