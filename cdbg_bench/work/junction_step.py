"""The work of one junction step (ops.junctions.successor_arrays, whatever
implements it), in bytes, over E = 2C entries (each of the C columns of
the solid table has a suffix and a prefix entry) whose key is the exact
(k-1)-mer in W = ceil(L2 / 2) 64-bit words (L2 = its 32-bit lanes):

- each solid k-mer's lanes, rounded up to 64-bit words, read once;
- each entry's W key words and its payload written once;
- per sort pass (one a key word) one read and one write of that word
  and of the permutation, for every entry;
- the pair rule's read of each entry's W key words and payload;
- the successor array's E int64 entries written once."""


def key_words(k: int) -> int:
    """W: the 64-bit words of a (k-1)-mer of 16 bases a 32-bit lane."""
    return (-(-(k - 1) // 16) + 1) // 2


def bytes_moved(lanes: int, columns: int, n_solid: int, words: int) -> int:
    E = 2 * columns
    return (n_solid * 8 * ((lanes + 1) // 2)
            + E * 8 * (words + 1)
            + words * E * 32
            + E * 8 * (words + 1)
            + E * 8)


def of_call(args, kwargs, out) -> int:
    """bytes_moved of one call of successor_arrays(solid, n_solid, k),
    solid the (lanes, C) table."""
    call = dict(zip(("solid", "n_solid", "k"), args), **kwargs)
    lanes, columns = call["solid"].shape
    return bytes_moved(lanes, columns, int(call["n_solid"]),
                       key_words(int(call["k"])))
