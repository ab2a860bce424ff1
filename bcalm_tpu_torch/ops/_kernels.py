"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a, one nvcc process per source
started together, and linked into one shared library with a plain C
interface, loaded with ctypes.  The build happens at first use, into
``bcalm_tpu_torch/build/<hash of the sources>/``; a missing nvcc or a
failed build raises with the compiler's output.  Nothing here is imported
or built when the module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch, launches on the current stream, raises when the C
function returns a CUDA error, and adds one to its entry in ``LAUNCHES``
each time it launches its kernel(s).  The plain PyTorch versions live beside the
callers in ops/{extract,count,junctions,chains,runchains,superkmer}.py,
parallel/{pipeline,distcompact}.py, models/minimizer.py and engine.py; these wrappers never fall back to them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..models.lanes import end_words
from ..models.spans import MAX_K

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# kernel name (K21: each of its modes; K15: its hash mode apart; K2: its
# weighted calls, the LSM merges, apart) -> launches since the last
# reset_launches()
LAUNCHES = {"extract_insert": 0, "extract_insert_ranged": 0,
            "count_sorted": 0, "count_sorted_weighted": 0, "junction_keys": 0,
            "junction_pairs": 0, "jump_round": 0, "range_fold": 0,
            "lower_bound": 0, "solid_fold_histogram": 0, "run_scans": 0,
            "solid_compact": 0, "chain_finish": 0, "spell_unitigs": 0,
            "run_contract": 0, "run_broadcast": 0, "form_superkmers": 0,
            "mmer_histograms": 0, "route_buckets": 0,
            "route_buckets_hash": 0, "glue_compose": 0,
            "glue_answer_rows": 0, "glue_answer_run": 0,
            "glue_answer_uid": 0, "junction_words": 0, "junction_scatter": 0,
            "fixpoint_bits": 0, "hier_round": 0, "hier_contract": 0,
            "hier_expand": 0,
            "kmer_minimizers": 0, "link_ends": 0, "link_pairs": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    "bt_extract_insert": [_P, _I64, _P, _P, _I32, _I32, _I32, _I32, _I32,
                          ctypes.c_uint, _P, _I64, _P, _P, _P],
    "bt_count_sorted": [_P, _P, _P, _I64, _I32, _I64, _P, _P, _P, _I64,
                        ctypes.c_ulonglong, ctypes.c_ulonglong, _P, _I64, _P,
                        _P, _P, _P],
    "bt_junction_keys": [_P, _I64, _I64, _I64, _I32, _I32, _I32, _P, _I64, _P,
                         _P],
    "bt_junction_pairs": [_P, _P, _I64, _I32, _P, _P, _I64, _I64, _I64, _I32,
                          _I32, _P, _P, _P],
    "bt_jump_round": [_P, _P, _I64, _P, _P, _P],
    "bt_range_fold": [_P, _I64, _I64, _I32, _P, _P, _P, _P, _P],
    "bt_lower_bound": [_P, _I64, _I64, _I32, _P, _I64, _I32, _P, _P],
    "bt_solid_fold": [_P, _I64, _P, _P, _I64, _I64, _I32, _I64, _I64, _I32,
                      _P, _I64, _P, _P, _P, _P, _P],
    "bt_run_scans": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P],
    "bt_solid_compact": [_P, _I64, _P, _P, _I64, _I64, _I32, _I64, _I64, _P,
                         _P, _I64, _I64, _P, _P],
    "bt_chain_finish": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P,
                        _P],
    "bt_spell_unitigs": [_P, _I64, _I32, _I64, _P, _P, _P, _P, _P, _I64, _I32,
                         _P, _P, _P, _I64, _P, _I64, _P],
    "bt_run_contract": [_P, _I64, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P,
                        _P],
    "bt_run_broadcast": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P,
                         _P, _P, _P],
    "bt_junction_entries": [_P, _I64, _I64, _I64, _I32, _I32, _I64, _I64, _I32,
                            _P, _I64, _P, _P, _P, _P],
    "bt_junction_words": [_P, _I64, _I32, _P, _I64, _P, _P, _I64, _P, _P],
    "bt_junction_edges": [_P, _P, _P, _I64, _I32, _P, _I64, _I64, _I64, _I32,
                          _I64, _P, _P, _P, _P],
    "bt_junction_scatter": [_P, _P, _I64, _I64, _I64, _I64, _P, _P, _P],
    "bt_form_superkmers": [_P, _P, _I32, _I32, _I32, _I32, _P, _P, _I32, _I32,
                           _I32, _I32, ctypes.c_uint, _P, _P, _P, _P, _P],
    "bt_mmer_histograms": [_P, _P, _I32, _I32, _I32, _I32, _P, _I32, _P, _P],
    "bt_route_buckets": [_P, _I64, _I32, _P, _P, _I64, _I32, _I64, _I64, _I32,
                         _P, _P, _P, _P],
    "bt_glue_compose": [_P, _P, _I64, _P, _P, _I64, _P, _P, _I64, _I64, _P],
    "bt_glue_answer": [_I32, _P, _P, _I64, _P, _P, _P, _I64, _I64, _I64, _I64,
                       _I64, _P, _P],
    "bt_fixpoint_bits": [_P, _P, _I64, ctypes.c_uint, _P, _P],
    "bt_hier_round": [_P, _P, _P, _P, _I64, _P, _P],
    "bt_hier_contract": [_P, _P, _P, _I64, ctypes.c_uint, _I64, _I64, _P, _P,
                         _P, _P, _P, _P, _P, _P, _P],
    "bt_hier_expand": [_P, _P, _P, _P, _I64, _I64, _P],
    "bt_kmer_minimizers": [_P, _I64, _I32, _I64, _I32, _I32, _P, _P, _I32, _P,
                           _P],
    "bt_link_ends": [_P, _P, _I64, _I32, _I32, _P, _P],
    "bt_link_pairs": [_P, _P, _P, _I32, _I64, _P, _I64, _P, _P],
}
ROUTE_TILE = 2048  # entries per look-back tile of csrc/route.cu
ROUTE_POOL_TILES = 1024  # csrc/route.cu kPoolTiles: a pool block a tile below
MAX_ROW_WORDS = 64  # csrc/superkmer.cu: rows of <= 1024 positions
SPELL_TILE = 1024  # unitigs per look-back tile of csrc/spell.cu (K11)
COMPACT_TILE = 4096  # columns per tile of csrc/compact.cu
HIER_TILE = 2048  # rows per selection tile of csrc/hier.cu (K18)
FINISH_TILE = 1024  # nodes per selection tile of csrc/finish.cu (K10)
RUNSCAN_TILE = 2048  # entries per look-back tile of csrc/runscan.cu (K8)
COUNT_TILE = 2048  # columns per tile of csrc/count.cu
COUNT_EPOCHS = 1 << 30  # csrc/count.cu: a status word's epoch has 30 bits
WORDS_TILE = 4096  # received slots per look-back tile of junction_words
SCATTER_WINDOW = 16384  # csrc/junctions.cu kWin: table slots per window
MAX_LANES = MAX_K // 16  # csrc/common.cuh kMaxLanes: every k the port takes

_lib = None
_FNS = {}  # C function name -> its bound ctypes function (load())
_SCRATCH = {}  # device index -> K5's (sum, ticket) pair (_fold_scratch)
# device index -> K2's [workspace, capacity in tiles, tiles taken,
# launches] (_count_work)
_COUNT_WORK = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        f"cannot build the bcalm_tpu_torch CUDA kernels: nvcc not found on "
        f"PATH or at {candidate}")


def _run_all(cmds):
    """Run the commands as parallel processes; raise with the first
    failure's compiler output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed building the bcalm_tpu_torch "
                           "kernels:\n" + "\n".join(failed))


def build(build_dir: Path | None = None) -> Path:
    """Compile each csrc/*.cu into an object (one nvcc per source, all
    started together), link them into <build_dir>/<source hash>/
    libbtkernels.so (reused when it exists) and return its path."""
    out_dir = Path(build_dir or BUILD_DIR) / source_hash()
    lib_path = out_dir / "libbtkernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        objs = [work / (p.stem + ".o") for p in _sources() if p.suffix == ".cu"]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(SRC_DIR / (o.stem + ".cu"))]
                  for o in objs])
        tmp = work / "libbtkernels.so"
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *[str(o) for o in objs]]])
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; its C functions are bound
    into _FNS once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype=torch.int64, ndim=None,
           rows_strided: bool = False):
    """rows_strided: a (rows, cols) view whose rows are contiguous but may
    lie apart (a column slice of a wider buffer) is accepted."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if rows_strided and t.dim() == 2 and t.stride(1) == 1:
        return
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _aligned16(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte alignment (the kernel "
                         f"moves rows as 16-byte vectors)")


def _launch(fn_name: str, *args) -> None:
    """Call the C function with the current device's current stream.  The
    raw handle is read directly: building a torch.cuda.Stream object for
    it (torch.cuda.current_stream()) costs more host time than a small
    kernel such as K6 takes on the device."""
    if _lib is None:
        load()
    err = _FNS[fn_name](*args, torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice()))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def _lanes_ok(L: int, what: str):
    if not 1 <= L <= MAX_LANES:
        raise ValueError(f"{what}: {L} lanes; the kernels take k <= "
                         f"{16 * MAX_LANES}")


def extract_insert(buf: torch.Tensor, words: torch.Tensor,
                   lengths: torch.Tensor, k: int, slot_base: int,
                   offset: int, row_base=None, *, lo=None, hi=None) -> None:
    """K1: write the folded (L+1, B*P_eff) extraction of a packed block into
    buf[:, offset:offset + B*P_eff] (in place).  row_base: (B,) per-row
    slot bases (slot = (row_base[b] + p) & 0x3FFFFFFF) instead of
    slot_base + b*P_eff + p.  lo, hi (range mode, L u32 lanes each): a
    column whose canonical key lies outside [lo, hi) is written as the
    sentinel; these launches count as extract_insert_ranged."""
    _check(buf, "buf", ndim=2)
    _check(words, "words", ndim=2)
    _check(lengths, "lengths", ndim=1)
    if row_base is not None:
        _check(row_base, "row_base", ndim=1)
        if row_base.shape[0] != words.shape[0]:
            raise ValueError("extract_insert: one row base per read")
    L = buf.shape[0] - 1
    _lanes_ok(L, "extract_insert")
    if (lo is None) != (hi is None):
        raise ValueError("extract_insert: range mode takes both lo and hi")
    B, W = words.shape
    P_eff = max(1, 16 * W - (k - 1))
    if lengths.shape[0] != B or offset + B * P_eff > buf.shape[1]:
        raise ValueError("extract_insert: block does not fit the buffer")
    if B * P_eff >= 2**31:
        raise ValueError("extract_insert: a block takes fewer than 2^31 slots")
    if B * P_eff == 0:
        return
    ranged = lo is not None
    _launch("bt_extract_insert", buf.data_ptr(),
            buf.stride(0), words.data_ptr(), lengths.data_ptr(), B, W, P_eff,
            k, L, slot_base, None if row_base is None else row_base.data_ptr(),
            offset, _key_arg(lo, L, "lo") if ranged else None,
            _key_arg(hi, L, "hi") if ranged else None)
    LAUNCHES["extract_insert_ranged" if ranged else "extract_insert"] += 1


def _count_work(device: torch.device, tiles: int):
    """K2's workspace on this card and the arguments of the next launch
    on it: (workspace, its capacity in tiles, the tiles taken before this
    launch, this launch's epoch).  The workspace is zeroed once when made
    (again when a launch needs more tiles than it holds, or the epochs
    run out) and never cleared between launches: each launch's status
    words carry its epoch."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device())
    st = _COUNT_WORK.get(key)
    if st is None or st[1] < tiles or st[3] + 1 >= COUNT_EPOCHS:
        cap = max(tiles, 2 * st[1] if st is not None else 1024)
        st = _COUNT_WORK[key] = [
            torch.zeros((1 + 3 * cap,), dtype=torch.int64,
                        device=torch.device("cuda", key)), cap, 0, 0]
    st[3] += 1
    base = st[2]
    st[2] += tiles
    return st[0], st[1], base, st[3]


def count_sorted(top: torch.Tensor, perm: torch.Tensor, lower, L: int,
                 weights, pos):
    """K2 on the sort's own output: top, the (N,) top packed key word in
    sorted order (sort.lex_sort_words over models.lanes.pack_rows); perm,
    the sort's permutation; lower, the (ceil(L/2) - 1, N) lower packed
    words in entry order (None at 1 or 2 lanes); weights and pos (N,) in
    entry order, or None.  Returns (unique (L, N), counts, minpos|None,
    n_unique 0-d tensor).  One launch, no fill: the workspace's status
    words carry the launch's epoch (_count_work)."""
    _check(top, "top", ndim=1)
    _check(perm, "perm", ndim=1)
    N = top.shape[0]
    _lanes_ok(L, "count_sorted")
    W = (L + 1) // 2
    if perm.shape[0] != N:
        raise ValueError("count_sorted: top and perm differ in length")
    if (lower is None) != (W == 1):
        raise ValueError(f"count_sorted: {L} lanes take {W - 1} lower words")
    if lower is not None:
        _check(lower, "lower", ndim=2, rows_strided=True)
        if lower.shape != (W - 1, N):
            raise ValueError(f"count_sorted: lower is {tuple(lower.shape)}, "
                             f"expected {(W - 1, N)}")
    for t, name in ((weights, "weights"), (pos, "pos")):
        if t is not None:
            _check(t, name, ndim=1)
            if t.shape[0] != N:
                raise ValueError(f"count_sorted: {name} has {t.shape[0]} "
                                 f"columns, the keys {N}")
    if N >= 2**32:
        raise ValueError("count_sorted: N >= 2^32 (a status word holds 32 "
                         "bits of heads)")
    dev = top.device
    if N == 0:
        empty = top.new_zeros((0,))
        return (top.new_zeros((L, 0)), empty,
                None if pos is None else empty.clone(), top.new_zeros(()))
    # the kernel writes every column: the runs, then the tail
    unique = torch.empty((L, N), dtype=torch.int64, device=dev)
    counts = torch.empty((N,), dtype=torch.int64, device=dev)
    minpos = (torch.empty((N,), dtype=torch.int64, device=dev)
              if pos is not None else None)
    n_unique = torch.empty((1,), dtype=torch.int64, device=dev)
    work, cap, base, epoch = _count_work(dev, -(-N // COUNT_TILE))
    _launch("bt_count_sorted", top.data_ptr(), perm.data_ptr(),
            None if lower is None else lower.data_ptr(),
            0 if lower is None else lower.stride(0), L, N,
            None if weights is None else weights.data_ptr(),
            None if pos is None else pos.data_ptr(), work.data_ptr(), cap,
            base, epoch, unique.data_ptr(), unique.stride(0),
            counts.data_ptr(), None if minpos is None else minpos.data_ptr(),
            n_unique.data_ptr())
    LAUNCHES["count_sorted" if weights is None else "count_sorted_weighted"] += 1
    return unique, counts, minpos, n_unique[0]


def junction_keys(solid: torch.Tensor, n_solid: int, k: int, packed: bool,
                  key_rows: int):
    """K3a: (key_rows, 2C) sentinel-folded keys (the exact lanes as rows,
    or with packed their packed words, models.lanes.pack_keys) and the
    (2C,) payload."""
    _check(solid, "solid", ndim=2)
    L, C = solid.shape
    _lanes_ok(L, "junction_keys")
    keys = torch.empty((key_rows, 2 * C), dtype=torch.int64,
                       device=solid.device)
    payload = torch.empty((2 * C,), dtype=torch.int64, device=solid.device)
    if C:
        _launch("bt_junction_keys", solid.data_ptr(), solid.stride(0), C,
                n_solid, L, k, int(packed), keys.data_ptr(), keys.stride(0),
                payload.data_ptr())
        LAUNCHES["junction_keys"] += 1
    return keys, payload


def junction_pairs(s_word: torch.Tensor, perm: torch.Tensor,
                   payload: torch.Tensor, C: int, K: int,
                   lower=None) -> torch.Tensor:
    """K3b on the sort's output: the (2C,) successor array (-1 = none).
    s_word: the top packed key word in sorted order; perm: the sort's
    permutation; payload and lower (the key's other packed words, (W-1,
    2C), or None): in entry order; K: the key's lanes.  One C call: the
    memset of the windows' counts, the pair rule binning each edge and its
    mirror by 16384-slot window of succ, and a block a window writing it
    whole (no memset of succ)."""
    from .junctions import exact_sentinel, sentinel_words

    for t, name in ((s_word, "s_word"), (perm, "perm"), (payload, "payload")):
        _check(t, name, ndim=1)
    E = s_word.shape[0]
    if perm.shape[0] != E or payload.shape[0] != E:
        raise ValueError("junction_pairs: s_word, perm and payload differ in "
                         "length")
    nl = 0
    if lower is not None:
        _check(lower, "lower", ndim=2, rows_strided=True)
        nl = lower.shape[0]
        if lower.shape[1] != E:
            raise ValueError("junction_pairs: lower differs in length")
    if not 1 <= K <= MAX_LANES or 1 + nl != (K + 1) // 2:
        raise ValueError(f"junction_pairs: {K} key lanes, {1 + nl} words")
    if not 0 <= 2 * C < 2**31:
        raise ValueError(f"junction_pairs: 2C = {2 * C} slots")
    succ = torch.empty((2 * C,), dtype=torch.int64, device=s_word.device)
    # each window's bottom count, then each window's top count
    counts = torch.empty((2 * -(-2 * C // SCATTER_WINDOW),), dtype=torch.int32,
                         device=s_word.device)
    sent0, shift = sentinel_words(K)
    if C:
        _launch("bt_junction_pairs", s_word.data_ptr(),
                None if lower is None else lower.data_ptr(),
                0 if lower is None else lower.stride(0), nl, perm.data_ptr(),
                payload.data_ptr(), E, C, sent0 >> shift, shift,
                int(exact_sentinel(K)), counts.data_ptr(), succ.data_ptr())
        LAUNCHES["junction_pairs"] += 1
    return succ


def _round_flags(changed, at):
    """The (changed, prev) pointers of a K4 round.  changed None: no flag.
    at None: changed[0] is set when a row moved.  at = r, the flag mode of
    a converging phase: changed holds a word a round; the round sets word
    r and, for r > 0, returns at once when word r - 1 is 0."""
    if changed is None:
        if at is not None:
            raise ValueError("a round's flag mode needs its flag words")
        return None, None
    _check(changed, "changed", dtype=torch.int32, ndim=1)
    if at is None:
        return changed.data_ptr(), None
    if not 0 <= at < changed.shape[0]:
        raise ValueError(f"round {at} of {changed.shape[0]} flag words")
    base = changed.data_ptr()
    return base + 4 * at, (base + 4 * (at - 1) if at else None)


def jump_round(Q: torch.Tensor, Qn: torch.Tensor, changed=None, *,
               at=None) -> None:
    """K4: one doubling round Q -> Qn.  changed ((1,) int32, optional) is
    set to 1 if a row moved; at = r: the flag mode (_round_flags)."""
    M = _check_state(Q, "Q")
    _check_state(Qn, "Qn")
    if Qn.shape[0] != M:
        raise ValueError("jump_round: expected two (M, 4) states")
    flag, prev = _round_flags(changed, at)
    _aligned16(Q, "Q")
    _aligned16(Qn, "Qn")
    if M:
        _launch("bt_jump_round", Q.data_ptr(), Qn.data_ptr(), M, flag, prev)
        LAUNCHES["jump_round"] += 1


def _key_arg(key, L: int, what: str):
    """A key of L u32 lanes as a ctypes array (read by the host code).
    Tuples, the multi-pass count's range bounds, which every block of a
    pass passes again, are converted once."""
    if len(key) != L:
        raise ValueError(f"{what}: expected {L} lanes, got {len(key)}")
    if isinstance(key, tuple):
        return _key_array(key)
    return (ctypes.c_uint32 * L)(*[int(x) for x in key])


@functools.lru_cache(maxsize=64)
def _key_array(key: tuple):
    return (ctypes.c_uint32 * len(key))(*[int(x) for x in key])


def _fold_scratch(device: torch.device) -> torch.Tensor:
    """K5's (sum, ticket) pair on this card: zeroed once, and left zeroed
    by every launch (its last block resets it), so launches on one stream
    share it."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device())
    t = _SCRATCH.get(key)
    if t is None:
        t = _SCRATCH[key] = torch.zeros((2,), dtype=torch.int64,
                                        device=torch.device("cuda", key))
    return t


def range_fold(body: torch.Tensor, lo, hi) -> torch.Tensor:
    """K5: fold, in place, the columns of the (L+1, N) body whose key lies
    outside [lo, hi) to the sentinel; returns the (1,) count of in-range
    columns.  lo, hi: L u32 lane values each."""
    _check(body, "body", ndim=2, rows_strided=True)
    L = body.shape[0] - 1
    _lanes_ok(L, "range_fold")
    if not body.shape[1]:
        return torch.zeros((1,), dtype=torch.int64, device=body.device)
    occ = torch.empty((1,), dtype=torch.int64, device=body.device)
    _launch("bt_range_fold", body.data_ptr(), body.stride(0), body.shape[1],
            L, _key_arg(lo, L, "lo"), _key_arg(hi, L, "hi"),
            _fold_scratch(body.device).data_ptr(), occ.data_ptr())
    LAUNCHES["range_fold"] += 1
    return occ


def lower_bound(run: torch.Tensor, n: int, bounds: torch.Tensor) -> torch.Tensor:
    """K6: for each column of the (L, P) bounds, the number of columns of
    the run, sorted over its first n, whose key is below it: (P,)."""
    _check(run, "run", ndim=2)
    _check(bounds, "bounds", ndim=2)
    L = run.shape[0]
    _lanes_ok(L, "lower_bound")
    if bounds.shape[0] != L or not 0 <= n <= run.shape[1]:
        raise ValueError("lower_bound: bounds or n do not fit the run")
    P = bounds.shape[1]
    out = run.new_empty((P,))
    if P:
        _launch("bt_lower_bound", run.data_ptr(), run.stride(0), n, L,
                bounds.data_ptr(), bounds.stride(0), P, out.data_ptr())
        LAUNCHES["lower_bound"] += 1
    return out


def solid_fold_histogram(unique: torch.Tensor, counts: torch.Tensor,
                         minpos: torch.Tensor, n_unique: int,
                         abundance_min: int, abundance_max: int,
                         histo_max: int):
    """K7: (solid, counts', pos', n_solid (1,), histogram (histo_max+1,))."""
    _check(unique, "unique", ndim=2)
    _check(counts, "counts", ndim=1)
    _check(minpos, "minpos", ndim=1)
    L, N = unique.shape
    _lanes_ok(L, "solid_fold_histogram")
    if counts.shape[0] != N or minpos.shape[0] != N or histo_max < 0:
        raise ValueError("solid_fold_histogram: shapes do not match")
    dev = unique.device
    solid = torch.empty_like(unique)
    scounts = torch.empty_like(counts)
    spos = torch.empty_like(minpos)
    n_solid = torch.zeros((1,), dtype=torch.int64, device=dev)
    histo = torch.zeros((histo_max + 1,), dtype=torch.int64, device=dev)
    if N:
        _launch("bt_solid_fold", unique.data_ptr(), unique.stride(0),
                counts.data_ptr(), minpos.data_ptr(), N, min(n_unique, N), L,
                abundance_min, abundance_max, histo_max, solid.data_ptr(),
                solid.stride(0), scounts.data_ptr(), spos.data_ptr(),
                n_solid.data_ptr(), histo.data_ptr())
        LAUNCHES["solid_fold_histogram"] += 1
    return solid, scounts, spos, n_solid, histo


def run_scans(succ: torch.Tensor, n_solid: int, C: int, gbase: int = 0):
    """K8 on the (>= C,) successor array: (is_head, is_tail, rid, head_pos,
    end_pos, R (1,)) over [0, C); entry i links to i+1 when succ[i] ==
    gbase + i + 1."""
    _check(succ, "succ", ndim=1)
    if succ.shape[0] < C or not 0 <= n_solid <= C:
        raise ValueError("run_scans: succ shorter than C or n_solid > C")
    if C >= 2**31:
        raise ValueError("run_scans: C >= 2^31 (the look-back packs two "
                         "31-bit values per status word)")
    dev = succ.device
    is_head = torch.empty((C,), dtype=torch.bool, device=dev)
    is_tail = torch.empty((C,), dtype=torch.bool, device=dev)
    rid = torch.empty((C,), dtype=torch.int64, device=dev)
    head_pos = torch.empty((C,), dtype=torch.int64, device=dev)
    end_pos = torch.empty((C,), dtype=torch.int64, device=dev)
    if not C:
        return (is_head, is_tail, rid, head_pos, end_pos,
                torch.zeros((1,), dtype=torch.int64, device=dev))
    # [0] R (written by the last tile), [1] the ticket, [2:] one status word
    # per tile (the ticket and status words are zeroed in the C call)
    scratch = torch.empty((2 + -(-C // RUNSCAN_TILE),), dtype=torch.int64,
                          device=dev)
    _launch("bt_run_scans", succ.data_ptr(), C, n_solid, gbase,
            scratch.data_ptr() + 8, is_head.data_ptr(), is_tail.data_ptr(),
            rid.data_ptr(), head_pos.data_ptr(), end_pos.data_ptr(),
            scratch.data_ptr())
    LAUNCHES["run_scans"] += 1
    return is_head, is_tail, rid, head_pos, end_pos, scratch[:1]


def solid_compact(unique: torch.Tensor, counts: torch.Tensor,
                  minpos, n_unique: int, abundance_min: int,
                  abundance_max: int, width=None):
    """K9: (stacked (L+2, W): the solid columns' lanes, counts and minpos
    compacted to the front, 0 past n_solid (minpos: the sentinel), W =
    width or N; n_solid (1,)).  minpos None: the (L+1, W) lanes and counts
    alone (filter_abundance)."""
    _check(unique, "unique", ndim=2)
    _check(counts, "counts", ndim=1)
    if minpos is not None:
        _check(minpos, "minpos", ndim=1)
    L, N = unique.shape
    _lanes_ok(L, "solid_compact")
    if counts.shape[0] != N or (minpos is not None and minpos.shape[0] != N):
        raise ValueError("solid_compact: shapes do not match")
    dev = unique.device
    W = N if width is None else width
    rows = L + 1 + (minpos is not None)
    if not N:
        out = torch.zeros((rows, W), dtype=torch.int64, device=dev)
        if minpos is not None:
            out[L + 1].fill_(0xFFFFFFFF)
        return out, torch.zeros((1,), dtype=torch.int64, device=dev)
    # the kernel writes every column: the solid ones, then the tail
    out = torch.empty((rows, W), dtype=torch.int64, device=dev)
    # [0] n_solid, [1] the tile counter, [2:] one status word per tile
    scratch = torch.zeros((2 + -(-N // COMPACT_TILE),), dtype=torch.int64,
                          device=dev)
    _launch("bt_solid_compact", unique.data_ptr(), unique.stride(0),
            counts.data_ptr(), None if minpos is None else minpos.data_ptr(),
            N, min(n_unique, N), L, abundance_min, abundance_max,
            scratch.data_ptr() + 8, out.data_ptr(), out.stride(0), W,
            scratch.data_ptr())
    LAUNCHES["solid_compact"] += 1
    return out, scratch[:1]


def chain_finish(succ: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor,
                 state: torch.Tensor, wlen=None):
    """K10: the finish_fast dict (uid, rank, n_unitigs (1,), start_oid,
    length, circular) of a converged (M, 4) state.  One C call: a memset
    and three kernels, into the outputs and one workspace."""
    for t, name in ((succ, "succ"), (pred, "pred"), (wlen, "wlen")):
        if t is not None:
            _check(t, name, ndim=1)
    _check(valid, "valid", dtype=torch.bool, ndim=1)
    _check(state, "state", ndim=2)
    M = succ.shape[0]
    if (pred.shape[0] != M or valid.shape[0] != M or state.shape != (M, 4)
            or (wlen is not None and wlen.shape[0] != M) or M % 2):
        raise ValueError("chain_finish: expected (M,) arrays and an (M, 4) "
                         "state, M even")
    _aligned16(state, "state")
    dev = succ.device
    i64 = dict(dtype=torch.int64, device=dev)
    # uid, rank, start_oid, length and n_unitigs in one allocation; the
    # kernels write every entry
    out = torch.empty((4 * M + 1,), **i64)
    uid, rank, start_oid, length = out[:4 * M].view(4, M)
    n_unitigs = out[4 * M:]
    circular = torch.empty((M,), dtype=torch.bool, device=dev)
    if not M:
        n_unitigs.zero_()
    else:
        # end_of, len_at_start, ks, the ticket and status words: the C call
        # sets what it reads
        work = torch.empty((3 * M + 1 + -(-M // FINISH_TILE),), **i64)
        _launch("bt_chain_finish", succ.data_ptr(), pred.data_ptr(),
                valid.data_ptr(), state.data_ptr(),
                None if wlen is None else wlen.data_ptr(), M, work.data_ptr(),
                uid.data_ptr(), rank.data_ptr(), start_oid.data_ptr(),
                length.data_ptr(), circular.data_ptr(), n_unitigs.data_ptr())
        LAUNCHES["chain_finish"] += 1
    return {"uid": uid, "rank": rank, "n_unitigs": n_unitigs,
            "start_oid": start_oid, "length": length, "circular": circular}


def spell_unitigs(solid: torch.Tensor, counts: torch.Tensor, uid: torch.Tensor,
                  rank: torch.Tensor, length: torch.Tensor,
                  start_oid: torch.Tensor, n_unitigs: int, k: int,
                  n_members: int):
    """K11: (codes u8 (n_members + (k-1) U,), member-ordered counts
    (n_members,)) of the first U = n_unitigs unitigs, whose members have
    the ranks 0 .. length-1, each once (chain_finish's outputs).  One C
    call: a memset of the scan's words and two kernels, which write every
    element of both outputs."""
    _check(solid, "solid", ndim=2, rows_strided=True)
    for t, name in ((counts, "counts"), (uid, "uid"), (rank, "rank"),
                    (length, "length"), (start_oid, "start_oid")):
        _check(t, name, ndim=1)
    L, C = solid.shape
    _lanes_ok(L, "spell_unitigs")
    U = n_unitigs
    if (counts.shape[0] < C or uid.shape[0] != 2 * C or rank.shape[0] != 2 * C
            or length.shape[0] < U or start_oid.shape[0] < U or L != (k + 15) // 16):
        raise ValueError("spell_unitigs: shapes do not match")
    dev = solid.device
    total = n_members + (k - 1) * U
    if not (U and C):
        return (torch.zeros((total,), dtype=torch.uint8, device=dev),
                torch.zeros((n_members,), dtype=torch.int64, device=dev))
    codes = torch.empty((total,), dtype=torch.uint8, device=dev)
    mcounts = torch.empty((n_members,), dtype=torch.int64, device=dev)
    # run_start, then the scan's ticket and tile status words
    work = torch.empty((U + 1 + -(-U // SPELL_TILE),), dtype=torch.int64,
                       device=dev)
    _launch("bt_spell_unitigs", solid.data_ptr(), solid.stride(0), L, C,
            counts.data_ptr(), uid.data_ptr(), rank.data_ptr(),
            length.data_ptr(), start_oid.data_ptr(), U, k,
            work.data_ptr() + 8 * U, work.data_ptr(), codes.data_ptr(), total,
            mcounts.data_ptr(), n_members)
    LAUNCHES["spell_unitigs"] += 1
    return codes, mcounts


def run_contract(succ: torch.Tensor, is_head: torch.Tensor, rid: torch.Tensor,
                 end_pos: torch.Tensor, R: int, R_cap: int):
    """K12a: (hpos, epos (R_cap,), csucc, cvalid, wlen2 (2 R_cap,)) of the
    contracted run graph."""
    _check(succ, "succ", ndim=1)
    _check(is_head, "is_head", dtype=torch.bool, ndim=1)
    _check(rid, "rid", ndim=1)
    _check(end_pos, "end_pos", ndim=1)
    C = is_head.shape[0]
    if succ.shape[0] != 2 * C or rid.shape[0] != C or end_pos.shape[0] != C \
            or not 0 <= R <= R_cap:
        raise ValueError("run_contract: shapes do not match")
    dev = succ.device
    hpos = torch.empty((R_cap,), dtype=torch.int64, device=dev)
    epos = torch.empty((R_cap,), dtype=torch.int64, device=dev)
    csucc = torch.empty((2 * R_cap,), dtype=torch.int64, device=dev)
    cvalid = torch.empty((2 * R_cap,), dtype=torch.bool, device=dev)
    wlen2 = torch.empty((2 * R_cap,), dtype=torch.int64, device=dev)
    if C and R_cap:
        _launch("bt_run_contract", succ.data_ptr(), C, is_head.data_ptr(),
                rid.data_ptr(), end_pos.data_ptr(), R, R_cap, hpos.data_ptr(),
                epos.data_ptr(), csucc.data_ptr(), cvalid.data_ptr(),
                wlen2.data_ptr())
        LAUNCHES["run_contract"] += 1
    return hpos, epos, csucc, cvalid, wlen2


def run_broadcast(cuid: torch.Tensor, crank: torch.Tensor, cstart: torch.Tensor,
                  rid: torch.Tensor, head_pos: torch.Tensor,
                  end_pos: torch.Tensor, hpos: torch.Tensor, epos: torch.Tensor,
                  n_solid: int):
    """K12b: (uid, rank (2C,), start_oid (2 R_cap,)) over the original
    oriented nodes."""
    for t, name in ((cuid, "cuid"), (crank, "crank"), (cstart, "cstart"),
                    (rid, "rid"), (head_pos, "head_pos"), (end_pos, "end_pos"),
                    (hpos, "hpos"), (epos, "epos")):
        _check(t, name, ndim=1)
    C = rid.shape[0]
    R_cap = hpos.shape[0]
    if (cuid.shape[0] != 2 * R_cap or crank.shape[0] != 2 * R_cap
            or cstart.shape[0] != 2 * R_cap or epos.shape[0] != R_cap
            or head_pos.shape[0] != C or end_pos.shape[0] != C
            or not 0 <= n_solid <= C):
        raise ValueError("run_broadcast: shapes do not match")
    dev = rid.device
    uid = torch.empty((2 * C,), dtype=torch.int64, device=dev)
    rank = torch.empty((2 * C,), dtype=torch.int64, device=dev)
    start_oid = torch.empty((2 * R_cap,), dtype=torch.int64, device=dev)
    if C and R_cap:
        _launch("bt_run_broadcast", cuid.data_ptr(), crank.data_ptr(),
                cstart.data_ptr(), rid.data_ptr(), head_pos.data_ptr(),
                end_pos.data_ptr(), hpos.data_ptr(), epos.data_ptr(), n_solid,
                C, R_cap, uid.data_ptr(), rank.data_ptr(), start_oid.data_ptr())
        LAUNCHES["run_broadcast"] += 1
    return uid, rank, start_oid


def junction_entries(solid: torch.Tensor, n_local: int, k: int, gbase: int,
                     tot: int, n_dev: int, key_rows: int):
    """K3a, global mode: (entries (key_rows+1, 4N): the key rows, then the
    payload; valid (4N,) bool; owner (4N,)) of the four junction entries
    of each of the N = solid.shape[1] local k-mers."""
    _check(solid, "solid", ndim=2)
    L, N = solid.shape
    _lanes_ok(L, "junction_entries")
    dev = solid.device
    ent = torch.empty((key_rows + 1, 4 * N), dtype=torch.int64, device=dev)
    valid = torch.empty((4 * N,), dtype=torch.bool, device=dev)
    owner = torch.empty((4 * N,), dtype=torch.int64, device=dev)
    if N:
        _launch("bt_junction_entries", solid.data_ptr(), solid.stride(0), N,
                n_local, L, k, gbase, tot, n_dev, ent.data_ptr(),
                ent.stride(0), ent[key_rows].data_ptr(), owner.data_ptr(),
                valid.data_ptr())
        LAUNCHES["junction_keys"] += 1
    return ent, valid, owner


def junction_words(rows: torch.Tensor, valid: torch.Tensor):
    """K3, global mode: the compaction in front of the sort.  rows: the
    received (K+1, E) stack (K key rows, then the payload), valid (E,).
    Returns (words (ceil(K/2), E), payload (E,), n (1,)): the n valid
    slots, in receive order, packed into the sort words
    (models.lanes.pack_keys) and their payloads, at [0, n) of each row;
    the columns past n are not written."""
    _check(rows, "rows", ndim=2, rows_strided=True)
    _check(valid, "valid", dtype=torch.bool, ndim=1)
    K, E = rows.shape[0] - 1, rows.shape[1]
    if valid.shape[0] != E or not 1 <= K <= MAX_LANES + 1:
        raise ValueError("junction_words: shapes do not match")
    dev = rows.device
    words = torch.empty(((K + 1) // 2, E), dtype=torch.int64, device=dev)
    payload = torch.empty((E,), dtype=torch.int64, device=dev)
    # [0] n, [1] the tile counter, [2:] one status word per tile
    scratch = torch.zeros((2 + -(-E // WORDS_TILE),), dtype=torch.int64,
                          device=dev)
    if E:
        _launch("bt_junction_words", rows.data_ptr(), rows.stride(0), K,
                valid.data_ptr(), E, scratch.data_ptr(), words.data_ptr(),
                words.stride(0), payload.data_ptr())
        LAUNCHES["junction_words"] += 1
    return words, payload, scratch[:1]


def junction_edges(s_word: torch.Tensor, perm: torch.Tensor,
                   words: torch.Tensor, payload: torch.Tensor, K: int,
                   tot: int, slot_cap: int):
    """K3b, global mode, on the sort's own output: s_word the sorted top
    word and perm the permutation (sort.lex_sort_words of words), words
    (ceil(K/2), E) and payload (E,) in entry order (words' rows may lie
    apart: the first E columns of junction_words' output).  Returns (ok
    (E,) bool, edges (2, E): src, dst, owner (E,): the rank owning src's
    slot) per sorted entry, (-1, -1, 0) where not ok."""
    from .junctions import exact_sentinel, sentinel_words

    for t, name in ((s_word, "s_word"), (perm, "perm"), (payload, "payload")):
        _check(t, name, ndim=1)
    _check(words, "words", ndim=2, rows_strided=True)
    E = s_word.shape[0]
    if (perm.shape[0] != E or payload.shape[0] != E
            or words.shape != ((K + 1) // 2, E) or slot_cap < 1):
        raise ValueError("junction_edges: shapes do not match")
    dev = s_word.device
    ok = torch.empty((E,), dtype=torch.bool, device=dev)
    edges = torch.empty((2, E), dtype=torch.int64, device=dev)
    owner = torch.empty((E,), dtype=torch.int64, device=dev)
    sent0, shift = sentinel_words(K)
    if E:
        _launch("bt_junction_edges", s_word.data_ptr(), perm.data_ptr(),
                words.data_ptr(), words.stride(0), words.shape[0],
                payload.data_ptr(), E, tot,
                slot_cap, shift, sent0 >> shift, ok.data_ptr(),
                edges.data_ptr(), owner.data_ptr())
        LAUNCHES["junction_pairs"] += 1
    return ok, edges, owner


def junction_scatter(edges: torch.Tensor, ev: torch.Tensor, tot: int,
                     base: int, slot_cap: int) -> torch.Tensor:
    """K3, global mode: the (2*slot_cap,) successor shard of the rank whose
    slots start at base: each received edge (a, b) with ev set writes b at
    a's local oriented id (an id outside the table is dropped), -1
    elsewhere.  No two edges may name one slot (every oriented node has
    one out-end), and b must lie in [-2^49, 2^49) (an oriented id always
    does).  One C call: the memset of the windows' counts, the bins, the
    windows."""
    _check(edges, "edges", ndim=2)
    _check(ev, "ev", dtype=torch.bool, ndim=1)
    R = ev.shape[0]
    if edges.shape != (2, R) or not 0 <= 2 * slot_cap < 2**31:
        raise ValueError("junction_scatter: shapes do not match")
    dev = ev.device
    T = 2 * slot_cap
    table = torch.empty((T,), dtype=torch.int64, device=dev)
    # each window's bottom count, then each window's top count
    counts = torch.empty((2 * -(-T // SCATTER_WINDOW),), dtype=torch.int32,
                         device=dev)
    if T:
        _launch("bt_junction_scatter", edges.data_ptr(), ev.data_ptr(), R,
                tot, base, slot_cap, counts.data_ptr(), table.data_ptr())
        LAUNCHES["junction_scatter"] += 1
    return table


def form_superkmers(words: torch.Tensor, lengths: torch.Tensor, k: int, m: int,
                    table: torch.Tensor, rank, max_span: int, Wn: int,
                    bits: int, with_pos: bool, pos_base: int):
    """K13: (skm_words (Wn [+1], B*P), owner (B*P,), start (B*P,) bool,
    n_kmers (1,)); rank None = the m-mer is the key."""
    _check(words, "words", ndim=2)
    _check(lengths, "lengths", ndim=1)
    _check(table, "table", ndim=1)
    if rank is not None:
        _check(rank, "rank", ndim=1)
    B, W = words.shape
    if W > MAX_ROW_WORDS or not 1 <= m <= 16 or m >= k:
        raise ValueError(f"form_superkmers: W={W} (max {MAX_ROW_WORDS}), "
                         f"m={m}, k={k}")
    dev = words.device
    N = B * 16 * W
    skm = torch.empty((Wn + int(with_pos), N), dtype=torch.int64, device=dev)
    owner = torch.empty((N,), dtype=torch.int64, device=dev)
    start = torch.empty((N,), dtype=torch.bool, device=dev)
    if not B:
        return skm, owner, start, torch.zeros((1,), dtype=torch.int64, device=dev)
    n_kmers = torch.empty((1,), dtype=torch.int64, device=dev)  # the kernel writes it
    _launch("bt_form_superkmers", words.data_ptr(), lengths.data_ptr(), B, W,
            k, m, table.data_ptr(), None if rank is None else rank.data_ptr(),
            max_span, Wn, bits, int(with_pos), pos_base & 0xFFFFFFFF,
            skm.data_ptr(), owner.data_ptr(), start.data_ptr(),
            n_kmers.data_ptr())
    LAUNCHES["form_superkmers"] += 1
    return skm, owner, start, n_kmers


def mmer_histograms(words: torch.Tensor, lengths: torch.Tensor, k: int, m: int,
                    rank, load: bool, histo: torch.Tensor) -> torch.Tensor:
    """K14: add a (B, W) block's canonical m-mer histogram (load False) or
    window-min-key load (load True; rank None = the m-mer is the key) into
    histo (4^m,), in place; returns histo."""
    _check(words, "words", ndim=2)
    _check(lengths, "lengths", ndim=1)
    _check(histo, "histo", ndim=1)
    if rank is not None:
        _check(rank, "rank", ndim=1)
    B, W = words.shape
    if (W > MAX_ROW_WORDS or not 1 <= m <= 16 or m >= k
            or lengths.shape[0] != B or histo.shape[0] != 4 ** m):
        raise ValueError(f"mmer_histograms: W={W} (max {MAX_ROW_WORDS}), "
                         f"m={m}, k={k}, {lengths.shape[0]} lengths, "
                         f"histo {tuple(histo.shape)}")
    if B:
        _launch("bt_mmer_histograms", words.data_ptr(), lengths.data_ptr(), B,
                W, k, m, None if rank is None else rank.data_ptr(), int(load),
                histo.data_ptr())
        LAUNCHES["mmer_histograms"] += 1
    return histo


def route_buckets(stacked: torch.Tensor, valid: torch.Tensor,
                  owner, n_dev: int, cap: int, with_slots: bool = False,
                  fill: int = 0, with_valid: bool = True):
    """K15: (send (n_dev, C+V, cap), n_dropped (1,)[, slots (N,)]): the
    exchange's send buffer, bucket d's C channels then, with_valid (V =
    1), its validity (1 where placed, 0 where empty) as channel C, the
    empty slots of channels 0..C-1 holding `fill`.  owner None: hash mode,
    each entry's owner is hash_lanes of its C channels % n_dev
    (csrc/hash.cuh), counted in LAUNCHES as route_buckets_hash."""
    _check(stacked, "stacked", ndim=2, rows_strided=True)
    _check(valid, "valid", dtype=torch.bool, ndim=1)
    if owner is not None:
        _check(owner, "owner", ndim=1)
    C, N = stacked.shape
    if (valid.shape[0] != N or (owner is not None and owner.shape[0] != N)
            or not 1 <= n_dev <= 256 or C < 1 or cap < 0):
        raise ValueError("route_buckets: shapes do not match")
    dev = stacked.device
    # the kernel writes every element of send (the placed entries, the
    # empty slots as its blocks prove them empty) and zeroes its scratch:
    # [0] dropped, [1] the tile counter, [2:] one status word per block and
    # owner (an empty stack runs one tile; a grid of fewer tiles than SMs
    # as many pool blocks more)
    send = torch.empty((n_dev, C + int(with_valid), cap), dtype=torch.int64,
                       device=dev)
    tiles = max(1, -(-N // ROUTE_TILE))
    blocks = 2 * tiles if tiles < ROUTE_POOL_TILES else tiles
    scratch = torch.empty((2 + blocks * n_dev,), dtype=torch.int64, device=dev)
    slots = (torch.empty((N,), dtype=torch.int64, device=dev)
             if with_slots else None)
    if N or cap:
        _launch("bt_route_buckets", stacked.data_ptr(), stacked.stride(0), C,
                None if owner is None else owner.data_ptr(), valid.data_ptr(),
                N, n_dev, cap, fill, int(with_valid), scratch.data_ptr(),
                send.data_ptr(), None if slots is None else slots.data_ptr())
        LAUNCHES["route_buckets" if owner is not None
                 else "route_buckets_hash"] += 1
    else:
        scratch.zero_()
    out = (send, scratch[:1])
    return out + (slots,) if with_slots else out


def glue_compose(Q: torch.Tensor, back: torch.Tensor, slots: torch.Tensor,
                 need: torch.Tensor, changed: torch.Tensor, route: torch.Tensor,
                 run_cap: int, n_dev: int) -> None:
    """K16, in place: each row v of Q with need[v] composed with its
    ancestor row back[:, slots[v]] (the (4, W) response of the exchange,
    the slot clamped to [0, W)); changed ((1,) int32) set to 1 when a row
    moved; need, route[0] (ptr) and route[1] (owner of ptr among n_dev
    ranks of run_cap runs, n_dev where no step is needed) written for the
    next round where need was set, left as they are elsewhere."""
    M = _check_state(Q, "Q")
    _check(back, "back", ndim=2)
    _check(slots, "slots", ndim=1)
    _check(need, "need", dtype=torch.bool, ndim=1)
    _check(changed, "changed", dtype=torch.int32, ndim=1)
    _check(route, "route", ndim=2)
    if (back.shape[0] != 4 or slots.shape[0] != M or need.shape[0] != M
            or route.shape != (2, M) or (M and back.shape[1] == 0)
            or run_cap < 1 or n_dev < 1):
        raise ValueError("glue_compose: shapes do not match")
    _aligned16(Q, "Q")
    if M:
        _launch("bt_glue_compose", Q.data_ptr(), back.data_ptr(), back.shape[1],
                slots.data_ptr(), need.data_ptr(), M, changed.data_ptr(),
                route.data_ptr(), run_cap, n_dev)
        LAUNCHES["glue_compose"] += 1


# K21's modes: (C function mode, answer channels, tables)
_GLUE_ANSWER = {"rows": (0, 4, 1), "run": (1, 2, 3), "uid": (2, 1, 1)}


def glue_answer(mode: str, vals: torch.Tensor, valid: torch.Tensor, tables,
                run_cap: int, n_dev: int, me: int) -> torch.Tensor:
    """K21: the owner's (C, S) channel-major answer to S received query
    values and their validity (distcompact.glue_answer_plain's contract):
    mode "rows", tables (Q,) of 2*run_cap state rows (16-byte aligned);
    "run", tables (rid_loc, head_pos_v, end_pos_v) of this rank's slot_cap
    slots; "uid", tables (uid_at,) of 2*run_cap runs.  The kernel writes
    every element."""
    if mode not in _GLUE_ANSWER:
        raise ValueError(f"glue_answer: unknown mode {mode!r}")
    code, C, n_tables = _GLUE_ANSWER[mode]
    _check(vals, "vals", ndim=1)
    _check(valid, "valid", dtype=torch.bool, ndim=1)
    if len(tables) != n_tables:
        raise ValueError(f"glue_answer: mode {mode} takes {n_tables} tables")
    for j, t in enumerate(tables):
        _check(t, f"tables[{j}]", ndim=2 if mode == "rows" else 1)
    S = vals.shape[0]
    T = tables[0].shape[0]
    if (valid.shape[0] != S or run_cap < 1 or n_dev < 1 or not 0 <= me < n_dev
            or any(t.shape[0] != T for t in tables)
            or (mode == "rows" and tables[0].shape != (2 * run_cap, 4))
            or (mode == "uid" and T != 2 * run_cap) or T == 0):
        raise ValueError("glue_answer: shapes do not match")
    if mode == "rows":
        _aligned16(tables[0], "Q")
    out = torch.empty((C, S), dtype=torch.int64, device=vals.device)
    if S:
        ptrs = [t.data_ptr() for t in tables] + [None] * (3 - n_tables)
        _launch("bt_glue_answer", code, vals.data_ptr(), valid.data_ptr(), S,
                *ptrs, T, run_cap, n_dev * run_cap, me * T, me * run_cap,
                out.data_ptr())
        LAUNCHES[f"glue_answer_{mode}"] += 1
    return out


def _check_state(Q: torch.Tensor, name: str) -> int:
    _check(Q, name, ndim=2)
    if Q.shape[1] != 4:
        raise ValueError(f"{name}: expected an (S, 4) state, got {tuple(Q.shape)}")
    return Q.shape[0]


def fixpoint_bits(gid, valid: torch.Tensor, salt: int) -> torch.Tensor:
    """K17's per-level bitmap: bit v % 32 of int32 word v // 32 is
    valid[v] && _sampled(gid[v], salt), rows past S zero; gid None: level
    0, where gid is the row index and valid must be 16-byte aligned.  Built
    once per level."""
    _check(valid, "valid", dtype=torch.bool, ndim=1)
    S = valid.shape[0]
    if gid is not None:
        _check(gid, "gid", ndim=1)
        if gid.shape[0] != S:
            raise ValueError("fixpoint_bits: shapes do not match")
    else:
        _aligned16(valid, "valid")
    bits = torch.empty((-(-S // 32),), dtype=torch.int32, device=valid.device)
    if S:
        _launch("bt_fixpoint_bits", None if gid is None else gid.data_ptr(),
                valid.data_ptr(), S, salt & 0xFFFFFFFF, bits.data_ptr())
        LAUNCHES["fixpoint_bits"] += 1
    return bits


def hier_round(Q: torch.Tensor, Qn: torch.Tensor, gid, bits: torch.Tensor,
               changed=None) -> None:
    """K17: one phase-A round Q -> Qn of the hierarchical jump, the level's
    fixpoints (bits, from fixpoint_bits) served as identity rows; gid None:
    level 0, where gid is the row index; changed (optional (1,) int32) is
    set to 1 when a row moved."""
    S = _check_state(Q, "Q")
    _check_state(Qn, "Qn")
    if gid is not None:
        _check(gid, "gid", ndim=1)
    _check(bits, "bits", dtype=torch.int32, ndim=1)
    if changed is not None:
        _check(changed, "changed", dtype=torch.int32, ndim=1)
    if (Qn.shape[0] != S or bits.shape[0] != -(-S // 32)
            or (gid is not None and gid.shape[0] != S)):
        raise ValueError("hier_round: shapes do not match")
    _aligned16(Q, "Q")
    _aligned16(Qn, "Qn")
    if S:
        _launch("bt_hier_round", Q.data_ptr(), Qn.data_ptr(),
                None if gid is None else gid.data_ptr(), bits.data_ptr(), S,
                None if changed is None else changed.data_ptr())
        LAUNCHES["hier_round"] += 1


def hier_contract(Q: torch.Tensor, gid: torch.Tensor, valid: torch.Tensor,
                  salt: int, S1: int, big: int, ok: torch.Tensor):
    """K18: the next level of the hierarchical jump.  Returns (Q1 (S1, 4),
    gid1 (S1,), valid1 (S1,) bool, did (S,), parent (S1,), n_c (1,)); ok
    (1,) int32 is cleared in place when more than S1 rows were selected.
    One C call: a memset and three kernels, into the outputs and one
    workspace."""
    S = _check_state(Q, "Q")
    _check(gid, "gid", ndim=1)
    _check(valid, "valid", dtype=torch.bool, ndim=1)
    _check(ok, "ok", dtype=torch.int32, ndim=1)
    if gid.shape[0] != S or valid.shape[0] != S or not 1 <= S1:
        raise ValueError("hier_contract: shapes do not match")
    dev = Q.device
    i64 = dict(dtype=torch.int64, device=dev)
    Q1 = torch.empty((S1, 4), **i64)
    gid1 = torch.empty((S1,), **i64)
    valid1 = torch.empty((S1,), dtype=torch.bool, device=dev)
    did = torch.empty((S,), **i64)
    parent = torch.empty((S1,), **i64)
    n_c = torch.empty((1,), **i64)
    # the selection's ticket and tile status words, then S bytes of tmask:
    # the C call clears them itself
    work = torch.empty((1 + -(-S // HIER_TILE) + -(-S // 8),), **i64)
    _launch("bt_hier_contract", Q.data_ptr(), gid.data_ptr(), valid.data_ptr(),
            S, salt & 0xFFFFFFFF, S1, big, work.data_ptr(), did.data_ptr(),
            parent.data_ptr(), n_c.data_ptr(), Q1.data_ptr(), gid1.data_ptr(),
            valid1.data_ptr(), ok.data_ptr())
    LAUNCHES["hier_contract"] += 1
    return Q1, gid1, valid1, did, parent, n_c


def hier_expand(F: torch.Tensor, parent: torch.Tensor, Qd: torch.Tensor,
                did: torch.Tensor) -> torch.Tensor:
    """K19: the converged (S, 4) state of a level from its phase-A state Qd
    and the converged (S1, 4) state F of the level above, written over Qd,
    which is returned."""
    S1 = _check_state(F, "F")
    S = _check_state(Qd, "Qd")
    _check(parent, "parent", ndim=1)
    _check(did, "did", ndim=1)
    if parent.shape[0] != S1 or did.shape[0] != S or not 1 <= S1:
        raise ValueError("hier_expand: shapes do not match")
    _aligned16(F, "F")
    _aligned16(Qd, "Qd")
    if S:
        _launch("bt_hier_expand", F.data_ptr(), parent.data_ptr(), Qd.data_ptr(),
                did.data_ptr(), S, S1)
        LAUNCHES["hier_expand"] += 1
    return Qd


def kmer_minimizers(lanes: torch.Tensor, k: int, m: int, rank=None,
                    table=None, valid=None, histogram: bool = False):
    """K20 on the (L, N) k-mer lanes: each column's minimizer (rank None:
    least m-mer value; else least rank[m-mer], first wins), mapped through
    table when given: (N,); or, histogram=True, the (4^m,) count of every
    m-mer of the valid columns (zeroed by the C call itself)."""
    _check(lanes, "lanes", ndim=2, rows_strided=True)
    for t, name in ((rank, "rank"), (table, "table")):
        if t is not None:
            _check(t, name, ndim=1)
    if valid is not None:
        _check(valid, "valid", dtype=torch.bool, ndim=1)
    L, N = lanes.shape
    _lanes_ok(L, "kmer_minimizers")
    if not 1 <= m <= 16 or m > k or L != (k + 15) // 16 \
            or (valid is not None and valid.shape[0] != N):
        raise ValueError(f"kmer_minimizers: k={k}, m={m}, lanes {tuple(lanes.shape)}")
    out = torch.empty((4 ** m,) if histogram else (N,), dtype=torch.int64,
                      device=lanes.device)
    if N:
        _launch("bt_kmer_minimizers", lanes.data_ptr(), lanes.stride(0), L, N,
                k, m, None if rank is None else rank.data_ptr(),
                None if table is None else table.data_ptr(), int(histogram),
                None if valid is None else valid.data_ptr(), out.data_ptr())
        LAUNCHES["kmer_minimizers"] += 1
    elif histogram:
        out.zero_()
    return out


def link_ends(codes: torch.Tensor, ends: torch.Tensor, k: int) -> torch.Tensor:
    """K22: the exact packed keys (W, 4U) of the four ends of U unitigs
    spelled in codes (K11's layout), ends the inclusive prefix of their
    lengths (U,): out-ends (u,+) = suffix at u, (u,-) = rc(prefix) at U + u;
    in-ends (u,+) = prefix at 2U + u, (u,-) = rc(suffix) at 3U + u.  The
    caller keeps codes at least ends[-1] + (k-1) U long."""
    _check(codes, "codes", dtype=torch.uint8, ndim=1)
    _check(ends, "ends", ndim=1)
    U = ends.shape[0]
    if not 2 <= k <= MAX_K:
        raise ValueError(f"link_ends: k = {k}; the kernels take 2 <= k <= {MAX_K}")
    W = end_words(k)
    keys = torch.empty((W, 4 * U), dtype=torch.int64, device=codes.device)
    if U:
        _launch("bt_link_ends", codes.data_ptr(), ends.data_ptr(), U, k, W,
                keys.data_ptr())
        LAUNCHES["link_ends"] += 1
    return keys


def link_pairs(top: torch.Tensor, perm: torch.Tensor, lower, U: int) -> torch.Tensor:
    """K23: the links (P,) of U unitigs' ends, each as ((2 src + sign) <<
    32) | (2 dst + sign) with + = 0, - = 1, unique and in no set order,
    from the stable sort of K22's keys: top the first key word in sorted
    order (4U,), perm the permutation, lower the other words (W-1, 4U) in
    entry order or None.  One launch (a memset of the count and a kernel)
    into room for 8U pairs, one host read of the count P, and a second
    launch with room for P where 8U was short."""
    _check(top, "top", ndim=1)
    _check(perm, "perm", ndim=1)
    N = 4 * U
    nl = 0
    if lower is not None:
        _check(lower, "lower", ndim=2)
        nl = lower.shape[0]
        if lower.shape[1] != N or nl >= end_words(MAX_K):
            raise ValueError("link_pairs: shapes do not match")
    if top.shape[0] != N or perm.shape[0] != N:
        raise ValueError("link_pairs: shapes do not match")
    if U >= 1 << 30:  # 2 src + sign < 2^31: the words sort as int64
        raise ValueError(f"link_pairs: {U} unitigs; the pair words hold < 2^30")
    dev = top.device
    if not U:
        return torch.empty((0,), dtype=torch.int64, device=dev)
    count = torch.empty((1,), dtype=torch.int64, device=dev)
    cap = 2 * N
    while True:
        words = torch.empty((cap,), dtype=torch.int64, device=dev)
        _launch("bt_link_pairs", top.data_ptr(), perm.data_ptr(),
                0 if lower is None else lower.data_ptr(), nl, U,
                count.data_ptr(), cap, words.data_ptr())
        LAUNCHES["link_pairs"] += 1
        P = int(count.item())
        if P <= cap:
            return words[:P]
        cap = P
