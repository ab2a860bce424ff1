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
parallel/{pipeline,distcompact}.py and engine.py; these wrappers never fall back to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"extract_insert": 0, "count_runs": 0, "junction_keys": 0,
            "junction_pairs": 0, "jump_round": 0, "range_fold": 0,
            "lower_bound": 0, "solid_fold_histogram": 0, "run_scans": 0,
            "solid_compact": 0, "chain_finish": 0, "spell_unitigs": 0,
            "run_contract": 0, "run_broadcast": 0, "form_superkmers": 0,
            "mmer_histograms": 0, "route_buckets": 0, "glue_compose": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    "bt_extract_insert": [_P, _I64, _P, _P, _I32, _I32, _I32, _I32, _I32,
                          ctypes.c_uint, _P, _I64, _P],
    "bt_count_flags": [_P, _I64, _I64, _I32, _P, _P],
    "bt_count_scatter": [_P, _I64, _I64, _I32, _P, _P, _P, _P, _P, _I64, _P,
                         _P, _P],
    "bt_junction_keys": [_P, _I64, _I64, _I64, _I32, _I32, _I32, _P, _I64, _P,
                         _P],
    "bt_junction_pairs": [_P, _I64, _I32, _P, _I64, _I64, _I32, _P, _P],
    "bt_jump_round": [_P, _P, _I64, _P, _P],
    "bt_range_fold": [_P, _I64, _I64, _I32, _P, _P, _P, _P],
    "bt_lower_bound": [_P, _I64, _I64, _I32, _P, _I64, _I32, _P, _P],
    "bt_solid_fold": [_P, _I64, _P, _P, _I64, _I64, _I32, _I64, _I64, _I32,
                      _P, _I64, _P, _P, _P, _P, _P],
    "bt_run_scans": [_P, _I64, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P],
    "bt_solid_compact": [_P, _I64, _P, _P, _I64, _I64, _I32, _I64, _I64, _P,
                         _P, _I64, _I64, _P, _P],
    "bt_chain_finish": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P],
    "bt_spell_unitigs": [_P, _I64, _I32, _I64, _P, _P, _P, _P, _P, _I64, _I32,
                         _P, _P, _P, _I64, _P, _I64, _P],
    "bt_run_contract": [_P, _I64, _P, _P, _P, _I64, _I64, _P, _P, _P, _P, _P,
                        _P],
    "bt_run_broadcast": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P,
                         _P, _P, _P],
    "bt_junction_entries": [_P, _I64, _I64, _I64, _I32, _I32, _I64, _I64, _I32,
                            _P, _I64, _P, _P, _P],
    "bt_junction_edges": [_P, _I64, _I32, _P, _I64, _I64, _P, _P, _P, _P],
    "bt_form_superkmers": [_P, _P, _I32, _I32, _I32, _I32, _P, _P, _I32, _I32,
                           _I32, _I32, ctypes.c_uint, _P, _P, _P, _P, _P],
    "bt_mmer_histograms": [_P, _P, _I32, _I32, _I32, _I32, _P, _I32, _P, _P],
    "bt_route_count": [_P, _P, _I64, _I32, _P, _P],
    "bt_route_place": [_P, _I64, _I32, _P, _P, _I64, _I32, _I64, _P, _P, _P,
                       _P, _P, _P],
    "bt_glue_compose": [_P, _P, _P, _I64, _P, _P, _P],
}
ROUTE_TILE = 1024  # entries per tile of csrc/route.cu
MAX_ROW_WORDS = 64  # csrc/superkmer.cu: one block of <= 1024 positions per read
SCAN_TILE = 1024   # entries per tile of csrc/scan.cuh
MAX_LANES = 8

_lib = None


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
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
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


def _launch(fn_name: str, *args) -> None:
    lib = load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def _lanes_ok(L: int, what: str):
    if not 1 <= L <= MAX_LANES:
        raise ValueError(f"{what}: {L} lanes; the kernels take k <= "
                         f"{16 * MAX_LANES}")


def extract_insert(buf: torch.Tensor, words: torch.Tensor,
                   lengths: torch.Tensor, k: int, slot_base: int,
                   offset: int, row_base=None) -> None:
    """K1: write the folded (L+1, B*P_eff) extraction of a packed block into
    buf[:, offset:offset + B*P_eff] (in place).  row_base: (B,) per-row
    slot bases (slot = (row_base[b] + p) & 0x3FFFFFFF) instead of
    slot_base + b*P_eff + p."""
    _check(buf, "buf", ndim=2)
    _check(words, "words", ndim=2)
    _check(lengths, "lengths", ndim=1)
    if row_base is not None:
        _check(row_base, "row_base", ndim=1)
        if row_base.shape[0] != words.shape[0]:
            raise ValueError("extract_insert: one row base per read")
    L = buf.shape[0] - 1
    _lanes_ok(L, "extract_insert")
    B, W = words.shape
    P_eff = max(1, 16 * W - (k - 1))
    if lengths.shape[0] != B or offset + B * P_eff > buf.shape[1]:
        raise ValueError("extract_insert: block does not fit the buffer")
    if B * P_eff == 0:
        return
    _launch("bt_extract_insert", buf.data_ptr(),
            buf.stride(0), words.data_ptr(), lengths.data_ptr(), B, W, P_eff,
            k, L, slot_base, None if row_base is None else row_base.data_ptr(),
            offset)
    LAUNCHES["extract_insert"] += 1


def count_runs(s_lanes: torch.Tensor, weights, pos):
    """K2 on sorted (L, N) lanes: returns (unique, counts, minpos|None,
    n_unique tensor)."""
    _check(s_lanes, "s_lanes", ndim=2)
    for t, name in ((weights, "weights"), (pos, "pos")):
        if t is not None:
            _check(t, name, ndim=1)
    L, N = s_lanes.shape
    dev = s_lanes.device
    unique = torch.zeros((L, N), dtype=torch.int64, device=dev)
    counts = torch.zeros((N,), dtype=torch.int64, device=dev)
    minpos = (torch.full((N,), 0xFFFFFFFF, dtype=torch.int64, device=dev)
              if pos is not None else None)
    if N == 0:
        return unique, counts, minpos, torch.zeros((), dtype=torch.int64,
                                                   device=dev)
    flags = torch.empty((N,), dtype=torch.int64, device=dev)
    _launch("bt_count_flags", s_lanes.data_ptr(),
            s_lanes.stride(0), N, L, flags.data_ptr())
    gid = torch.cumsum(flags, 0) - 1
    _launch("bt_count_scatter", s_lanes.data_ptr(),
            s_lanes.stride(0), N, L, flags.data_ptr(), gid.data_ptr(),
            None if weights is None else weights.data_ptr(),
            None if pos is None else pos.data_ptr(), unique.data_ptr(),
            unique.stride(0), counts.data_ptr(),
            None if minpos is None else minpos.data_ptr())
    LAUNCHES["count_runs"] += 1
    return unique, counts, minpos, gid[-1] + 1


def junction_keys(solid: torch.Tensor, n_solid: int, k: int, hashed: bool,
                  key_rows: int):
    """K3a: (key_rows, 2C) sentinel-folded keys and the (2C,) payload."""
    _check(solid, "solid", ndim=2)
    L, C = solid.shape
    _lanes_ok(L, "junction_keys")
    keys = torch.empty((key_rows, 2 * C), dtype=torch.int64,
                       device=solid.device)
    payload = torch.empty((2 * C,), dtype=torch.int64, device=solid.device)
    if C:
        _launch("bt_junction_keys", solid.data_ptr(), solid.stride(0), C,
                n_solid, L, k, int(hashed), keys.data_ptr(), keys.stride(0),
                payload.data_ptr())
        LAUNCHES["junction_keys"] += 1
    return keys, payload


def junction_pairs(s_keys: torch.Tensor, s_pay: torch.Tensor, C: int,
                   hashed: bool) -> torch.Tensor:
    """K3b on sorted entries: the (2C,) successor array (-1 = none)."""
    _check(s_keys, "s_keys", ndim=2)
    _check(s_pay, "s_pay", ndim=1)
    E = s_pay.shape[0]
    succ = torch.full((2 * C,), -1, dtype=torch.int64, device=s_pay.device)
    if E >= 2:
        _launch("bt_junction_pairs", s_keys.data_ptr(), s_keys.stride(0),
                s_keys.shape[0], s_pay.data_ptr(), E, C, int(hashed),
                succ.data_ptr())
        LAUNCHES["junction_pairs"] += 1
    return succ


def jump_round(Q: torch.Tensor, Qn: torch.Tensor,
               changed: torch.Tensor) -> None:
    """K4: one doubling round Q -> Qn; sets changed[0] = 1 if a row moved."""
    _check(Q, "Q", ndim=2)
    _check(Qn, "Qn", ndim=2)
    _check(changed, "changed", dtype=torch.int32, ndim=1)
    if Q.shape != Qn.shape or Q.shape[1] != 4:
        raise ValueError("jump_round: expected two (M, 4) states")
    if Q.shape[0]:
        _launch("bt_jump_round", Q.data_ptr(), Qn.data_ptr(), Q.shape[0],
                changed.data_ptr())
        LAUNCHES["jump_round"] += 1


def _key_arg(key, L: int, what: str):
    """A key of L u32 lanes as a ctypes array (read by the host code)."""
    if len(key) != L:
        raise ValueError(f"{what}: expected {L} lanes, got {len(key)}")
    return (ctypes.c_uint32 * L)(*[int(x) for x in key])


def range_fold(body: torch.Tensor, lo, hi) -> torch.Tensor:
    """K5: fold, in place, the columns of the (L+1, N) body whose key lies
    outside [lo, hi) to the sentinel; returns the (1,) count of in-range
    columns.  lo, hi: L u32 lane values each."""
    _check(body, "body", ndim=2, rows_strided=True)
    L = body.shape[0] - 1
    _lanes_ok(L, "range_fold")
    occ = torch.zeros((1,), dtype=torch.int64, device=body.device)
    if body.shape[1]:
        _launch("bt_range_fold", body.data_ptr(), body.stride(0),
                body.shape[1], L, _key_arg(lo, L, "lo"),
                _key_arg(hi, L, "hi"), occ.data_ptr())
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
    out = torch.empty((P,), dtype=torch.int64, device=run.device)
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
    dev = succ.device
    is_head = torch.empty((C,), dtype=torch.bool, device=dev)
    is_tail = torch.empty((C,), dtype=torch.bool, device=dev)
    rid = torch.empty((C,), dtype=torch.int64, device=dev)
    head_pos = torch.empty((C,), dtype=torch.int64, device=dev)
    end_pos = torch.empty((C,), dtype=torch.int64, device=dev)
    R = torch.zeros((1,), dtype=torch.int64, device=dev)
    if C:
        tiles = -(-C // 1024)
        scratch = torch.empty((3 * tiles,), dtype=torch.int64, device=dev)
        _launch("bt_run_scans", succ.data_ptr(), C, n_solid, gbase,
                scratch.data_ptr(), is_head.data_ptr(), is_tail.data_ptr(),
                rid.data_ptr(), head_pos.data_ptr(), end_pos.data_ptr(),
                R.data_ptr())
        LAUNCHES["run_scans"] += 1
    return is_head, is_tail, rid, head_pos, end_pos, R


def _scan_scratch(n: int, dev) -> torch.Tensor:
    """Tile carries of csrc/scan.cuh's exclusive_sum over n entries."""
    return torch.empty((max(1, -(-n // SCAN_TILE)),), dtype=torch.int64,
                       device=dev)


def solid_compact(unique: torch.Tensor, counts: torch.Tensor,
                  minpos: torch.Tensor, n_unique: int, abundance_min: int,
                  abundance_max: int, width=None):
    """K9: (stacked (L+2, W): the solid columns' lanes, counts and minpos
    compacted to the front, 0 past n_solid (minpos: the sentinel), W =
    width or N; n_solid (1,))."""
    _check(unique, "unique", ndim=2)
    _check(counts, "counts", ndim=1)
    _check(minpos, "minpos", ndim=1)
    L, N = unique.shape
    _lanes_ok(L, "solid_compact")
    if counts.shape[0] != N or minpos.shape[0] != N:
        raise ValueError("solid_compact: shapes do not match")
    dev = unique.device
    W = N if width is None else width
    out = torch.zeros((L + 2, W), dtype=torch.int64, device=dev)
    out[L + 1].fill_(0xFFFFFFFF)
    n_solid = torch.zeros((1,), dtype=torch.int64, device=dev)
    if N:
        _launch("bt_solid_compact", unique.data_ptr(), unique.stride(0),
                counts.data_ptr(), minpos.data_ptr(), N, min(n_unique, N), L,
                abundance_min, abundance_max,
                _scan_scratch(N, dev).data_ptr(), out.data_ptr(), out.stride(0),
                W, n_solid.data_ptr())
        LAUNCHES["solid_compact"] += 1
    return out, n_solid


def chain_finish(succ: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor,
                 state: torch.Tensor, wlen=None):
    """K10: the finish_fast dict (uid, rank, n_unitigs (1,), start_oid,
    length, circular) of a converged (M, 4) state."""
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
    dev = succ.device
    end_of = torch.full((M,), -1, dtype=torch.int64, device=dev)
    len_at_start = torch.full((M,), -1, dtype=torch.int64, device=dev)
    ks = torch.empty((M,), dtype=torch.int64, device=dev)
    uid = torch.empty((M,), dtype=torch.int64, device=dev)
    rank = torch.empty((M,), dtype=torch.int64, device=dev)
    start_oid = torch.zeros((M,), dtype=torch.int64, device=dev)
    length = torch.zeros((M,), dtype=torch.int64, device=dev)
    circular = torch.zeros((M,), dtype=torch.bool, device=dev)
    n_unitigs = torch.zeros((1,), dtype=torch.int64, device=dev)
    if M:
        _launch("bt_chain_finish", succ.data_ptr(), pred.data_ptr(),
                valid.data_ptr(), state.data_ptr(),
                None if wlen is None else wlen.data_ptr(), M, end_of.data_ptr(),
                len_at_start.data_ptr(), ks.data_ptr(),
                _scan_scratch(M, dev).data_ptr(), uid.data_ptr(),
                rank.data_ptr(), start_oid.data_ptr(), length.data_ptr(),
                circular.data_ptr(), n_unitigs.data_ptr())
        LAUNCHES["chain_finish"] += 1
    return {"uid": uid, "rank": rank, "n_unitigs": n_unitigs,
            "start_oid": start_oid, "length": length, "circular": circular}


def spell_unitigs(solid: torch.Tensor, counts: torch.Tensor, uid: torch.Tensor,
                  rank: torch.Tensor, length: torch.Tensor,
                  start_oid: torch.Tensor, n_unitigs: int, k: int,
                  n_members: int):
    """K11: (codes u8 (n_members + (k-1) U,), member-ordered counts
    (n_members,)) of the first U = n_unitigs unitigs."""
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
    codes = torch.zeros((total,), dtype=torch.uint8, device=dev)
    mcounts = torch.zeros((n_members,), dtype=torch.int64, device=dev)
    if U and C:
        run_start = torch.empty((U,), dtype=torch.int64, device=dev)
        _launch("bt_spell_unitigs", solid.data_ptr(), solid.stride(0), L, C,
                counts.data_ptr(), uid.data_ptr(), rank.data_ptr(),
                length.data_ptr(), start_oid.data_ptr(), U, k,
                _scan_scratch(U, dev).data_ptr(), run_start.data_ptr(),
                codes.data_ptr(), total, mcounts.data_ptr(), n_members)
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
    """K3a, global mode: (keys (key_rows, 4N), payload (4N,), owner (4N,))
    of the four junction entries of each of the N = solid.shape[1] local
    k-mers."""
    _check(solid, "solid", ndim=2)
    L, N = solid.shape
    _lanes_ok(L, "junction_entries")
    dev = solid.device
    keys = torch.empty((key_rows, 4 * N), dtype=torch.int64, device=dev)
    payload = torch.empty((4 * N,), dtype=torch.int64, device=dev)
    owner = torch.empty((4 * N,), dtype=torch.int64, device=dev)
    if N:
        _launch("bt_junction_entries", solid.data_ptr(), solid.stride(0), N,
                n_local, L, k, gbase, tot, n_dev, keys.data_ptr(),
                keys.stride(0), payload.data_ptr(), owner.data_ptr())
        LAUNCHES["junction_keys"] += 1
    return keys, payload, owner


def junction_edges(s_keys: torch.Tensor, s_pay: torch.Tensor, tot: int):
    """K3b, global mode: (ok (E,) bool, src (E,), dst (E,)) of the pair
    rule over E sorted received entries."""
    _check(s_keys, "s_keys", ndim=2)
    _check(s_pay, "s_pay", ndim=1)
    E = s_pay.shape[0]
    dev = s_pay.device
    ok = torch.zeros((E,), dtype=torch.bool, device=dev)
    src = torch.empty((E,), dtype=torch.int64, device=dev)
    dst = torch.empty((E,), dtype=torch.int64, device=dev)
    if E:
        _launch("bt_junction_edges", s_keys.data_ptr(), s_keys.stride(0),
                s_keys.shape[0], s_pay.data_ptr(), E, tot, ok.data_ptr(),
                src.data_ptr(), dst.data_ptr())
        LAUNCHES["junction_pairs"] += 1
    return ok, src, dst


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
    n_kmers = torch.zeros((1,), dtype=torch.int64, device=dev)
    if B:
        _launch("bt_form_superkmers", words.data_ptr(), lengths.data_ptr(), B,
                W, k, m, table.data_ptr(),
                None if rank is None else rank.data_ptr(), max_span, Wn, bits,
                int(with_pos), pos_base & 0xFFFFFFFF, skm.data_ptr(),
                owner.data_ptr(), start.data_ptr(), n_kmers.data_ptr())
        LAUNCHES["form_superkmers"] += 1
    return skm, owner, start, n_kmers


def mmer_histograms(words: torch.Tensor, lengths: torch.Tensor, k: int, m: int,
                    rank, load: bool) -> torch.Tensor:
    """K14: the (4^m,) canonical m-mer histogram (load False) or the
    window-min-key load (load True; rank None = the m-mer is the key)."""
    _check(words, "words", ndim=2)
    _check(lengths, "lengths", ndim=1)
    if rank is not None:
        _check(rank, "rank", ndim=1)
    B, W = words.shape
    if W > MAX_ROW_WORDS or not 1 <= m <= 16 or m >= k:
        raise ValueError(f"mmer_histograms: W={W} (max {MAX_ROW_WORDS}), "
                         f"m={m}, k={k}")
    histo = torch.zeros((4 ** m,), dtype=torch.int64, device=words.device)
    if B:
        _launch("bt_mmer_histograms", words.data_ptr(), lengths.data_ptr(), B,
                W, k, m, None if rank is None else rank.data_ptr(), int(load),
                histo.data_ptr())
        LAUNCHES["mmer_histograms"] += 1
    return histo


def route_buckets(stacked: torch.Tensor, valid: torch.Tensor,
                  owner: torch.Tensor, n_dev: int, cap: int,
                  with_slots: bool = False):
    """K15: (buckets (C, n_dev, cap), bucket_valid (n_dev, cap), n_dropped
    (1,)[, slots (N,)])."""
    _check(stacked, "stacked", ndim=2, rows_strided=True)
    _check(valid, "valid", dtype=torch.bool, ndim=1)
    _check(owner, "owner", ndim=1)
    C, N = stacked.shape
    if valid.shape[0] != N or owner.shape[0] != N or not 1 <= n_dev <= 256:
        raise ValueError("route_buckets: shapes do not match")
    dev = stacked.device
    buckets = torch.zeros((C, n_dev * cap), dtype=torch.int64, device=dev)
    bvalid = torch.zeros((n_dev * cap,), dtype=torch.bool, device=dev)
    dropped = torch.zeros((1,), dtype=torch.int64, device=dev)
    slots = (torch.empty((N,), dtype=torch.int64, device=dev)
             if with_slots else None)
    if N:
        tiles = -(-N // ROUTE_TILE)
        counts = torch.empty((tiles, n_dev), dtype=torch.int64, device=dev)
        _launch("bt_route_count", owner.data_ptr(), valid.data_ptr(), N, n_dev,
                counts.data_ptr())
        tile_off = torch.cumsum(counts, 0) - counts
        _launch("bt_route_place", stacked.data_ptr(), stacked.stride(0), C,
                owner.data_ptr(), valid.data_ptr(), N, n_dev, cap,
                tile_off.data_ptr(), buckets.data_ptr(), bvalid.data_ptr(),
                dropped.data_ptr(), None if slots is None else slots.data_ptr())
        LAUNCHES["route_buckets"] += 1
    out = (buckets.reshape(C, n_dev, cap), bvalid.reshape(n_dev, cap), dropped)
    return out + (slots,) if with_slots else out


def glue_compose(Q: torch.Tensor, anc: torch.Tensor, need: torch.Tensor):
    """K16: (Qn (M, 4), changed (1,) int32): rows that need a step composed
    with their fetched ancestor rows, the others copied."""
    _check(Q, "Q", ndim=2)
    _check(anc, "anc", ndim=2)
    _check(need, "need", dtype=torch.bool, ndim=1)
    M = Q.shape[0]
    if Q.shape != (M, 4) or anc.shape != (M, 4) or need.shape[0] != M:
        raise ValueError("glue_compose: expected two (M, 4) states and (M,) need")
    Qn = torch.empty_like(Q)
    changed = torch.zeros((1,), dtype=torch.int32, device=Q.device)
    if M:
        _launch("bt_glue_compose", Q.data_ptr(), anc.data_ptr(), need.data_ptr(),
                M, Qn.data_ptr(), changed.data_ptr())
        LAUNCHES["glue_compose"] += 1
    return Qn, changed
