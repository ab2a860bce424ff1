"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a into one shared library with
a plain C interface, loaded with ctypes.  The build happens at first use,
into ``bcalm_tpu_torch/build/<hash of the sources>/``; a missing nvcc or a
failed build raises with the compiler's output.  Nothing here is imported
or built when the module is imported.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch, launches on the current stream, raises when the C
function returns a CUDA error, and adds one to its entry in ``LAUNCHES``
each time it launches its kernel(s).  The plain PyTorch versions live beside the
callers in ops/{extract,count,junctions,chains,runchains}.py; these wrappers never
fall back to them.
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
              "-shared", "-Xcompiler", "-fPIC"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"extract_insert": 0, "count_runs": 0, "junction_keys": 0,
            "junction_pairs": 0, "jump_round": 0, "range_fold": 0,
            "lower_bound": 0, "solid_fold_histogram": 0, "run_scans": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_SIGNATURES = {
    "bt_extract_insert": [_P, _I64, _P, _P, _I32, _I32, _I32, _I32, _I32,
                          ctypes.c_uint, _I64, _P],
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
    "bt_run_scans": [_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P],
}
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


def build(build_dir: Path | None = None) -> Path:
    """Compile csrc/*.cu into <build_dir>/<source hash>/libbtkernels.so
    (reused when it exists) and return its path."""
    out_dir = Path(build_dir or BUILD_DIR) / source_hash()
    lib_path = out_dir / "libbtkernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building the "
            f"bcalm_tpu_torch kernels:\n{proc.stderr}")
    os.replace(tmp, lib_path)
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
                   offset: int) -> None:
    """K1: write the folded (L+1, B*P_eff) extraction of a packed block into
    buf[:, offset:offset + B*P_eff] (in place)."""
    _check(buf, "buf", ndim=2)
    _check(words, "words", ndim=2)
    _check(lengths, "lengths", ndim=1)
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
            k, L, slot_base, offset)
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


def run_scans(succ: torch.Tensor, n_solid: int, C: int):
    """K8 on the (>= C,) successor array: (is_head, is_tail, rid, head_pos,
    end_pos, R (1,)) over [0, C)."""
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
        _launch("bt_run_scans", succ.data_ptr(), C, n_solid,
                scratch.data_ptr(), is_head.data_ptr(), is_tail.data_ptr(),
                rid.data_ptr(), head_pos.data_ptr(), end_pos.data_ptr(),
                R.data_ptr())
        LAUNCHES["run_scans"] += 1
    return is_head, is_tail, rid, head_pos, end_pos, R
