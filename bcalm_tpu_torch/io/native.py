"""ctypes bridge to the native ingest library (bcalm_tpu_torch/native/ingest.cpp).

Builds lazily with g++ on first use, into ``bcalm_tpu_torch/build/
ingest-<hash>/libbcalmio.so`` (the hash covers the source, the flags and
the host's CPU flags, since -march=native builds for that CPU), if the
toolchain is available; falls back cleanly to the pure-python packer
(io.packing) when the shared library cannot be built/loaded.  The parser
runs on the host, never on the device.

Copy of ``bcalm_tpu/io/native.py`` with the imports pointed at this package
and its own build (the JAX package runs ``make -C native``): the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Iterator, Optional

import numpy as np

from bcalm_tpu_torch.io.packing import ReadBlock, BASES_PER_WORD

_PKG = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_SRC = os.path.join(_PKG, "native", "ingest.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _host_cpu() -> str:
    """The host's CPU feature flags, so that a library built on one host
    is not reused on another."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return ""


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_PKG, "build", f"ingest-{h.hexdigest()[:16]}",
                        "libbcalmio.so")


def _build(path: str) -> None:
    """g++ the parser into path (atomically: concurrent processes may
    build it at once)."""
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp, "-lz"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    _LIB_PATH = _lib_path()
    if not os.path.exists(_LIB_PATH):
        try:
            _build(_LIB_PATH)
        except (subprocess.SubprocessError, OSError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.btpu_open.restype = ctypes.c_void_p
    lib.btpu_open.argtypes = [ctypes.c_char_p]
    lib.btpu_next_block.restype = ctypes.c_long
    lib.btpu_next_block.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.btpu_close.argtypes = [ctypes.c_void_p]
    try:
        lib.btpu_open_mem.restype = ctypes.c_void_p
        lib.btpu_open_mem.argtypes = [ctypes.c_char_p, ctypes.c_long]
    except AttributeError:   # stale library without the mem entry point
        pass
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def iter_blocks_native(path: str, k: int, block_reads: int = 4096,
                       max_len: int = 512) -> Iterator[ReadBlock]:
    """Stream ReadBlocks from a sequence file via the native parser.

    Drop-in equivalent of packing.iter_blocks(Bank sequences) for a single
    file (same block layout and windowing semantics)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native ingest library unavailable")
    max_len = max(max_len, k, BASES_PER_WORD)
    width = (max_len + BASES_PER_WORD - 1) // BASES_PER_WORD

    handle = lib.btpu_open(path.encode())
    if not handle:
        raise IOError(f"cannot open sequence file: {path}")
    yield from _drain_handle(lib, handle, k, block_reads, width)


def _drain_handle(lib, handle, k, block_reads, width):
    try:
        while True:
            words = np.zeros((block_reads, width), dtype=np.uint32)
            lengths = np.zeros((block_reads,), dtype=np.int32)
            n = lib.btpu_next_block(
                handle, k, block_reads, width,
                words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            if n <= 0:
                break
            yield ReadBlock(words, lengths)
            if n < block_reads:
                break
    finally:
        lib.btpu_close(handle)


def mem_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "btpu_open_mem") \
        and lib.btpu_open_mem.restype is ctypes.c_void_p


def parse_chunk_native(chunk: bytes, k: int, block_reads: int = 4096,
                       max_len: int = 512):
    """Parse one record-aligned decompressed chunk into ReadBlocks (the
    worker body of the parallel single-file ingest; the ctypes call
    releases the GIL, so a thread pool scales)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native ingest library unavailable")
    max_len = max(max_len, k, BASES_PER_WORD)
    width = (max_len + BASES_PER_WORD - 1) // BASES_PER_WORD
    handle = lib.btpu_open_mem(chunk, len(chunk))
    if not handle:
        return []
    return list(_drain_handle(lib, handle, k, block_reads, width))
