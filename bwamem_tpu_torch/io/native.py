"""ctypes binding to the native host runtime (native/bwamem_native.cpp).

Builds the shared library on first use when a compiler is available;
callers fall back to the pure-Python reader when it isn't.  The C ABI is
used directly (no pybind11 in this environment).
"""

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbwamem_native.so")

_lib = None
_lib_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.bm_fq_open.restype = ctypes.c_void_p
        lib.bm_fq_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        PPC = ctypes.POINTER(ctypes.POINTER(ctypes.c_char_p))
        lib.bm_fq_chunk.restype = ctypes.c_int64
        lib.bm_fq_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    PPC, PPC, PPC, PPC,
                                    ctypes.POINTER(ctypes.c_int)]
        lib.bm_fq_close.restype = None
        lib.bm_fq_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeChunkReader:
    """Drop-in replacement for io.fastq.ChunkReader backed by the C++
    kseq/bseq_read equivalent."""

    def __init__(self, path1: str, path2: Optional[str] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.bm_fq_open(path1.encode(), (path2 or "").encode())
        if not self._h:
            raise FileNotFoundError(path2 if path2 and not
                                    os.path.exists(path2) else path1)

    def read_chunk(self, chunk_size: int) -> List:
        from .fastq import Read
        PC = ctypes.POINTER(ctypes.c_char_p)
        names, comments = PC(), PC()
        seqs, quals = PC(), PC()
        short = ctypes.c_int(0)
        n = self._lib.bm_fq_chunk(
            self._h, chunk_size,
            ctypes.byref(names), ctypes.byref(comments),
            ctypes.byref(seqs), ctypes.byref(quals), ctypes.byref(short))
        if short.value:
            print("[W::bseq_read] the 2nd file has fewer sequences.",
                  file=sys.stderr)
        out = []
        for i in range(n):
            out.append(Read(
                name=names[i].decode(),
                comment=(comments[i].decode()
                         if comments[i] is not None else None),
                seq=seqs[i].decode(),
                qual=quals[i].decode() if quals[i] is not None else None))
        return out

    def close(self):
        if self._h:
            self._lib.bm_fq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_chunk_reader(path1: str, path2: Optional[str] = None):
    """Prefer the native reader; fall back to pure Python."""
    if path1 != "-" and not path1.endswith((".bam",)):
        try:
            return NativeChunkReader(path1, path2)
        except (RuntimeError, FileNotFoundError):
            pass
    from .fastq import ChunkReader
    return ChunkReader(path1, path2)
