"""ctypes binding to the native host-oracle SMEM search + SA walk
(native/hostsmem.cpp).  The reference's CPU fallback is C
(software/bwt.c:299-414); this gives our fallback paths (oversize
reads, interval-buffer overflow lanes, straggler tails) the same
C-speed floor instead of the pure-Python oracle's ~40 ms/read.

oracle.smem.smem1 and the seeding fallbacks dispatch here when the
library is available; the Python implementations remain the executable
spec and the parity oracle (tests/test_native_hostsmem.py fuzzes
native vs Python)."""

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbwamem_native.so")

_lib = None
_lib_lock = threading.Lock()

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True, timeout=300)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.bt_smem1.restype = ctypes.c_int32
        except (OSError, AttributeError):
            try:  # stale .so predating hostsmem.cpp: rebuild once
                subprocess.run(["make", "-C", _NATIVE_DIR, "-B"],
                               check=True, capture_output=True,
                               timeout=300)
                lib = ctypes.CDLL(_SO_PATH)
            except Exception:
                return None
        lib.bt_smem1.restype = ctypes.c_int32
        lib.bt_smem1.argtypes = [
            _u32p, ctypes.c_int64, _i64p, ctypes.c_int64,
            _u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            _i64p, ctypes.POINTER(ctypes.c_int32)]
        lib.bt_sa_lookup_batch.restype = None
        lib.bt_sa_lookup_batch.argtypes = [
            _u32p, ctypes.c_int64, _i64p, ctypes.c_int64,
            _i64p, ctypes.c_int64, _i64p, ctypes.c_int64, _i64p]
        lib.bt_sa_lookup_batch32.restype = None
        lib.bt_sa_lookup_batch32.argtypes = [
            _u32p, ctypes.c_int64, _i64p, ctypes.c_int64,
            _i32p, ctypes.c_int64, _i64p, ctypes.c_int64, _i64p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fm_ok(fm) -> bool:
    """Duck-type gate: the native path needs a host FmIndex with the
    occ-interleaved uint32 array in memory."""
    b = getattr(fm, "bwt", None)
    return (isinstance(b, np.ndarray) and b.dtype == np.uint32
            and b.flags.c_contiguous)


def smem1_native(fm, q, x: int, min_intv: int):
    """Native smem1; returns (ret, [(x0, x1, s, info), ...]) exactly
    like oracle.smem.smem1, or None when unavailable."""
    lib = _load()
    if lib is None or not _fm_ok(fm):
        return None
    qa = np.ascontiguousarray(q, dtype=np.uint8)
    qlen = len(qa)
    out = np.empty(4 * (qlen + 1), dtype=np.int64)
    ret = ctypes.c_int32(0)
    L2 = np.ascontiguousarray(fm.L2, dtype=np.int64)
    n = lib.bt_smem1(fm.bwt, int(fm.primary), L2, int(fm.seq_len),
                     qa, qlen, int(x), int(min_intv), out,
                     ctypes.byref(ret))
    rows = out[:4 * n].reshape(n, 4).tolist()
    return int(ret.value), [tuple(r) for r in rows]


def sa_lookup_batch_native(fm, keys) -> Optional[np.ndarray]:
    """Native bwt_sa for a batch of rows; returns int64 values or None
    when unavailable."""
    lib = _load()
    if lib is None or not _fm_ok(fm) or fm.sa is None:
        return None
    ks = np.ascontiguousarray(keys, dtype=np.int64)
    out = np.empty(len(ks), dtype=np.int64)
    L2 = np.ascontiguousarray(fm.L2, dtype=np.int64)
    sa = fm.sa
    if sa.dtype == np.int32 and sa.flags.c_contiguous:
        lib.bt_sa_lookup_batch32(fm.bwt, int(fm.primary), L2,
                                 int(fm.seq_len), sa, int(fm.sa_intv),
                                 ks, len(ks), out)
    else:
        sa64 = (sa if sa.dtype == np.int64 and sa.flags.c_contiguous
                else np.ascontiguousarray(sa, dtype=np.int64))
        lib.bt_sa_lookup_batch(fm.bwt, int(fm.primary), L2,
                               int(fm.seq_len), sa64, int(fm.sa_intv),
                               ks, len(ks), out)
    return out
