"""ctypes binding to the native scalar SW kernels (native/ksw.cpp).

The native kernels are bit-identical to the pure-Python oracles in
oracle/ksw.py (the behavioral spec); oracle/ksw.py delegates here when
the shared library is available.  BWAMEM_TPU_NATIVE_KSW=0 forces the
pure-Python path (used by the parity tests, which compare the two).
"""

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbwamem_native.so")

_lib = None
_lib_lock = threading.Lock()
_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get("BWAMEM_TPU_NATIVE_KSW", "1") == "0":
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        # make is a no-op when the library is current, and rebuilds it
        # when a native source changed (the io loader only builds when
        # the .so is missing entirely)
        import subprocess
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            if not os.path.exists(_SO_PATH):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.bm_ksw_extend2.restype = None
            lib.bm_ksw_extend2.argtypes = [
                ctypes.c_int, _U8P, ctypes.c_int, _U8P, _I8P,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _I32P]
            lib.bm_ksw_global2.restype = ctypes.c_int32
            lib.bm_ksw_global2.argtypes = [
                ctypes.c_int, _U8P, ctypes.c_int, _U8P, _I8P,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, _U32P, _I32P]
            lib.bm_ksw_align2.restype = None
            lib.bm_ksw_align2.argtypes = [
                ctypes.c_int, _U8P, ctypes.c_int, _U8P, _I8P,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _I32P]
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _mat_i8(mat: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(mat).reshape(-1), dtype=np.int8)


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


def ksw_extend2(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                end_bonus, zdrop, h0) -> Tuple[int, int, int, int, int, int]:
    lib = _load()
    q, t, m = _u8(query), _u8(target), _mat_i8(mat)
    out = np.zeros(6, dtype=np.int32)
    lib.bm_ksw_extend2(len(q), _ptr(q, _U8P), len(t), _ptr(t, _U8P),
                       _ptr(m, _I8P), int(o_del), int(e_del), int(o_ins),
                       int(e_ins), int(w), int(end_bonus), int(zdrop),
                       int(h0), _ptr(out, _I32P))
    o = out.tolist()
    return o[0], o[1], o[2], o[3], o[4], o[5]


def ksw_global2(query, target, mat, o_del, e_del, o_ins, e_ins, w,
                want_cigar: bool = True) -> Tuple[int, List[int]]:
    lib = _load()
    q, t, m = _u8(query), _u8(target), _mat_i8(mat)
    cap = len(q) + len(t) + 4
    cig = np.zeros(cap, dtype=np.uint32)
    n = np.zeros(1, dtype=np.int32)
    score = lib.bm_ksw_global2(len(q), _ptr(q, _U8P), len(t), _ptr(t, _U8P),
                               _ptr(m, _I8P), int(o_del), int(e_del),
                               int(o_ins), int(e_ins), int(w),
                               1 if want_cigar else 0, _ptr(cig, _U32P),
                               _ptr(n, _I32P))
    return int(score), cig[:int(n[0])].tolist() if want_cigar else []


def ksw_align2(query, target, mat, o_del, e_del, o_ins, e_ins, xtra):
    from .ksw import KswR
    lib = _load()
    q, t, m = _u8(query), _u8(target), _mat_i8(mat)
    out = np.zeros(7, dtype=np.int32)
    lib.bm_ksw_align2(len(q), _ptr(q, _U8P), len(t), _ptr(t, _U8P),
                      _ptr(m, _I8P), int(o_del), int(e_del), int(o_ins),
                      int(e_ins), int(xtra), _ptr(out, _I32P))
    o = out.tolist()
    return KswR(score=o[0], te=o[1], qe=o[2], score2=o[3], te2=o[4],
                tb=o[5], qb=o[6])
