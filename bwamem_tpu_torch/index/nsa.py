"""ctypes binding to the native bounded-memory index builder
(native/saindex.cpp): SA-IS suffix array, BWT emission, and occ
interleaving.  ~4.5 bytes/char peak vs ~50 for the NumPy
prefix-doubling path — the large-genome construction role the
reference fills with software/bwt_gen.c (bwtindex.c:239).

Callers fall back to the NumPy path when no compiler is available.
"""

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbwamem_native.so")

_lib = None
_lib_lock = threading.Lock()

_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")


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
            lib.bt_sais_bases_32.restype = ctypes.c_int
        except (OSError, AttributeError):
            # present but stale (predates saindex.cpp): rebuild once
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR, "-B"],
                               check=True, capture_output=True, timeout=300)
                lib = ctypes.CDLL(_SO_PATH)
            except Exception:
                return None
        lib.bt_sais_bases_32.restype = ctypes.c_int
        lib.bt_sais_bases_32.argtypes = [_u8p, ctypes.c_int32, _i32p]
        lib.bt_sais_bases_64.restype = ctypes.c_int
        lib.bt_sais_bases_64.argtypes = [_u8p, ctypes.c_int64, _i64p]
        lib.bt_bwt_from_sa32.restype = ctypes.c_int64
        lib.bt_bwt_from_sa32.argtypes = [_u8p, _i32p, ctypes.c_int64, _u8p]
        lib.bt_bwt_from_sa64.restype = ctypes.c_int64
        lib.bt_bwt_from_sa64.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p]
        lib.bt_interleave_occ.restype = ctypes.c_int64
        lib.bt_interleave_occ.argtypes = [_u8p, ctypes.c_int64, _u32p,
                                          ctypes.c_int64]
        try:
            lib.bti_build_bwt.restype = ctypes.c_int64
            lib.bti_build_bwt.argtypes = [_u8p, ctypes.c_int64,
                                          ctypes.c_int64, _u32p,
                                          ctypes.c_int64]
            lib.bti_sa_walk.restype = ctypes.c_int64
            lib.bti_sa_walk.argtypes = [_u32p, ctypes.c_int64,
                                        ctypes.c_int64, _i64p, _i64p,
                                        ctypes.c_int64]
        except AttributeError:
            # stale .so predating bwtinc.cpp: rebuild once
            subprocess.run(["make", "-C", _NATIVE_DIR, "-B"],
                           check=True, capture_output=True, timeout=300)
            lib = ctypes.CDLL(_SO_PATH)
            return _load_retry(lib)
        _lib = lib
        return _lib


def _load_retry(lib):
    global _lib
    for name, res, args in [
            ("bt_sais_bases_32", ctypes.c_int, [_u8p, ctypes.c_int32, _i32p]),
            ("bt_sais_bases_64", ctypes.c_int, [_u8p, ctypes.c_int64, _i64p]),
            ("bt_bwt_from_sa32", ctypes.c_int64, [_u8p, _i32p, ctypes.c_int64, _u8p]),
            ("bt_bwt_from_sa64", ctypes.c_int64, [_u8p, _i64p, ctypes.c_int64, _u8p]),
            ("bt_interleave_occ", ctypes.c_int64, [_u8p, ctypes.c_int64, _u32p, ctypes.c_int64]),
            ("bti_build_bwt", ctypes.c_int64, [_u8p, ctypes.c_int64, ctypes.c_int64, _u32p, ctypes.c_int64]),
            ("bti_sa_walk", ctypes.c_int64, [_u32p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64]),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _force_i64() -> bool:
    """Test hook (mirrors ops.fm's BWAMEM_TPU_FORCE_I64): route small
    texts through the int64 SA-IS entry points so the width human-scale
    construction needs is fuzz-tested without a >2^31-char text."""
    return bool(os.environ.get("BWAMEM_TPU_NSA_FORCE_I64"))


def suffix_array_native(bases: np.ndarray) -> np.ndarray:
    """Suffix array of `bases` (uint8 values 0..3) including the
    sentinel row: length n+1 with SA[0] == n — same convention as
    suffix_array.suffix_array.  int32 when the text fits, else int64."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native index builder unavailable")
    n = int(len(bases))
    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    # the +1 alphabet shift and the sentinel live in the C++ accessor
    # (no n-byte text copy — at Gbp scale that is 2 GB of peak RSS)
    if n + 1 <= np.iinfo(np.int32).max and not _force_i64():
        sa = np.empty(n + 1, dtype=np.int32)
        rc = lib.bt_sais_bases_32(bases, n, sa)
    else:
        sa = np.empty(n + 1, dtype=np.int64)
        rc = lib.bt_sais_bases_64(bases, n, sa)
    if rc != 0:
        raise RuntimeError("bt_sais failed")
    return sa


def bwt_from_sa(bases: np.ndarray, sa: np.ndarray) -> Tuple[np.ndarray, int]:
    """(bwt_str, primary) from the text and its full SA (one pass,
    no n-sized temporaries beyond the output)."""
    lib = _load()
    n = int(len(bases))
    bwt = np.empty(n, dtype=np.uint8)
    if sa.dtype == np.int32:
        primary = lib.bt_bwt_from_sa32(bases, sa, n, bwt)
    else:
        primary = lib.bt_bwt_from_sa64(bases, np.ascontiguousarray(
            sa, dtype=np.int64), n, bwt)
    if primary < 0:
        raise RuntimeError("bt_bwt_from_sa: no rank-0 suffix")
    return bwt, int(primary)


def interleave_occ_native(bwt_str: np.ndarray, n: int) -> np.ndarray:
    lib = _load()
    n_words = (n + 15) >> 4
    n_blocks = (n + 127) >> 7
    out = np.empty(n_words + (n_blocks + 1) * 8, dtype=np.uint32)
    wrote = lib.bt_interleave_occ(bwt_str, n, out, len(out))
    if wrote != len(out):
        raise RuntimeError("bt_interleave_occ: size mismatch")
    return out


def streaming_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "bti_build_bwt")


def build_bwt_streaming(pac: np.ndarray, l_pac: int,
                        block_chars: int = 1 << 27):
    """Interleaved BWT of the doubled (fwd + revcomp) text straight
    from the forward .pac bytes, built incrementally in bounded memory
    (native/bwtinc.cpp — the software/bwt_gen.c role).  Returns
    (interleaved uint32 array, primary).  Peak transient: one extra
    interleaved buffer (0.5 B/char) + ~24 B per block char."""
    lib = _load()
    if lib is None or not hasattr(lib, "bti_build_bwt"):
        raise RuntimeError("streaming builder unavailable")
    n = 2 * int(l_pac)
    out_len = ((n + 15) >> 4) + (((n + 127) >> 7) + 1) * 8
    out = np.empty(out_len, dtype=np.uint32)
    pac = np.ascontiguousarray(pac, dtype=np.uint8)
    primary = lib.bti_build_bwt(pac, l_pac, block_chars, out, out_len)
    if primary < 0:
        raise RuntimeError(f"bti_build_bwt failed ({primary})")
    return out, int(primary)


def sa_walk_streaming(interleaved: np.ndarray, n: int, primary: int,
                      L2: np.ndarray) -> np.ndarray:
    """Dense SA sample (interval 8) via the inverse-Psi walk over a
    finished interleaved BWT (bwt_cal_sa's role, software/bwt.c:80-102):
    sa8[k] = SA[8k], sa8[0] = -1."""
    lib = _load()
    n_sa8 = (n + 8) // 8
    sa8 = np.empty(n_sa8, dtype=np.int64)
    cnt = np.ascontiguousarray(L2[:5], dtype=np.int64)
    rc = lib.bti_sa_walk(np.ascontiguousarray(interleaved,
                                              dtype=np.uint32),
                         n, primary, cnt, sa8, n_sa8)
    if rc != 0:
        raise RuntimeError(f"bti_sa_walk failed ({rc})")
    return sa8
