"""The host emulation of the extension, SMEM, SA-walk, occ4,
global-alignment, local-SW and row-builder kernels.

``csrc/extend.cu``, ``csrc/smem.cu``, ``csrc/global.cu`` and
``csrc/align.cu`` are written against a team of lanes
(``csrc/team.cuh``); built by g++ instead of nvcc, each runs a thread
group's lanes as arrays in one CPU thread, with the shuffles and ballots
as loops.  ``csrc/extbuild.cu``, ``csrc/sa.cu`` and ``csrc/occ.cu`` are
plain per-thread code: their host entries run the kernel's threads in
turn.  The FM kernels take the index whole or split into parts
(ops/fm.py SplitTable), as on the card.  This module builds them (one shared
library per source under ``bwamem_tpu_torch/_build/host``, keyed by a
hash of the sources) and
calls their ``*_host`` entries on CPU arrays: the kernels' own algorithm
(the warp per seed or alignment, the group per read) on the CPU.  The
tests hold it against the plain versions; ``chip_smoke.py`` takes from
it the DP cells each seed's extension visits.  It is not a path of the
aligner.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ._kernels import BUILD_DIR, CSRC

HEADERS = ("team.cuh", "fm.cuh")
FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-Wno-unknown-pragmas",
         "-shared", "-fPIC")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "extend.cu": {
        "bm_extend_lr_host": [_I, _I, _I] + [_VP] * 9 + [_I] * 8
                             + [_VP] * 14,
        "bm_extend2_host": [_I, _I, _I] + [_VP] * 5 + [_I] * 4 + [_VP] * 2
                           + [_I] + [_VP] * 8},
    "smem.cu": {
        "bm_smem_superstep_host": [_VP, _I, _I64, _I64, _I64, _VP, _VP, _I]
                                  + [_VP] * 5 + [_I, _I, _I] + [_VP] * 6,
        "bm_smem_iter_step_host": [_VP, _I, _I64, _I64, _I64, _VP, _VP, _I]
                                  + [_VP] * 6 + [_I, _I, _I, _VP, _VP,
                                                 _VP]},
    "sa.cu": {
        "bm_sa_walk_host": [_VP, _I, _I64, _I64, _I64, _VP, _VP, _I64, _I,
                            _I64, _VP, _I, _I, _VP, _I, _VP]},
    "occ.cu": {
        "bm_gather_rows_host": [_VP, _I64, _I, _VP, _I64, _I, _VP],
        "bm_occ4_host": [_VP, _I, _I64, _I64, _I64, _VP, _I64, _VP],
        "bm_part_of_host": [_I64, _I, _VP, _I64, _VP, _VP]},
    "global.cu": {
        "bm_global2_host": [_I, _I, _I] + [_VP] * 6 + [_I] * 4 + [_VP] * 5},
    "align.cu": {
        "bm_align2_host": [_I, _I, _I, _I] + [_VP] * 6 + [_I] * 5
                          + [_VP] * 6},
    "extbuild.cu": {
        "bm_build_rows_host": [_VP, _I, _I, _VP, _I64, _I64] + [_VP] * 7
                              + [_I, _I, _I] + [_VP] * 4},
}
_libs = {}
_lock = threading.Lock()


def available() -> bool:
    """Whether g++ is there to build the emulation."""
    return shutil.which("g++") is not None


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        if source in _libs:
            return _libs[source]
        h = hashlib.sha256()
        for name in (source,) + HEADERS:
            h.update((CSRC / name).read_bytes())
        h.update(" ".join(FLAGS).encode())
        out = BUILD_DIR / "host"
        so = out / f"{source.split('.')[0]}_{h.hexdigest()[:16]}.so"
        if not so.exists():
            out.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run(["g++", *FLAGS, "-o", str(tmp),
                                  str(CSRC / source)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ {source} failed:\n{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[source] = lib
        return lib


def _np(t, dtype):
    """A contiguous host copy of a tensor or array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(t, dtype=dtype)


def _ptrs(arrays):
    return [a.ctypes.data for a in arrays]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} host emulation returned {rc}")


def _at(a, lo: int) -> int:
    """The address of row lo of a contiguous array."""
    return a.ctypes.data + lo * a.strides[0]


def _slices(B: int, threads: int, fn) -> None:
    """fn(lo, hi) over [0, B) in up to `threads` slices at once (ctypes
    lets go of the GIL during the call)."""
    n = max(1, min(threads, B))
    cuts = [B * k // n for k in range(n + 1)]
    if n == 1:
        fn(0, B)
        return
    with ThreadPoolExecutor(n) as ex:
        for f in [ex.submit(fn, lo, hi) for lo, hi in zip(cuts, cuts[1:])]:
            f.result()


def extend_lr(lq, lt, llq, llt, rq, rt, rlq, rlt, mat, o_del, e_del, o_ins,
              e_ins, w0, pc5, pc3, zdrop, sc_seed, s_qbeg, s_rbeg, rmax0,
              l_query, s_len, LQ: int, LT: int, threads: int = 1):
    """bm_extend_lr's warp per seed on the host; the arguments of
    ops/ksw.py extend_lr_plain, the seeds split over `threads` threads.
    Returns (its 8 outputs as CPU tensors, int64[B] DP cells each seed
    visited, retries included)."""
    i8, i32, i64 = np.int8, np.int32, np.int64
    B = len(llq)
    ins = [_np(a, dt) for a, dt in (
        (lq, i8), (lt, i8), (llq, i32), (llt, i32), (rq, i8), (rt, i8),
        (rlq, i32), (rlt, i32), (_np(mat, i8).reshape(-1), i8))]
    lane = [_np(a, dt) for a, dt in ((sc_seed, i32), (s_qbeg, i32),
                                     (s_rbeg, i64), (l_query, i32),
                                     (s_len, i32))]
    outs = [np.zeros(B, dt) for dt in (i32, i32, i32, i64, i32, i64, i32,
                                       i32)]
    cells = np.zeros(B, i64)
    lib = _library("extend.cu")

    def run(lo, hi):
        rc = lib.bm_extend_lr_host(
            LQ, LT, hi - lo, *(_at(a, lo) for a in ins[:8]),
            ins[8].ctypes.data, o_del, e_del, o_ins, e_ins, w0, pc5, pc3,
            zdrop, *(_at(a, lo) for a in lane), *(_at(a, lo) for a in outs),
            _at(cells, lo))
        _check(rc, "extend_lr")
    _slices(B, threads, run)
    return tuple(torch.from_numpy(o) for o in outs), cells


def extend2(query, target, qlen, tlen, mat, o_del, e_del, o_ins, e_ins, w,
            end_bonus, zdrop, h0, LQ: int, LT: int):
    """bm_extend2 on the host; the arguments of ops/ksw.py extend2_plain.
    Returns (its 6 outputs as CPU tensors, int64[B] DP cells visited)."""
    i8, i32 = np.int8, np.int32
    B = len(qlen)
    q, t, ql, tl, m = (_np(a, dt) for a, dt in (
        (query, i8), (target, i8), (qlen, i32), (tlen, i32),
        (_np(mat, i8).reshape(-1), i8)))
    wv, eb, hv = (_np(a, i32) for a in (w, end_bonus, h0))
    outs = [np.zeros(B, i32) for _ in range(6)]
    cells = np.zeros(B, np.int64)
    rc = _library("extend.cu").bm_extend2_host(
        LQ, LT, B, *_ptrs((q, t, ql, tl, m)), o_del, e_del, o_ins, e_ins,
        wv.ctypes.data, eb.ctypes.data, zdrop, hv.ctypes.data,
        *_ptrs(outs), cells.ctypes.data)
    _check(rc, "extend2")
    return tuple(torch.from_numpy(o) for o in outs), cells


def global2(query, target, qlen, tlen, mat, o_del, e_del, o_ins, e_ins, w,
            LQ: int, LT: int):
    """bm_global2's warp per lane on the host; the arguments and outputs
    of ops/ksw.py global_plain."""
    i8, i32 = np.int8, np.int32
    B = len(qlen)
    ins = [_np(a, dt) for a, dt in (
        (query, i8), (target, i8), (qlen, i32), (tlen, i32), (w, i32),
        (_np(mat, i8).reshape(-1), i8))]
    score, n_ops, rem_i, rem_k = (np.zeros(B, i32) for _ in range(4))
    ops = np.zeros((B, LT + LQ), np.uint8)
    rc = _library("global.cu").bm_global2_host(
        LQ, LT, B, *_ptrs(ins), o_del, e_del, o_ins, e_ins,
        *_ptrs((score, ops, n_ops, rem_i, rem_k)))
    _check(rc, "global2")
    return tuple(torch.from_numpy(a) for a in (score, ops, n_ops, rem_i,
                                               rem_k))


def align2(query, target, qlen, tlen, mat, o_del, e_del, o_ins, e_ins,
           endsc, shift: int, size: int, LQV: int, LT: int):
    """bm_align2's warp per lane on the host; the arguments and outputs of
    ops/ksw_align.py align_plain."""
    i8, i32 = np.int8, np.int32
    B = len(qlen)
    ins = [_np(a, dt) for a, dt in (
        (query, i8), (target, i8), (qlen, i32), (tlen, i32), (endsc, i32),
        (_np(mat, i8).reshape(-1), i8))]
    gmax, te, qe, last = (np.zeros(B, i32) for _ in range(4))
    sat = np.zeros(B, np.uint8)
    row_max = np.zeros((B, LT), i32)
    rc = _library("align.cu").bm_align2_host(
        size, LQV, LT, B, *_ptrs(ins), o_del, e_del, o_ins, e_ins, shift,
        *_ptrs((gmax, te, qe, sat, row_max, last)))
    _check(rc, "align2")
    T = torch.from_numpy
    return T(gmax), T(te), T(qe), T(sat).bool(), T(row_max), T(last)


def build_rows(reads_q, pac, l_pac: int, rid, qb0, slen, rb0, rmax0, rmax1,
               lquery, LQ: int, LT: int):
    """bm_build_rows' threads on the host, one after another; the
    arguments and outputs of ops/extbuild.py build_rows_plain (lq, lt,
    rq, rt)."""
    i32, i64 = np.int32, np.int64
    reads, pac = _np(reads_q, np.int8), _np(pac, np.uint8)
    lane = [_np(a, dt) for a, dt in ((rid, i32), (qb0, i32), (slen, i32),
                                     (rb0, i64), (rmax0, i64), (rmax1, i64),
                                     (lquery, i32))]
    B = len(lane[0])
    outs = [np.zeros((B, w // 2), np.int8) for w in (LQ, LT, LQ, LT)]
    rc = _library("extbuild.cu").bm_build_rows_host(
        reads.ctypes.data, reads.shape[0], reads.shape[1], pac.ctypes.data,
        len(pac), l_pac, *_ptrs(lane), LQ, LT, B, *_ptrs(outs))
    _check(rc, "build_rows")
    return tuple(torch.from_numpy(o) for o in outs)


def _table_args(table, dtype):
    """(host copies of a table's parts, the entries' three arguments for
    it: the parts' addresses, their count, the rows of each but the
    last); a whole table is one part, an ops/fm.py SplitTable its
    parts."""
    parts = getattr(table, "parts", None) or (table,)
    arrays = [_np(p, dtype) for p in parts]
    rows = table.rows if len(parts) > 1 else len(arrays[0])
    return arrays, ((ctypes.c_void_p * len(arrays))(*_ptrs(arrays)),
                    len(arrays), rows)


def _fm_args(dfm):
    """(the host copies to keep alive, the FM entries' first six
    arguments) of a DeviceFmIndex or SplitFmIndex."""
    blocks, occ = _table_args(dfm.blocks, np.int32)
    return blocks, (*occ, dfm.primary_int, dfm.seq_len_int,
                    dfm.L2_host.ctypes.data)


def superstep(dfm, q_pk, qlen, min_intv, active, split_len, split_width,
              L: int, M: int, OUT_CAP: int):
    """bm_smem_superstep's group per read on the host; the arguments and
    outputs of ops/smem.py superstep_cuda."""
    blocks, fm = _fm_args(dfm)
    B = q_pk.shape[0]
    args = [_np(a, dt) for a, dt in (
        (q_pk, np.int8), (qlen, np.int32), (min_intv, np.int64),
        (active, np.uint8), (split_len, np.int32), (split_width, np.int32))]
    o0, os_ = (np.zeros((B, OUT_CAP), np.int64) for _ in range(2))
    oqb, oqe = (np.zeros((B, OUT_CAP), np.int32) for _ in range(2))
    n_out = np.zeros(B, np.int32)
    over = np.zeros(B, np.uint8)
    rc = _library("smem.cu").bm_smem_superstep_host(
        *fm, args[0].ctypes.data, L, *_ptrs(args[1:]), M, OUT_CAP, B,
        *_ptrs((o0, os_, oqb, oqe, n_out, over)))
    _check(rc, "superstep")
    del blocks
    return (*(torch.from_numpy(a) for a in (o0, os_, oqb, oqe, n_out)),
            torch.from_numpy(over).bool())


def smem_iter_step(dfm, q_pk, qlen, x, min_intv, active, split_len,
                   split_width, L: int, M: int, M_OUT: int):
    """bm_smem_iter_step on the host; the arguments and outputs of
    ops/smem.py smem_iter_step_cuda."""
    blocks, fm = _fm_args(dfm)
    B = q_pk.shape[0]
    args = [_np(a, dt) for a, dt in (
        (q_pk, np.int8), (qlen, np.int32), (x, np.int32),
        (min_intv, np.int64), (active, np.uint8), (split_len, np.int32),
        (split_width, np.int32))]

    def pass_out():
        return ([np.zeros(B, np.int32) for _ in range(2)]
                + [np.zeros((B, M_OUT), np.int64) for _ in range(3)]
                + [np.zeros((B, M_OUT), np.int32) for _ in range(2)]
                + [np.zeros(B, np.uint8)])
    o1, o2 = pass_out(), pass_out()
    need2 = np.zeros(B, np.uint8)
    p1, p2 = ((ctypes.c_void_p * 8)(*_ptrs(o)) for o in (o1, o2))
    rc = _library("smem.cu").bm_smem_iter_step_host(
        *fm, args[0].ctypes.data, L, *_ptrs(args[1:]), M, M_OUT, B, p1,
        need2.ctypes.data, p2)
    _check(rc, "smem_iter_step")
    del blocks
    T = torch.from_numpy
    return (*(T(a) for a in o1[:7]), T(o1[7]).bool(), T(need2).bool(),
            *(T(a) for a in o2[:7]), T(o2[7]).bool())


def sa_walk(dfm, keys, max_steps: int):
    """bm_sa_walk's threads on the host, one key after another; the
    arguments and outputs of ops/fm.py sa_walk_cuda."""
    blocks, fm = _fm_args(dfm)
    sa_dt = np.int64 if dfm.sa.dtype == torch.int64 else np.int32
    sa, (sa_arg, _, sa_rows) = _table_args(dfm.sa, sa_dt)
    k = _np(keys, np.int64)
    n = len(k)
    is64 = dfm.cdt == torch.int64
    vals = np.zeros(n, np.int64 if is64 else np.int32)
    over = np.zeros(n, np.uint8)
    rc = _library("sa.cu").bm_sa_walk_host(
        *fm, sa_arg, sa_rows, int(sa_dt == np.int64), dfm.sa_intv,
        k.ctypes.data, n, max_steps, vals.ctypes.data, int(is64),
        over.ctypes.data)
    _check(rc, "sa_walk")
    del blocks, sa
    return torch.from_numpy(vals), torch.from_numpy(over).bool()


def gather_rows(table, ids, transpose: bool = False):
    """bm_gather_rows's warps on the host; the arguments and outputs of
    ops/occ.py gather_rows_cuda.  The host arrays are 16-byte aligned
    where the card's allocations are (numpy's are), so the emulation
    takes the vector warps where the card does."""
    t = _np(table, np.int32)
    k = _np(ids, np.int64).reshape(-1)
    n, W = len(k), t.shape[1]
    out = np.zeros((W, n) if transpose else (n, W), np.int32)
    rc = _library("occ.cu").bm_gather_rows_host(
        t.ctypes.data, t.shape[0], W, k.ctypes.data, n, int(transpose),
        out.ctypes.data)
    _check(rc, "gather_rows")
    out = torch.from_numpy(out)
    return out if transpose else out.reshape(*np.shape(ids), W)


def occ4(blocks, primary: int, keys):
    """bm_occ4's groups of 4 lanes on the host; the arguments and outputs
    of ops/occ.py occ4_cuda."""
    arrays, occ = _table_args(blocks, np.int32)
    k = _np(keys, np.int64)
    out = np.zeros((len(k), 4), np.int64)
    rc = _library("occ.cu").bm_occ4_host(
        *occ, blocks.shape[0], primary, k.ctypes.data, len(k),
        out.ctypes.data)
    _check(rc, "occ4")
    del arrays
    return torch.from_numpy(out).reshape(*np.shape(keys), 4)


def part_of(rows: int, n_parts: int, r):
    """The split kernels' part lookup (csrc/fm.cuh row_at) on the host:
    (part int32, offset int64) of each row id in r, for a table cut into
    n_parts parts of `rows` rows."""
    ids = _np(r, np.uint64)
    part = np.zeros(len(ids), np.int32)
    off = np.zeros(len(ids), np.int64)
    rc = _library("occ.cu").bm_part_of_host(
        rows, n_parts, ids.ctypes.data, len(ids), part.ctypes.data,
        off.ctypes.data)
    _check(rc, "part_of")
    return part, off
