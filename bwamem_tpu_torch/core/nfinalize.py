"""ctypes binding to the native single-end finalize (native/finalize.cpp).

Packs a whole chunk's reads + alignment regions into flat arrays, makes
ONE native call, and slices the returned SAM text back onto the reads.
Byte-identical to the Python finalize path (mark_primary +
reg2sam_se_gen + aln2sam); BWAMEM_TPU_NATIVE_FINALIZE=0 forces Python.

The banded global realignments of mem_reg2aln run inside the native
call (scalar, ~50us each) instead of as device waves: the device keeps
the heavy seeding/SMEM/extension stages, the host finalizes — the
reference's own accelerator/CPU split (SURVEY.md §1).
"""

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbwamem_native.so")

_lib = None
_lib_lock = threading.Lock()

_I8P = ctypes.POINTER(ctypes.c_int8)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def switched_off() -> bool:
    """BWAMEM_TPU_NATIVE_FINALIZE=0, read at every call: the library is
    neither built nor used, even once loaded."""
    return os.environ.get("BWAMEM_TPU_NATIVE_FINALIZE", "1") == "0"


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if switched_off():
        return None
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        import subprocess
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            if not os.path.exists(_SO_PATH):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
            lib.bm_finalize_se.restype = ctypes.c_void_p
            lib.bm_finalize_se.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, _I8P,
                ctypes.c_int64, _U8P, ctypes.c_int32, _I64P, _I32P,
                ctypes.c_char_p,
                ctypes.c_int32, ctypes.c_int64, _U8P, _I64P,
                ctypes.c_char_p, _I64P, ctypes.c_char_p, _I64P,
                ctypes.c_char_p, _I64P, ctypes.c_char_p,
                _I64P, _I64P, _I64P, _I32P, _I32P, _I32P, _I32P, _I32P,
                _I32P, _I32P,
                _I64P, _I64P]
            lib.bm_free.restype = None
            lib.bm_free.argtypes = [ctypes.c_void_p]
            _DP = ctypes.POINTER(ctypes.c_double)
            lib.bm_finalize_pe.restype = ctypes.c_void_p
            lib.bm_finalize_pe.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, _I8P, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_double,
                _I64P, _I64P, _I32P, _DP, _DP,
                ctypes.c_int64, _U8P, ctypes.c_int32, _I64P, _I32P,
                ctypes.c_char_p,
                ctypes.c_int32, ctypes.c_int64, _U8P, _I64P,
                ctypes.c_char_p, _I64P, ctypes.c_char_p, _I64P,
                ctypes.c_char_p, _I64P, ctypes.c_char_p,
                _I64P, _I64P, _I64P, _I32P, _I32P, _I32P, _I32P, _I32P,
                _I32P, _I32P,
                _I64P, _I64P]
            lib.bm_chain_batch.restype = ctypes.c_int64
            lib.bm_chain_batch.argtypes = [
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, _I64P, _I64P, _I32P, _I32P,
                _I64P, _I64P, _I64P, _I32P, _I32P]
            lib.bm_pack_extlr.restype = None
            lib.bm_pack_extlr.argtypes = [
                _I8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, _U8P,
                _U8P, _I64P,
                ctypes.c_int64, _I32P, _I64P, _I64P, _I32P, _I32P,
                _U8P, _I32P,
                _I32P, _I32P, _I32P, _I32P,
                _I32P, _I32P, _I64P, _I64P, _I32P, _I32P,
                _I8P, _I8P, _I8P, _I8P,
                _I32P, _I32P, _I32P, _I64P, _I32P, _I64P, _I32P, _I32P]
            lib.bm_regions_batch.restype = ctypes.c_int64
            lib.bm_regions_batch.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_double, ctypes.c_double, ctypes.c_double, _I8P,
                ctypes.c_int64, _U8P,
                ctypes.c_int32, _U8P, _I64P,
                _I64P, _I64P, _I64P, _I32P, _I32P,
                _I32P, _I32P, _I32P, _I64P, _I32P, _I64P, _I32P, _I32P,
                ctypes.c_int64, _I64P, _I64P, _I64P, _I32P, _I32P, _I32P,
                _I32P, _I32P, _I32P, _I32P]
        except (OSError, AttributeError):
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


_bns_cache = {}


def _pack_bns(bns):
    """Cache the per-genome annotation arrays (one live genome)."""
    ent = _bns_cache.get(id(bns))
    if ent is not None and ent[0] is bns:
        return ent[1]
    ann_off = np.asarray([a.offset for a in bns.anns], dtype=np.int64)
    ann_len = np.asarray([a.length for a in bns.anns], dtype=np.int32)
    ann_names = b"".join(a.name.encode("latin1") + b"\0" for a in bns.anns)
    pac = np.ascontiguousarray(bns.pac, dtype=np.uint8)
    _bns_cache.clear()
    _bns_cache[id(bns)] = (bns, (ann_off, ann_len, ann_names, pac))
    return ann_off, ann_len, ann_names, pac


def _concat_strs(items: List[str]):
    """NUL-terminated concatenation + int64 start offsets."""
    off = np.zeros(len(items) + 1, dtype=np.int64)
    parts = []
    pos = 0
    for i, s in enumerate(items):
        b = s.encode("latin1") + b"\0"
        parts.append(b)
        off[i] = pos
        pos += len(b)
    off[len(items)] = pos
    return b"".join(parts), off


def _pack_chunk(reads, regs):
    """Flatten a chunk's reads + regions into the native-call arrays.
    Regions already flat (FlatRegs from the native region builder) pass
    through without materializing AlnReg objects."""
    n = len(reads)
    seqs, seq_off = pack_seqs(reads)

    names, name_off = _concat_strs([r.name for r in reads])
    quals, qual_off = _concat_strs([r.qual or "" for r in reads])
    comms, comm_off = _concat_strs([r.comment or "" for r in reads])

    if isinstance(regs, FlatRegs):
        (reg_off, rb, re_, qb, qe, sc, ts, cs, wv, sv) = regs.arrays
        return (seqs, seq_off, names, name_off, quals, qual_off, comms,
                comm_off, np.ascontiguousarray(reg_off, np.int64), rb,
                re_, qb, qe, sc, ts, cs, wv, sv)

    n_regs = sum(len(g) for g in regs)
    reg_off = np.zeros(n + 1, dtype=np.int64)
    rb = np.zeros(n_regs, dtype=np.int64)
    re_ = np.zeros(n_regs, dtype=np.int64)
    qb = np.zeros(n_regs, dtype=np.int32)
    qe = np.zeros(n_regs, dtype=np.int32)
    sc = np.zeros(n_regs, dtype=np.int32)
    ts = np.zeros(n_regs, dtype=np.int32)
    cs = np.zeros(n_regs, dtype=np.int32)
    wv = np.zeros(n_regs, dtype=np.int32)
    sv = np.zeros(n_regs, dtype=np.int32)
    k = 0
    for i, g in enumerate(regs):
        for p in g:
            rb[k], re_[k] = p.rb, p.re
            qb[k], qe[k] = p.qb, p.qe
            sc[k], ts[k], cs[k] = p.score, p.truesc, p.csub
            wv[k], sv[k] = p.w, p.seedcov
            k += 1
        reg_off[i + 1] = k
    return (seqs, seq_off, names, name_off, quals, qual_off, comms,
            comm_off, reg_off, rb, re_, qb, qe, sc, ts, cs, wv, sv)


def _common_args(opt, bns, packed, n, n_processed, rg_id):
    ann_off, ann_len, ann_names, pac = _pack_bns(bns)
    (seqs, seq_off, names, name_off, quals, qual_off, comms, comm_off,
     reg_off, rb, re_, qb, qe, sc, ts, cs, wv, sv) = packed
    return (
        [bns.l_pac, _ptr(pac, _U8P), len(bns.anns),
         _ptr(ann_off, _I64P), _ptr(ann_len, _I32P), ann_names,
         n, n_processed, _ptr(seqs, _U8P), _ptr(seq_off, _I64P),
         names, _ptr(name_off, _I64P), quals, _ptr(qual_off, _I64P),
         comms, _ptr(comm_off, _I64P), rg_id.encode("latin1"),
         _ptr(reg_off, _I64P), _ptr(rb, _I64P), _ptr(re_, _I64P),
         _ptr(qb, _I32P), _ptr(qe, _I32P), _ptr(sc, _I32P),
         _ptr(ts, _I32P), _ptr(cs, _I32P), _ptr(wv, _I32P),
         _ptr(sv, _I32P)])


def _collect(lib, ptr, rec_off, total, reads) -> bool:
    if not ptr:
        return False
    try:
        blob = ctypes.string_at(ptr, int(total[0]))
    finally:
        lib.bm_free(ptr)
    text = blob.decode("latin1")
    for i, r in enumerate(reads):
        r.sam = text[int(rec_off[i]):int(rec_off[i + 1])]
    return True


def finalize_se_native(opt, bns, reads, regs: List[list],
                       n_processed: int, rg_id: str) -> bool:
    """Run the whole chunk's SE finalize natively; sets read.sam.
    Returns False when unavailable or when the native path bails
    (caller must then run the Python finalize)."""
    lib = _load()
    if lib is None:
        return False
    n = len(reads)
    packed = _pack_chunk(reads, regs)
    mat = np.ascontiguousarray(np.asarray(opt.mat).reshape(-1),
                               dtype=np.int8)
    rec_off = np.zeros(n + 1, dtype=np.int64)
    total = np.zeros(1, dtype=np.int64)
    args = [opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.w, opt.T, opt.flag, opt.min_seed_len,
            float(opt.mask_level), float(opt.mapQ_coef_len),
            float(opt.mapQ_coef_fac), _ptr(mat, _I8P)]
    args += _common_args(opt, bns, packed, n, n_processed, rg_id)
    args += [_ptr(rec_off, _I64P), _ptr(total, _I64P)]
    ptr = lib.bm_finalize_se(*args)
    return _collect(lib, ptr, rec_off, total, reads)


def chain_batch_native(l_pac: int, w: int, max_chain_gap: int,
                       n_reads: int, read_off, rbeg, qbeg, slen):
    """Native kbtree-insertion chaining over a chunk's flat seed
    arrays; returns (chain_off, seed_off, rbeg, qbeg, len) flat arrays
    or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n_seeds = len(rbeg)
    read_off = np.ascontiguousarray(read_off, dtype=np.int64)
    rbeg = np.ascontiguousarray(rbeg, dtype=np.int64)
    qbeg = np.ascontiguousarray(qbeg, dtype=np.int32)
    slen = np.ascontiguousarray(slen, dtype=np.int32)
    chain_off = np.zeros(n_reads + 1, dtype=np.int64)
    seed_off = np.zeros(n_seeds + 2, dtype=np.int64)
    o_rbeg = np.zeros(n_seeds, dtype=np.int64)
    o_qbeg = np.zeros(n_seeds, dtype=np.int32)
    o_len = np.zeros(n_seeds, dtype=np.int32)
    n_chains = lib.bm_chain_batch(
        l_pac, w, max_chain_gap, n_reads,
        _ptr(read_off, _I64P), _ptr(rbeg, _I64P), _ptr(qbeg, _I32P),
        _ptr(slen, _I32P),
        _ptr(chain_off, _I64P), _ptr(seed_off, _I64P),
        _ptr(o_rbeg, _I64P), _ptr(o_qbeg, _I32P), _ptr(o_len, _I32P))
    if n_chains < 0:
        return None
    # trim to the seeds actually chained (bridging/contained seeds are
    # dropped by the insertion; untrimmed tails would become junk
    # device lanes downstream)
    n_out = int(seed_off[n_chains])
    return (chain_off, seed_off[:n_chains + 1], o_rbeg[:n_out],
            o_qbeg[:n_out], o_len[:n_out])


def pack_seqs(reads):
    """Concatenated nt4 queries + int64 offsets.  Cached on the chunk's
    first read object (a chunk's pack + finalize both flatten the same
    list); keyed on length AND last-read identity so two distinct
    same-length lists sharing the first read cannot alias (the held
    reference cannot be id-recycled)."""
    n = len(reads)
    if n:
        cached = getattr(reads[0], "_packed_seqs", None)
        if cached is not None and cached[2] == n \
                and cached[3] is reads[-1]:
            return cached[0], cached[1]
    seq_off = np.zeros(n + 1, dtype=np.int64)
    for i, r in enumerate(reads):
        seq_off[i + 1] = seq_off[i] + len(r.seq_nt4)
    seqs = np.empty(int(seq_off[-1]), dtype=np.uint8)
    for i, r in enumerate(reads):
        seqs[int(seq_off[i]):int(seq_off[i + 1])] = r.seq_nt4
    if n:
        try:
            reads[0]._packed_seqs = (seqs, seq_off, n, reads[-1])
        except AttributeError:
            pass
    return seqs, seq_off


class FlatRegs:
    """A chunk's alignment regions as the native flat arrays
    (reg_off + per-region columns), with lazy per-read AlnReg lists for
    any consumer that indexes/iterates — the SE finalize consumes the
    arrays directly, skipping the materialize/re-flatten round trip."""

    __slots__ = ("arrays", "_lists")

    def __init__(self, arrays):
        self.arrays = arrays  # (reg_off, rb, re, qb, qe, sc, ts, cs, w, sv)
        self._lists = None

    def lists(self):
        if self._lists is None:
            from .region import AlnReg
            (reg_off, o_rb, o_re, o_qb, o_qe, o_sc, o_ts, o_cs, o_w,
             o_sv) = self.arrays
            rb_l, re_l = o_rb.tolist(), o_re.tolist()
            qb_l, qe_l = o_qb.tolist(), o_qe.tolist()
            sc_l, ts_l = o_sc.tolist(), o_ts.tolist()
            cs_l, w_l, sv_l = o_cs.tolist(), o_w.tolist(), o_sv.tolist()
            off = reg_off.tolist()
            self._lists = [
                [AlnReg(rb=rb_l[k], re=re_l[k], qb=qb_l[k], qe=qe_l[k],
                        score=sc_l[k], truesc=ts_l[k], csub=cs_l[k],
                        w=w_l[k], seedcov=sv_l[k])
                 for k in range(off[i], off[i + 1])]
                for i in range(len(off) - 1)]
        return self._lists

    def __len__(self):
        return len(self.arrays[0]) - 1

    def __iter__(self):
        return iter(self.lists())

    def __getitem__(self, i):
        return self.lists()[i]


def flatten_chains(chains):
    """(chain_off, seed_off, rbeg, qbeg, len) flat arrays from per-read
    Chain-object lists, in (read, chain, seed) order."""
    n = len(chains)
    n_chains = sum(len(c) for c in chains)
    n_seeds = sum(ch.n for c in chains for ch in c)
    chain_off = np.zeros(n + 1, dtype=np.int64)
    seed_off = np.zeros(n_chains + 1, dtype=np.int64)
    s_rbeg = np.zeros(n_seeds, dtype=np.int64)
    s_qbeg = np.zeros(n_seeds, dtype=np.int32)
    s_len = np.zeros(n_seeds, dtype=np.int32)
    ci = 0
    k = 0
    for i, c in enumerate(chains):
        for ch in c:
            for (rbeg, qbeg, slen) in ch.seeds:
                s_rbeg[k], s_qbeg[k], s_len[k] = rbeg, qbeg, slen
                k += 1
            seed_off[ci + 1] = k
            ci += 1
        chain_off[i + 1] = ci
    return chain_off, seed_off, s_rbeg, s_qbeg, s_len


def seed_read_ids(flat, n_reads: int) -> np.ndarray:
    """Per-seed read index from the flat chain arrays (chain_off,
    seed_off, ...): the one derivation of the flat tuple's layout,
    shared by the native packer and the on-chip row builder."""
    chain_off, seed_off = flat[0], flat[1]
    counts = np.diff(np.ascontiguousarray(chain_off, np.int64))
    chain_read = np.repeat(np.arange(n_reads, dtype=np.int32), counts)
    return np.repeat(chain_read, np.diff(
        np.ascontiguousarray(seed_off, np.int64))).astype(np.int32)


def pack_extlr_native(opt, l_pac: int, pac_arr, reads, flat,
                      LQ: int, LT_max: int, force_scalar: bool = False):
    """Pack every seed's fused-extension request natively: returns a
    dict of per-seed arrays — 4-bit-packed device rows + lane scalars
    for in-cap seeds, scalar-computed results for oversize seeds
    (served=1).  None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pac = np.ascontiguousarray(pac_arr, dtype=np.uint8)
    seqs, seq_off = pack_seqs(reads)
    chain_off, seed_off, s_rbeg, s_qbeg, s_len = flat
    n_chains = len(seed_off) - 1
    n_seeds = len(s_rbeg)
    # per-chain read index from chain_off (seed_read_ids is the
    # per-SEED form of the same derivation)
    counts = np.diff(np.ascontiguousarray(chain_off, np.int64))
    chain_read = np.repeat(np.arange(len(reads), dtype=np.int32),
                           counts)
    seed_off = np.ascontiguousarray(seed_off, np.int64)
    s_rbeg = np.ascontiguousarray(s_rbeg, np.int64)
    s_qbeg = np.ascontiguousarray(s_qbeg, np.int32)
    s_len = np.ascontiguousarray(s_len, np.int32)
    mat = np.ascontiguousarray(np.asarray(opt.mat).reshape(-1),
                               dtype=np.int8)
    out = dict(
        served=np.zeros(n_seeds, np.uint8),
        lt_need=np.zeros(n_seeds, np.int32),
        llq=np.zeros(n_seeds, np.int32), llt=np.zeros(n_seeds, np.int32),
        rlq=np.zeros(n_seeds, np.int32), rlt=np.zeros(n_seeds, np.int32),
        scs=np.zeros(n_seeds, np.int32), sqb=np.zeros(n_seeds, np.int32),
        srb=np.zeros(n_seeds, np.int64), rmax0=np.zeros(n_seeds, np.int64),
        lqv=np.zeros(n_seeds, np.int32), slv=np.zeros(n_seeds, np.int32),
        lq_pk=np.zeros((n_seeds, LQ // 2), np.int8),
        lt_pk=np.zeros((n_seeds, LT_max // 2), np.int8),
        rq_pk=np.zeros((n_seeds, LQ // 2), np.int8),
        rt_pk=np.zeros((n_seeds, LT_max // 2), np.int8),
        r_score=np.zeros(n_seeds, np.int32),
        r_truesc=np.zeros(n_seeds, np.int32),
        r_qb=np.zeros(n_seeds, np.int32), r_rb=np.zeros(n_seeds, np.int64),
        r_qe=np.zeros(n_seeds, np.int32), r_re=np.zeros(n_seeds, np.int64),
        r_aw0=np.zeros(n_seeds, np.int32),
        r_aw1=np.zeros(n_seeds, np.int32),
    )
    if n_seeds == 0:
        return out
    lib.bm_pack_extlr(
        _ptr(mat, _I8P), opt.a, opt.o_del, opt.e_del, opt.o_ins,
        opt.e_ins, opt.w, opt.pen_clip5, opt.pen_clip3, opt.zdrop,
        LQ, LT_max, 1 if force_scalar else 0,
        l_pac, _ptr(pac, _U8P),
        _ptr(seqs, _U8P), _ptr(seq_off, _I64P),
        n_chains, _ptr(chain_read, _I32P), _ptr(seed_off, _I64P),
        _ptr(s_rbeg, _I64P), _ptr(s_qbeg, _I32P), _ptr(s_len, _I32P),
        _ptr(out["served"], _U8P), _ptr(out["lt_need"], _I32P),
        _ptr(out["llq"], _I32P), _ptr(out["llt"], _I32P),
        _ptr(out["rlq"], _I32P), _ptr(out["rlt"], _I32P),
        _ptr(out["scs"], _I32P), _ptr(out["sqb"], _I32P),
        _ptr(out["srb"], _I64P), _ptr(out["rmax0"], _I64P),
        _ptr(out["lqv"], _I32P), _ptr(out["slv"], _I32P),
        _ptr(out["lq_pk"], _I8P), _ptr(out["lt_pk"], _I8P),
        _ptr(out["rq_pk"], _I8P), _ptr(out["rt_pk"], _I8P),
        _ptr(out["r_score"], _I32P), _ptr(out["r_truesc"], _I32P),
        _ptr(out["r_qb"], _I32P), _ptr(out["r_rb"], _I64P),
        _ptr(out["r_qe"], _I32P), _ptr(out["r_re"], _I64P),
        _ptr(out["r_aw0"], _I32P), _ptr(out["r_aw1"], _I32P))
    return out


def regions_batch_native(opt, l_pac: int, pac_arr, reads, chains,
                         ext_outs) -> Optional[List[list]]:
    """Build every read's deduplicated AlnReg list natively from chains
    plus the speculative extension wave's per-seed results (`ext_outs`,
    one (score,truesc,qb,rb,qe,re,aw0,aw1) tuple per flattened seed in
    (read, chain, seed) order).  Returns None when unavailable (caller
    runs the Python generator machinery)."""
    flat = flatten_chains(chains)
    n_seeds = len(flat[2])
    if len(ext_outs) != n_seeds:
        return None  # positional contract violated; play safe
    e_sc = np.zeros(n_seeds, dtype=np.int32)
    e_ts = np.zeros(n_seeds, dtype=np.int32)
    e_qb = np.zeros(n_seeds, dtype=np.int32)
    e_rb = np.zeros(n_seeds, dtype=np.int64)
    e_qe = np.zeros(n_seeds, dtype=np.int32)
    e_re = np.zeros(n_seeds, dtype=np.int64)
    e_a0 = np.zeros(n_seeds, dtype=np.int32)
    e_a1 = np.zeros(n_seeds, dtype=np.int32)
    for k, o in enumerate(ext_outs):
        (e_sc[k], e_ts[k], e_qb[k], e_rb[k], e_qe[k], e_re[k], e_a0[k],
         e_a1[k]) = o
    return regions_batch_native_flat(
        opt, l_pac, pac_arr, reads, flat,
        (e_sc, e_ts, e_qb, e_rb, e_qe, e_re, e_a0, e_a1))


def regions_batch_native_flat(opt, l_pac: int, pac_arr, reads, flat,
                              ext_arrays, as_flat: bool = False):
    """regions_batch_native with flat chain arrays + per-seed extension
    result arrays (no Chain objects or result tuples).  `as_flat`
    returns a FlatRegs (arrays stay flat for the native finalize;
    AlnReg lists materialize lazily for other consumers)."""
    lib = _load()
    if lib is None:
        return None
    from .region import AlnReg
    n = len(reads)
    pac = np.ascontiguousarray(pac_arr, dtype=np.uint8)
    seqs, seq_off = pack_seqs(reads)
    chain_off, seed_off, s_rbeg, s_qbeg, s_len = flat
    chain_off = np.ascontiguousarray(chain_off, dtype=np.int64)
    seed_off = np.ascontiguousarray(seed_off, dtype=np.int64)
    s_rbeg = np.ascontiguousarray(s_rbeg, dtype=np.int64)
    s_qbeg = np.ascontiguousarray(s_qbeg, dtype=np.int32)
    s_len = np.ascontiguousarray(s_len, dtype=np.int32)
    n_chains = len(seed_off) - 1
    n_seeds = len(s_rbeg)
    e_sc, e_ts, e_qb, e_rb, e_qe, e_re, e_a0, e_a1 = [
        np.ascontiguousarray(a) for a in ext_arrays]

    cap = n_seeds + n_chains + 8
    reg_off = np.zeros(n + 1, dtype=np.int64)
    o_rb = np.zeros(cap, dtype=np.int64)
    o_re = np.zeros(cap, dtype=np.int64)
    o_qb = np.zeros(cap, dtype=np.int32)
    o_qe = np.zeros(cap, dtype=np.int32)
    o_sc = np.zeros(cap, dtype=np.int32)
    o_ts = np.zeros(cap, dtype=np.int32)
    o_cs = np.zeros(cap, dtype=np.int32)
    o_w = np.zeros(cap, dtype=np.int32)
    o_sv = np.zeros(cap, dtype=np.int32)
    mat = np.ascontiguousarray(np.asarray(opt.mat).reshape(-1),
                               dtype=np.int8)
    n_out = lib.bm_regions_batch(
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        opt.w, opt.min_seed_len, opt.flag,
        float(opt.mask_level), float(opt.chain_drop_ratio),
        float(opt.mask_level_redun), _ptr(mat, _I8P),
        l_pac, _ptr(pac, _U8P),
        n, _ptr(seqs, _U8P), _ptr(seq_off, _I64P),
        _ptr(chain_off, _I64P), _ptr(seed_off, _I64P),
        _ptr(s_rbeg, _I64P), _ptr(s_qbeg, _I32P), _ptr(s_len, _I32P),
        _ptr(e_sc, _I32P), _ptr(e_ts, _I32P), _ptr(e_qb, _I32P),
        _ptr(e_rb, _I64P), _ptr(e_qe, _I32P), _ptr(e_re, _I64P),
        _ptr(e_a0, _I32P), _ptr(e_a1, _I32P),
        cap, _ptr(reg_off, _I64P), _ptr(o_rb, _I64P), _ptr(o_re, _I64P),
        _ptr(o_qb, _I32P), _ptr(o_qe, _I32P), _ptr(o_sc, _I32P),
        _ptr(o_ts, _I32P), _ptr(o_cs, _I32P), _ptr(o_w, _I32P),
        _ptr(o_sv, _I32P))
    if n_out < 0:
        return None
    if as_flat:
        return FlatRegs((reg_off, o_rb, o_re, o_qb, o_qe, o_sc, o_ts,
                         o_cs, o_w, o_sv))
    rb_l = o_rb.tolist()
    re_l = o_re.tolist()
    qb_l = o_qb.tolist()
    qe_l = o_qe.tolist()
    sc_l = o_sc.tolist()
    ts_l = o_ts.tolist()
    cs_l = o_cs.tolist()
    w_l = o_w.tolist()
    sv_l = o_sv.tolist()
    off = reg_off.tolist()
    regs: List[list] = []
    for i in range(n):
        lst = []
        for k in range(off[i], off[i + 1]):
            lst.append(AlnReg(rb=rb_l[k], re=re_l[k], qb=qb_l[k],
                              qe=qe_l[k], score=sc_l[k], truesc=ts_l[k],
                              csub=cs_l[k], w=w_l[k], seedcov=sv_l[k]))
        regs.append(lst)
    return regs


def finalize_pe_native(opt, bns, pes, reads, regs: List[list],
                       n_processed: int, rg_id: str) -> bool:
    """Run the whole chunk's PE finalize natively (mate rescue, pairing,
    MAPQ reconciliation, SAM); sets read.sam on the interleaved reads.
    `pes` is the 4-orientation PeStat list from pestat()."""
    lib = _load()
    if lib is None:
        return False
    n = len(reads)
    if n % 2:
        return False
    packed = _pack_chunk(reads, regs)
    mat = np.ascontiguousarray(np.asarray(opt.mat).reshape(-1),
                               dtype=np.int8)
    pes_low = np.asarray([p.low for p in pes], dtype=np.int64)
    pes_high = np.asarray([p.high for p in pes], dtype=np.int64)
    pes_failed = np.asarray([p.failed for p in pes], dtype=np.int32)
    pes_avg = np.asarray([p.avg for p in pes], dtype=np.float64)
    pes_std = np.asarray([p.std for p in pes], dtype=np.float64)
    rec_off = np.zeros(n + 1, dtype=np.int64)
    total = np.zeros(1, dtype=np.int64)
    _DP = ctypes.POINTER(ctypes.c_double)
    args = [opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            opt.w, opt.T, opt.flag, opt.min_seed_len,
            float(opt.mask_level), float(opt.mapQ_coef_len),
            float(opt.mapQ_coef_fac), _ptr(mat, _I8P),
            opt.pen_unpaired, opt.max_matesw,
            float(opt.mask_level_redun),
            _ptr(pes_low, _I64P), _ptr(pes_high, _I64P),
            _ptr(pes_failed, _I32P), _ptr(pes_avg, _DP),
            _ptr(pes_std, _DP)]
    args += _common_args(opt, bns, packed, n, n_processed, rg_id)
    args += [_ptr(rec_off, _I64P), _ptr(total, _I64P)]
    ptr = lib.bm_finalize_pe(*args)
    return _collect(lib, ptr, rec_off, total, reads)
