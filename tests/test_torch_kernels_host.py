"""The kernels written against a team of lanes, their own algorithms on the
CPU: csrc/extend.cu (one warp per seed), csrc/smem.cu (a group of threads
per read), csrc/global.cu and csrc/align.cu (one warp per alignment) built
by g++ with each group's lanes as arrays (bwamem_tpu_torch/ops/emulate.py)
and held against the plain PyTorch versions (ops/ksw.py extend_lr_plain,
extend2_plain, global_plain; ops/smem.py superstep_plain,
smem_iter_step_plain; ops/ksw_align.py align_plain) on the bundled
genome's seeds and reads and on lanes at the edges: one-sided seeds, qlen
1 and LQ, tlen 0 and LT, z-drop 0, h0 0, bands of 1 and above the clamp,
degenerate bands, u8 saturation, all-N reads, buffer and stream
overflows.  Integer outputs: equality.  Skips only where g++ is
missing."""

import os

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops import emulate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _gxx():
    if not emulate.available():
        pytest.skip("needs g++ to build the host emulation")


@pytest.fixture(scope="module")
def bundled(data_dir):
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    return fm, bns, DeviceFmIndex.from_host(fm)


def _opt():
    from bwamem_tpu_torch.config import MemOptions, fill_scmat
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    return opt


def _mat():
    return torch.from_numpy(np.asarray(_opt().mat, np.int8))


def _pk(a):
    return a[:, 0::2] | (a[:, 1::2] << np.int8(4))


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      w.numpy().astype(np.int64),
                                      err_msg=f"output {i}")


# ---- the extension ----

def _real_lanes(bundled, data_dir, n_reads, LQ, LT):
    """The extension lanes of the first bundled reads, as the native
    packer builds them for the engine."""
    from bwamem_tpu_torch.core import nfinalize
    from bwamem_tpu_torch.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, bns, _ = bundled
    opt = _opt()
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[:n_reads]
    flat = TorchSeedingEngine(fm, "cpu").chain_batch(opt, reads).flat
    pk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, reads, flat,
                                     LQ, LT)
    g = np.nonzero(pk["served"] == 0)[0]
    return {k: pk[k][g] for k in ("lq_pk", "lt_pk", "llq", "llt", "rq_pk",
                                  "rt_pk", "rlq", "rlt", "scs", "sqb", "srb",
                                  "rmax0", "lqv", "slv")}


def _edge_lanes(seed, B, LQ, LT):
    """B seeds at the edges: sides of qlen 1 and LQ, targets of LT,
    empty sides (one-sided and two-sided-empty seeds), h0 (the seed
    score) 0, and related query/target pairs with mismatches and
    indels in between."""
    rng = np.random.default_rng(seed)
    x = {}
    for side in "lr":
        q = np.full((B, LQ), 4, np.int8)
        t = np.full((B, LT), 4, np.int8)
        ql = np.zeros(B, np.int32)
        tl = np.zeros(B, np.int32)
        for b in range(B):
            kind = b % 8
            m = {0: 0, 1: 1, 2: LQ, 3: LQ}.get(kind,
                                               int(rng.integers(1, LQ + 1)))
            n = LT if kind in (3, 4) else int(rng.integers(m, min(LT, m + 120)
                                                          + 1))
            base = rng.integers(0, 4, max(m, n) + 8).astype(np.int8)
            qq, tt = base[:m].copy(), base[:n].copy()
            mut = rng.random(m) < 0.05
            qq[mut] = rng.integers(0, 5, int(mut.sum()))
            if n > 10 and rng.random() < 0.5:
                k = int(rng.integers(1, 4))
                at = int(rng.integers(1, n - 5))
                tt = np.concatenate([tt[:at], rng.integers(0, 4, k)
                                     .astype(np.int8), tt[at:]])[:n]
            q[b, :m], t[b, :n] = qq, tt
            ql[b], tl[b] = m, n
        if side == "r":
            ql[1::7] = 0          # one-sided seeds
        x[side] = (_pk(q), _pk(t), ql, tl)
    sc = rng.integers(19, 60, B).astype(np.int32)
    sc[5::8] = 0                   # h0 0
    slen = rng.integers(19, 40, B).astype(np.int32)
    qb = x["l"][2].copy()
    rb = rng.integers(10 ** 4, 10 ** 6, B).astype(np.int64)
    return {"lq_pk": x["l"][0], "lt_pk": x["l"][1], "llq": x["l"][2],
            "llt": x["l"][3], "rq_pk": x["r"][0], "rt_pk": x["r"][1],
            "rlq": x["r"][2], "rlt": x["r"][3], "scs": sc, "sqb": qb,
            "srb": rb, "rmax0": rb - x["l"][3], "lqv": qb + slen + x["r"][2],
            "slv": slen}


def _ext_args(x, w0, zdrop, LQ, LT):
    opt = _opt()
    return (_T(x["lq_pk"]), _T(x["lt_pk"][:, :LT // 2]), _T(x["llq"]),
            _T(x["llt"]), _T(x["rq_pk"]), _T(x["rt_pk"][:, :LT // 2]),
            _T(x["rlq"]), _T(x["rlt"]), _mat(), opt.o_del, opt.e_del,
            opt.o_ins, opt.e_ins, w0, opt.pen_clip5, opt.pen_clip3, zdrop,
            _T(x["scs"]), _T(x["sqb"]), _T(x["srb"]), _T(x["rmax0"]),
            _T(x["lqv"]), _T(x["slv"]), LQ, LT)


@pytest.mark.parametrize("w0,zdrop", [(100, 100), (3, 0), (100, 5),
                                      (5000, 100)],
                         ids=["default", "narrow_retry", "zdrop5",
                              "w_above_clamp"])
def test_extend_lr_host_real_seeds(bundled, data_dir, w0, zdrop):
    """bm_extend_lr's warp per seed on the bundled reads' seeds (LQ=128)
    against extend_lr_plain, all 8 outputs, and the visited cells within
    the band's."""
    from bwamem_tpu_torch.ops.ksw import extend_lr_plain
    x = _real_lanes(bundled, data_dir, 60, 128, 544)
    args = _ext_args(x, w0, zdrop, 128, 544)
    got, cells = emulate.extend_lr(*args)
    _equal(got, extend_lr_plain(*args))
    sided = (((x["llq"] > 0) & (x["llt"] > 0))
             | ((x["rlq"] > 0) & (x["rlt"] > 0)))
    assert len(cells) > 50 and sided.any() and not sided.all()
    assert (cells[sided] > 0).all() and not cells[~sided].any()
    if w0 == 3:
        assert (got[6] == 6).any()            # some lanes retried


@pytest.mark.parametrize("LQ,LT", [(128, 544), (256, 800), (512, 1056)])
def test_extend_lr_host_edges(LQ, LT):
    """The fused extension at every LQ bucket on the edge lanes, with
    z-drop 0 and a band above the clamp."""
    from bwamem_tpu_torch.ops.ksw import extend_lr_plain
    x = _edge_lanes(LQ, 24, LQ, LT)
    for w0, zdrop in ((100, 0), (5000, 100)):
        args = _ext_args(x, w0, zdrop, LQ, LT)
        got, _ = emulate.extend_lr(*args)
        _equal(got, extend_lr_plain(*args))


@pytest.mark.parametrize("LQ,LT", [(128, 544), (256, 800), (512, 1056)])
def test_extend2_host_edges(LQ, LT):
    """bm_extend2 (one warp per lane, per-lane band, end bonus and h0)
    on the left sides of the edge lanes against extend2_plain."""
    from bwamem_tpu_torch.ops.ksw import extend2_plain
    x = _edge_lanes(LQ + 1, 24, LQ, LT)
    rng = np.random.default_rng(LQ)
    B = len(x["llq"])
    opt = _opt()
    for zdrop in (100, 0, 5):
        args = (_T(x["lq_pk"]), _T(x["lt_pk"]), _T(x["llq"]), _T(x["llt"]),
                _mat(), opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                _T(rng.choice([100, 13, 3, 10 ** 5], B).astype(np.int32)),
                _T(rng.choice([0, 5, 10], B).astype(np.int32)), zdrop,
                _T(np.where(np.arange(B) % 4 == 0, 0,
                            rng.integers(1, 120, B)).astype(np.int32)),
                LQ, LT)
        got, cells = emulate.extend2(*args)
        _equal(got, extend2_plain(*args))
        assert (cells[x["llq"] == 0] == 0).all()


def _gap_lanes(seed, B, LQ, LT):
    """B query/target pairs around one long gap: the query with 33-90
    bases inserted (a gap along the query that F carries across more
    than one 32-column chunk) or deleted, a few substitutions, random
    bands from narrow to wide."""
    rng = np.random.default_rng(seed)
    q = np.full((B, LQ), 4, np.int8)
    t = np.full((B, LT), 4, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(LQ // 2, min(LQ, LT - 100)))
        ref = rng.integers(0, 4, n + 200).astype(np.int8)
        at, k = int(rng.integers(5, n // 2)), int(rng.integers(33, 91))
        if b % 2:
            qq = np.concatenate([ref[:at], rng.integers(0, 4, k)
                                 .astype(np.int8), ref[at:]])[:LQ]
        else:
            qq = np.concatenate([ref[:at], ref[at + k:]])[:LQ]
        mut = rng.random(len(qq)) < 0.02
        qq[mut] = rng.integers(0, 4, int(mut.sum()))
        tt = ref[:min(LT, len(qq) + int(rng.integers(0, 100)))]
        q[b, :len(qq)], t[b, :len(tt)] = qq, tt
        ql[b], tl[b] = len(qq), len(tt)
    return _pk(q), _pk(t), ql, tl, rng


@pytest.mark.parametrize("LQ,LT", [(256, 800), (512, 1056)])
def test_extend2_host_long_gaps(LQ, LT):
    """bm_extend2 against extend2_plain on lanes with one long insertion
    or deletion, bands of 5 to 200, with and without z-drop."""
    from bwamem_tpu_torch.ops.ksw import extend2_plain
    qp, tp, ql, tl, rng = _gap_lanes(LQ + 7, 40, LQ, LT)
    B = len(ql)
    opt = _opt()
    for zdrop in (0, 100):
        args = (_T(qp), _T(tp), _T(ql), _T(tl), _mat(), opt.o_del,
                opt.e_del, opt.o_ins, opt.e_ins,
                _T(rng.choice([5, 20, 50, 100, 200], B).astype(np.int32)),
                _T(rng.choice([0, 5], B).astype(np.int32)), zdrop,
                _T(rng.integers(0, 90, B).astype(np.int32)), LQ, LT)
        got, _ = emulate.extend2(*args)
        _equal(got, extend2_plain(*args))


def test_visited_cells_within_band(bundled, data_dir):
    """The cells a seed visits (each row's narrowed [beg, end)) are at
    most its bands' cells (every row's [i - w, i + w + 1) over the query),
    and the narrowing makes them fewer in all."""
    x = _real_lanes(bundled, data_dir, 60, 128, 544)
    got, cells = emulate.extend_lr(*_ext_args(x, 100, 100, 128, 544))
    retry_l = (got[6] == 200).numpy()
    retry_r = (got[7] == 200).numpy()

    def band(qlen, tlen, w):
        i = np.arange(int(tlen.max()) if len(tlen) else 0)[None]
        q, t = qlen[:, None].astype(np.int64), tlen[:, None]
        span = np.minimum(q, i + w + 1) - np.maximum(0, i - w)
        return (np.clip(span, 0, None) * (i < t)).sum(1)
    upper = (band(x["llq"], x["llt"], 100) + band(x["rlq"], x["rlt"], 100)
             + np.where(retry_l, band(x["llq"], x["llt"], 200), 0)
             + np.where(retry_r, band(x["rlq"], x["rlt"], 200), 0))
    assert (cells <= upper).all()
    assert cells.sum() < upper.sum()


# ---- the SMEM superstep and the iterator step ----

def _bundled_queries(data_dir, B, L):
    """B bundled reads, some with an ambiguous base, one all-N read, one
    inactive and one empty lane."""
    from bwamem_tpu_torch.index.bntseq import NT4_TABLE
    rng = np.random.default_rng(7)
    seqs = []
    with open(os.path.join(data_dir, "reads_se.fq")) as f:
        for i, ln in enumerate(f):
            if i % 4 == 1:
                seqs.append(NT4_TABLE[np.frombuffer(ln.strip().encode(),
                                                    np.uint8)])
            if len(seqs) == B:
                break
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        s = s.astype(np.int8)
        if i % 5 == 0:
            s[int(rng.integers(0, len(s)))] = 4
        q[i, :len(s)] = s
        qlen[i] = len(s)
    q[3] = 4                       # an all-N read
    qlen[B - 1] = 0
    act = np.ones(B, bool)
    act[B - 2] = False
    return _pk(q), qlen, act


def _long_queries(bns, n, L, seed):
    """n reads of L/2..L bp cut from the bundled genome (both strands):
    the first four exact full-length copies, the rest with
    substitutions and, in a third of them, an N."""
    from bwamem_tpu_torch.index.bntseq import get_seq
    rng = np.random.default_rng(seed)
    q = np.full((n, L), 4, np.int8)
    qlen = np.zeros(n, np.int32)
    for i in range(n):
        ln = L if i < 4 else int(rng.integers(L // 2, L + 1))
        beg = int(rng.integers(0, 2 * bns.l_pac - ln))
        if beg < bns.l_pac < beg + ln:
            beg = bns.l_pac
        s = get_seq(bns.l_pac, bns.pac, beg, beg + ln).astype(np.int8)
        if i >= 4:
            mut = rng.random(ln) < 0.01
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            if rng.random() < 0.33:
                s[int(rng.integers(0, ln))] = 4
        q[i, :ln] = s
        qlen[i] = ln
    return _pk(q), qlen, np.ones(n, bool)


def _superstep_equal(got, want, oc):
    """The superstep's outputs on the slots the consumer reads."""
    assert torch.equal(got[5], want[5])
    ok = ~want[5]
    assert torch.equal(got[4][ok].long(), want[4][ok].long())
    slot = (torch.arange(oc) < want[4].unsqueeze(1)) & ok.unsqueeze(1)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a[slot].long(), b[slot].long())
    return ok, slot


@pytest.mark.parametrize("M,oc", [(16, 48), (2, 48), (16, 8), (32, 48)],
                         ids=["main", "m2_overflow", "out_cap_overflow",
                              "m32"])
def test_superstep_host_bundled_reads(bundled, data_dir, M, oc):
    from bwamem_tpu_torch.ops.smem import superstep_plain
    _, _, dfm = bundled
    B, L = 48, 128
    qp, qlen, act = _bundled_queries(data_dir, B, L)
    args = (dfm, _T(qp), _T(qlen), torch.ones(B, dtype=torch.int64),
            _T(act), _T(np.minimum(29, qlen).astype(np.int32)),
            torch.full((B,), 10, dtype=torch.int32), L, M, oc)
    got = emulate.superstep(*args)
    ok, slot = _superstep_equal(got, superstep_plain(*args), oc)
    assert got[4][3] == 0 and not got[5][3]          # the all-N read
    if M == 2 or oc == 8:
        assert bool(got[5].any())
    else:
        assert bool(slot.any())


@pytest.mark.parametrize("L", [256, 512])
def test_superstep_host_long_reads(bundled, L):
    from bwamem_tpu_torch.ops.smem import superstep_plain
    _, bns, dfm = bundled
    B, oc = 12, (48 if L == 256 else 64)
    qp, qlen, act = _long_queries(bns, B, L, L)
    args = (dfm, _T(qp), _T(qlen), torch.ones(B, dtype=torch.int64),
            _T(act), _T(np.minimum(29, qlen).astype(np.int32)),
            torch.full((B,), 10, dtype=torch.int32), L, 16, oc)
    got = emulate.superstep(*args)
    _, slot = _superstep_equal(got, superstep_plain(*args), oc)
    assert bool((got[3][slot] == L).any())           # full-length matches


@pytest.mark.parametrize("L,M", [(128, 16), (256, 16), (512, 16), (256, 2)],
                         ids=["L128", "L256", "L512", "L256_m2"])
def test_iter_step_host(bundled, L, M):
    """bm_smem_iter_step's group per read against smem_iter_step_plain on
    all 17 outputs: pass 1 from random positions, the re-seeding test,
    pass 2."""
    from bwamem_tpu_torch.ops.smem import smem_iter_step_plain
    _, bns, dfm = bundled
    B = 16
    qp, qlen, _ = _long_queries(bns, B, L, L + M)
    rng = np.random.default_rng(L)
    x = (rng.random(B) * qlen).astype(np.int32)
    x[:4] = 0
    act = rng.random(B) < 0.9
    act[:4] = True
    args = (dfm, _T(qp), _T(qlen), _T(x),
            _T(np.where(rng.random(B) < 0.2, 2, 1).astype(np.int64)),
            _T(act), _T(np.minimum(29, qlen).astype(np.int32)),
            _T(np.full(B, 10, np.int32)), L, M, min(12, M))
    got = emulate.smem_iter_step(*args)
    want = smem_iter_step_plain(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.long(), b.long()), i
    if M == 2:
        assert bool(got[7].any())
    else:
        assert bool(got[8].any())                    # some lanes re-seed


# ---- global alignment with traceback and local SW (one warp per lane) ----

GLQ, GLT = 128, 160          # global2's widths on the wave path
ALQ, ALT = 128, 544          # align2's


def _related(rng, qlen, tlen):
    """A query of qlen bases and a target of tlen: the query with 2%
    substitutions and, on half the calls, a 1-3 base indel, then random
    bases."""
    q = rng.integers(0, 4, qlen).astype(np.int8)
    t = q.copy()
    mut = rng.random(qlen) < 0.02
    t[mut] = rng.integers(0, 4, int(mut.sum()))
    if qlen > 10 and rng.random() < 0.5:
        at, k = int(rng.integers(3, qlen - 3)), int(rng.integers(1, 4))
        t = (np.concatenate([t[:at], rng.integers(0, 4, k), t[at:]])
             if rng.random() < 0.5 else np.delete(t, range(at, at + k)))
    t = np.concatenate([t, rng.integers(0, 4, max(0, tlen - len(t)))])
    return q, t[:tlen].astype(np.int8)


# the edge lanes: kind -> (qlen, tlen, w) for a lane, from rng
GLO_EDGES = {
    "tlen0": lambda r: (int(r.integers(1, GLQ + 1)), 0,
                        int(r.integers(1, 50))),
    "qlen1": lambda r: (1, int(r.integers(1, 40)), int(r.integers(1, 30))),
    "qlen_LQ": lambda r: (GLQ, int(r.integers(100, GLT + 1)),
                          int(r.choice([1, 5, 40, 300]))),
    "tlen_LT": lambda r: (int(r.integers(90, GLQ + 1)), GLT,
                          int(r.integers(1, 80))),
    "w1": lambda r: (int(r.integers(1, GLQ + 1)), int(r.integers(1, GLT + 1)),
                     1),
    "w_wide": lambda r: (int(r.integers(1, GLQ + 1)),
                         int(r.integers(1, GLT + 1)),
                         int(r.integers(GLT + 1, 1000))),
    "degenerate": lambda r: (int(r.integers(1, 40)),
                             int(r.integers(100, GLT + 1)),
                             int(r.integers(1, 12))),
}


def _glo_lanes(kinds, seed, B):
    """B global2 lanes, packed, of the given edge kinds in turn."""
    rng = np.random.default_rng(seed)
    qb = np.full((B, GLQ), 4, np.int8)
    tb = np.full((B, GLT), 4, np.int8)
    sc = np.zeros((3, B), np.int32)
    for b in range(B):
        ql, tl, w = GLO_EDGES[kinds[b % len(kinds)]](rng)
        q, t = _related(rng, ql, tl)
        qb[b, :ql], tb[b, :tl] = q, t
        sc[:, b] = ql, tl, w
    return _pk(qb), _pk(tb), sc[0], sc[1], sc[2]


def _glo_args(lanes):
    opt = _opt()
    q, t, ql, tl, w = lanes
    return (_T(q), _T(t), _T(ql), _T(tl), _mat(), opt.o_del, opt.e_del,
            opt.o_ins, opt.e_ins, _T(w), GLQ, GLT)


def _seed_windows(bundled, data_dir, n):
    """The bundled reads with a chain and the reference start of their
    first seed (the read's place), as chip_smoke.py builds its lanes."""
    from bwamem_tpu_torch.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, bns, _ = bundled
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[:n]
    chain_off, seed_off, s_rb, s_qb, _ = TorchSeedingEngine(
        fm, "cpu").chain_batch(_opt(), reads).flat
    return bns, [(r.seq_nt4.astype(np.int8),
                  int(s_rb[seed_off[chain_off[i]]])
                  - int(s_qb[seed_off[chain_off[i]]]))
                 for i, r in enumerate(reads)
                 if chain_off[i + 1] > chain_off[i]]


def _window(bns, rng, beg, end):
    """The reference on [beg, end) with 2% substitutions and, on half the
    calls, a 1-3 base indel (chip_smoke.py check_sw_kernels)."""
    from bwamem_tpu_torch.index.bntseq import get_seq
    ref = get_seq(bns.l_pac, bns.pac, beg, end).astype(np.int8)
    mut = rng.random(len(ref)) < 0.02
    ref[mut] = rng.integers(0, 4, int(mut.sum()))
    if len(ref) > 20 and rng.random() < 0.5:
        at, k = int(rng.integers(5, len(ref) - 5)), int(rng.integers(1, 4))
        ref = (np.concatenate([ref[:at], rng.integers(0, 4, k), ref[at:]])
               if rng.random() < 0.5 else np.delete(ref, range(at, at + k)))
    return ref.astype(np.int8)


@pytest.mark.parametrize("kind", ["reads"] + list(GLO_EDGES))
def test_global2_host(bundled, data_dir, kind):
    """bm_global2's warp per lane against global_plain, every output
    (the ops row with its zero tail): the bundled reads against mutated
    windows at their seeds with chip_smoke.py's bands, and the edge
    lanes (tlen 0, qlen 1, qlen LQ, tlen LT, w 1, w above both lengths,
    degenerate bands)."""
    from bwamem_tpu_torch.ops.ksw import global_plain
    if kind == "reads":
        bns, places = _seed_windows(bundled, data_dir, 40)
        rng = np.random.default_rng(5)
        B = len(places)
        qb = np.full((B, GLQ), 4, np.int8)
        tb = np.full((B, GLT), 4, np.int8)
        sc = np.zeros((3, B), np.int32)
        for b, (q, st) in enumerate(places):
            t = _window(bns, rng, st, st + len(q)
                        + int(rng.integers(-8, 17)))[:GLT]
            qb[b, :len(q)], tb[b, :len(t)] = q, t
            sc[:, b] = (len(q), len(t),
                        abs(len(t) - len(q)) + int(rng.integers(3, 40)))
        lanes = (_pk(qb), _pk(tb), sc[0], sc[1], sc[2])
    else:
        lanes = _glo_lanes([kind], len(kind), 24)
    args = _glo_args(lanes)
    got = emulate.global2(*args)
    _equal(got, global_plain(*args))
    assert got[1].shape == (len(lanes[2]), GLQ + GLT)
    if kind == "tlen0":
        assert (got[2] == 0).all() and (got[3] == -1).all()
    if kind == "degenerate":
        assert (got[0] < -(1 << 29)).any()     # a score from kNeg


def _aln_mat(match):
    from bwamem_tpu_torch.config import fill_scmat
    return torch.from_numpy(np.asarray(fill_scmat(match, 4), np.int8))


# kind -> (qlen, tlen, endsc) for a lane, from rng
ALN_EDGES = {
    "qlen_odd": lambda r: (int(r.choice([1, 7, 9, 15, 17, 33, 101, 127])),
                           int(r.integers(1, ALT + 1)), 0x10000),
    "endsc_first_row": lambda r: (int(r.integers(1, ALQ + 1)),
                                  int(r.integers(1, ALT + 1)), 1),
    "qlen_LQ": lambda r: (ALQ, int(r.integers(ALQ, ALT + 1)),
                          int(r.choice([0x10000, 60]))),
    "tlen_LT": lambda r: (int(r.integers(1, ALQ + 1)), ALT, 0x10000),
    "tlen0": lambda r: (int(r.integers(1, ALQ + 1)), 0, 0x10000),
    "saturation": lambda r: (ALQ, int(r.integers(ALQ, ALT + 1)), 0x10000),
}


def _aln_lanes(kinds, seed, B):
    """B align2 lanes of the given edge kinds in turn: the query inside
    its target (mutated), at a random offset."""
    rng = np.random.default_rng(seed)
    qb = np.full((B, ALQ), 4, np.int8)
    tb = np.full((B, ALT), 4, np.int8)
    sc = np.zeros((3, B), np.int32)
    for b in range(B):
        ql, tl, endsc = ALN_EDGES[kinds[b % len(kinds)]](rng)
        q, t = _related(rng, ql, tl)
        off = int(rng.integers(0, max(1, tl - ql)))
        t = np.concatenate([rng.integers(0, 4, off).astype(np.int8), t])[:tl]
        qb[b, :ql], tb[b, :tl] = q, t
        sc[:, b] = ql, tl, endsc
    return qb, tb, sc[0], sc[1], sc[2]


def _aln_args(lanes, size, mat):
    opt = _opt()
    q, t, ql, tl, endsc = lanes
    shift = -int(mat.min()) if size == 1 else 0
    return (_T(q), _T(t), _T(ql), _T(tl), mat, opt.o_del, opt.e_del,
            opt.o_ins, opt.e_ins, _T(endsc), shift, size, ALQ, ALT)


@pytest.mark.parametrize("kind", ["reads"] + list(ALN_EDGES))
@pytest.mark.parametrize("size", [1, 2], ids=["u8", "i16"])
def test_align2_host(bundled, data_dir, kind, size):
    """bm_align2's warp per lane (u8 and i16) against align_plain, every
    output: the bundled reads against ~500 bp mutated windows around
    them, a third with an endsc stop (chip_smoke.py's lanes), and the edge
    lanes (qlen not a multiple of p, endsc met on the first row, qlen LQ,
    tlen LT, tlen 0, u8 saturation under a match score of 3)."""
    from bwamem_tpu_torch.ops.ksw_align import align_plain
    if kind == "reads":
        bns, places = _seed_windows(bundled, data_dir, 40)
        rng = np.random.default_rng(6)
        B = len(places)
        qb = np.full((B, ALQ), 4, np.int8)
        tb = np.full((B, ALT), 4, np.int8)
        sc = np.zeros((2, B), np.int32)
        for b, (q, st) in enumerate(places):
            t = _window(bns, rng, st - 200, st + len(q) + 200)[:ALT]
            qb[b, :len(q)], tb[b, :len(t)] = q, t
            sc[:, b] = len(q), len(t)
        endsc = np.where(rng.random(B) < 0.33, rng.integers(20, 80, B),
                         0x10000).astype(np.int32)
        lanes = (qb, tb, sc[0], sc[1], endsc)
    else:
        lanes = _aln_lanes([kind], len(kind) + size, 24)
    mat = _aln_mat(3 if kind == "saturation" else 1)
    args = _aln_args(lanes, size, mat)
    got = emulate.align2(*args)
    _equal(got, align_plain(*args))
    if kind == "saturation":
        assert bool(got[3].any()) == (size == 1)
    if kind == "endsc_first_row":
        last = got[5].numpy()
        assert (last[lanes[3] > 0] == got[1].numpy()[lanes[3] > 0]).all()
