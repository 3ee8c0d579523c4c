"""The port's fused left+right extension (bwamem_tpu_torch/ops/ksw.py
ksw_extend_lr_batched) against the JAX package's (bwamem_tpu/ops/ksw.py)
on all 8 outputs: the bundled genome's real seed lanes, and synthetic
lanes with band-doubling retries, z-drop and empty sides.  Integer
outputs: equality."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

B, LQ, LT = 64, 128, 544


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packrow(seq, width):
    buf = np.full(width, 4, np.int8)
    buf[:len(seq)] = seq
    return buf[0::2] | (buf[1::2] << np.int8(4))


def _synthetic(seed, B=B, LQ=LQ, LT=LT):
    """B lanes of related query/target pairs: mismatches, short indels,
    ~10% empty sides."""
    rng = np.random.default_rng(seed)
    lanes = {}
    for side in "lr":
        qs, ts, ql, tl = [], [], [], []
        for _ in range(B):
            m = 0 if rng.random() < 0.1 else int(rng.integers(1, LQ + 1))
            t = int(rng.integers(0, min(LT, m + 230) + 1))
            base = rng.integers(0, 4, max(m, t) + 8).astype(np.int8)
            q, tt = base[:m].copy(), base[:t].copy()
            mut = rng.random(m) < 0.08
            q[mut] = rng.integers(0, 5, int(mut.sum()))
            if t > 10 and rng.random() < 0.4:
                ins = rng.integers(0, 4, int(rng.integers(1, 4)))
                tt = np.concatenate([tt[:t // 2], ins.astype(np.int8),
                                     tt[t // 2:]])[:t]
            qs.append(_packrow(q, LQ))
            ts.append(_packrow(tt, LT))
            ql.append(m)
            tl.append(len(tt))
        lanes[side + "q"] = np.stack(qs)
        lanes[side + "t"] = np.stack(ts)
        lanes[side + "lq"] = np.asarray(ql, np.int32)
        lanes[side + "lt"] = np.asarray(tl, np.int32)
    lanes["sc"] = rng.integers(19, 60, B).astype(np.int32)
    lanes["qb"] = rng.integers(0, 100, B).astype(np.int32)
    lanes["rb"] = rng.integers(0, 10 ** 6, B).astype(np.int64)
    lanes["rmax0"] = lanes["rb"] - rng.integers(0, 300, B)
    lanes["lquery"] = rng.integers(50, LQ + 22, B).astype(np.int32)
    lanes["slen"] = rng.integers(19, 40, B).astype(np.int32)
    return lanes


def _real(data_dir):
    """The first B extension lanes of the bundled reads, as the native
    packer builds them for the engine."""
    from bwamem_tpu.config import MemOptions, fill_scmat
    from bwamem_tpu.core import nfinalize
    from bwamem_tpu.index import load_index
    from bwamem_tpu.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[:40]
    flat = TorchSeedingEngine(fm, "cpu").chain_batch(opt, reads).flat
    pk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, reads, flat,
                                     LQ, LT)
    g = np.resize(np.nonzero(pk["served"] == 0)[0], B)
    return dict(lq=pk["lq_pk"][g], lt=pk["lt_pk"][g], llq=pk["llq"][g],
                llt=pk["llt"][g], rq=pk["rq_pk"][g], rt=pk["rt_pk"][g],
                rlq=pk["rlq"][g], rlt=pk["rlt"][g], sc=pk["scs"][g],
                qb=pk["sqb"][g], rb=pk["srb"][g], rmax0=pk["rmax0"][g],
                lquery=pk["lqv"][g], slen=pk["slv"][g])


@pytest.mark.parametrize("case,w0,zdrop", [
    ("real", 100, 100),       # the engine's lanes, default options
    ("synthetic", 3, 0),      # narrow band: retries at 2w
    ("synthetic", 100, 5),    # z-drop ends rows early
])
def test_extend_lr_matches_jax(data_dir, case, w0, zdrop):
    from bwamem_tpu.config import fill_scmat
    from bwamem_tpu.ops.ksw import ksw_extend_lr_batched as jax_lr
    from bwamem_tpu_torch.ops.ksw import ksw_extend_lr_batched
    if case == "real":
        x = _real(data_dir)
    else:
        s = _synthetic(w0 + zdrop)
        x = dict(lq=s["lq"], lt=s["lt"], llq=s["llq"], llt=s["llt"],
                 rq=s["rq"], rt=s["rt"], rlq=s["rlq"], rlt=s["rlt"],
                 sc=s["sc"], qb=s["qb"], rb=s["rb"], rmax0=s["rmax0"],
                 lquery=s["lquery"], slen=s["slen"])
    mat = np.asarray(fill_scmat(1, 4), np.int32)
    names = ("lq", "lt", "llq", "llt", "rq", "rt", "rlq", "rlt")
    gap = (6, 1, 6, 1)
    want = jax_lr(*(jnp.asarray(x[k]) for k in names), jnp.asarray(mat),
                  *gap, w0, 5, 5, zdrop,
                  *(jnp.asarray(x[k]) for k in ("sc", "qb", "rb", "rmax0",
                                                "lquery", "slen")),
                  LQ=LQ, LT=LT, packed=True)
    got = ksw_extend_lr_batched(
        *(torch.from_numpy(np.ascontiguousarray(x[k])) for k in names),
        torch.from_numpy(mat.astype(np.int8)), *gap, w0, 5, 5, zdrop,
        *(torch.from_numpy(np.ascontiguousarray(x[k]))
          for k in ("sc", "qb", "rb", "rmax0", "lquery", "slen")),
        LQ=LQ, LT=LT)
    for name, g, w in zip(("score", "truesc", "qb", "rb", "qe", "re",
                           "aw0", "aw1"), got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w, np.int64),
                                      err_msg=name)
    aw = np.concatenate([got[6].numpy(), got[7].numpy()])
    if case == "synthetic":
        assert (x["llq"] == 0).any() and (x["rlq"] == 0).any()
    if w0 == 3:
        assert (aw == 2 * w0).any()           # some lanes retried
    if zdrop == 5:
        # z-drop fired: the same lanes without it extend differently
        nz = ksw_extend_lr_batched(
            *(torch.from_numpy(np.ascontiguousarray(x[k])) for k in names),
            torch.from_numpy(mat.astype(np.int8)), *gap, w0, 5, 5, 0,
            *(torch.from_numpy(np.ascontiguousarray(x[k]))
              for k in ("sc", "qb", "rb", "rmax0", "lquery", "slen")),
            LQ=LQ, LT=LT)
        assert any(not torch.equal(a, b) for a, b in zip(got, nz))


@pytest.mark.parametrize("w0,zdrop", [(100, 100), (3, 0)])
def test_extend_lr_long_bucket_matches_jax(w0, zdrop):
    """The LQ=256 query bucket (target up to LT=800, the engine's long
    buckets) against the JAX package at the same shapes."""
    from bwamem_tpu.config import fill_scmat
    from bwamem_tpu.ops.ksw import ksw_extend_lr_batched as jax_lr
    from bwamem_tpu_torch.ops.ksw import ksw_extend_lr_batched
    n, lq, lt = 24, 256, 800
    x = _synthetic(256 + w0, B=n, LQ=lq, LT=lt)
    mat = np.asarray(fill_scmat(1, 4), np.int32)
    names = ("lq", "lt", "llq", "llt", "rq", "rt", "rlq", "rlt")
    tail = ("sc", "qb", "rb", "rmax0", "lquery", "slen")
    want = jax_lr(*(jnp.asarray(x[k]) for k in names), jnp.asarray(mat),
                  6, 1, 6, 1, w0, 5, 5, zdrop,
                  *(jnp.asarray(x[k]) for k in tail), LQ=lq, LT=lt,
                  packed=True)
    got = ksw_extend_lr_batched(
        *(torch.from_numpy(np.ascontiguousarray(x[k])) for k in names),
        torch.from_numpy(mat.astype(np.int8)), 6, 1, 6, 1, w0, 5, 5, zdrop,
        *(torch.from_numpy(np.ascontiguousarray(x[k])) for k in tail),
        LQ=lq, LT=lt)
    for name, g, w in zip(("score", "truesc", "qb", "rb", "qe", "re",
                           "aw0", "aw1"), got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w, np.int64),
                                      err_msg=name)
    assert (np.concatenate([x["llq"], x["rlq"]]) > 128).any()


def _pairs(seed, n, lq, lt, tlen_near_qlen=False):
    """n query/target base pairs of random lengths: even lanes near-
    matching (the target a mutated copy of the query, with an indel),
    odd lanes random."""
    rng = np.random.default_rng(seed)
    qb = np.full((n, lq), 4, np.int8)
    tb = np.full((n, lt), 4, np.int8)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    for b in range(n):
        ql = int(rng.integers(1, lq + 1))
        tl = (max(1, min(lt, ql + int(rng.integers(-8, 9))))
              if tlen_near_qlen else int(rng.integers(1, lt + 1)))
        q = rng.integers(0, 4, ql).astype(np.int8)
        if b % 2 == 0:
            t = np.concatenate([q[:ql // 2],
                                rng.integers(0, 4, int(rng.integers(0, 4))),
                                q[ql // 2:],
                                rng.integers(0, 4, lt)]).astype(np.int8)[:tl]
            mut = rng.random(tl) < 0.05
            t[mut] = rng.integers(0, 5, int(mut.sum()))
        else:
            t = rng.integers(0, 5, tl).astype(np.int8)
        qb[b, :ql], tb[b, :tl] = q, t
        qlen[b], tlen[b] = ql, tl
    return qb, tb, qlen, tlen, rng


def _pk(a):
    return a[:, 0::2] | (a[:, 1::2] << np.int8(4))


@pytest.mark.parametrize("zdrop", [100, 5])
def test_extend2_matches_jax(zdrop):
    """Bare ksw_extend2_batched: per-lane band, end bonus and h0."""
    from bwamem_tpu.config import fill_scmat
    from bwamem_tpu.ops.ksw import ksw_extend2_batched as jax_e2
    from bwamem_tpu_torch.ops.ksw import ksw_extend2_batched
    qb, tb, qlen, tlen, rng = _pairs(zdrop, B, LQ, LT)
    w = rng.choice([100, 13, 3], B).astype(np.int32)
    eb = rng.choice([5, 10], B).astype(np.int32)
    h0 = rng.integers(1, 120, B).astype(np.int32)
    mat = np.asarray(fill_scmat(1, 4), np.int32)
    want = jax_e2(jnp.asarray(_pk(qb)), jnp.asarray(_pk(tb)),
                  jnp.asarray(qlen), jnp.asarray(tlen), jnp.asarray(mat),
                  6, 1, 6, 1, jnp.asarray(w), jnp.asarray(eb), zdrop,
                  jnp.asarray(h0), LQ=LQ, LT=LT, packed=True)
    T = torch.from_numpy
    got = ksw_extend2_batched(T(_pk(qb)), T(_pk(tb)), T(qlen), T(tlen),
                              T(mat.astype(np.int8)), 6, 1, 6, 1, T(w),
                              T(eb), zdrop, T(h0), LQ=LQ, LT=LT)
    for name, g, wv in zip(("best", "qle", "tle", "gtle", "gscore",
                            "max_off"), got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["narrow", "wide"])
def test_global2_matches_jax(case):
    """ksw_global2_batched (its XLA path on the CPU, which
    tests/test_pallas_global.py holds equal to the TPU kernel): every
    output, the ops up to n_ops, and the CIGARs built from them."""
    from bwamem_tpu.config import fill_scmat
    from bwamem_tpu.ops import ksw as jksw
    from bwamem_tpu_torch.ops import ksw as tksw
    GLQ, GLT, GB = 128, 160, 48
    qb, tb, qlen, tlen, rng = _pairs(7 if case == "narrow" else 8, GB, GLQ,
                                     GLT, tlen_near_qlen=True)
    if case == "narrow":      # bands narrower than the length difference
        w = rng.integers(1, 12, GB).astype(np.int32)
    else:
        w = rng.integers(20, 200, GB).astype(np.int32)
    qlen[0], tlen[1] = GLQ, GLT   # a full query, a full target
    mat = np.asarray(fill_scmat(1, 4), np.int32)
    want = [np.asarray(x) for x in jksw.ksw_global2_batched(
        jnp.asarray(_pk(qb)), jnp.asarray(_pk(tb)), jnp.asarray(qlen),
        jnp.asarray(tlen), jnp.asarray(mat), 6, 1, 6, 1, jnp.asarray(w),
        LQ=GLQ, LT=GLT, packed=True)]
    T = torch.from_numpy
    got = [x.numpy() for x in tksw.ksw_global2_batched(
        T(_pk(qb)), T(_pk(tb)), T(qlen), T(tlen), T(mat.astype(np.int8)),
        6, 1, 6, 1, T(w), LQ=GLQ, LT=GLT)]
    for name, g, wv in zip(("score", "ops", "n_ops", "rem_i", "rem_k"),
                           got, want):
        if name != "ops":
            np.testing.assert_array_equal(g, wv, err_msg=name)
    n = want[2]
    for b in range(GB):
        np.testing.assert_array_equal(got[1][b, :n[b]], want[1][b, :n[b]],
                                      err_msg=f"ops[{b}]")
    assert (got[1].shape == want[1].shape
            and got[1].dtype == want[1].dtype == np.uint8)
    rows = range(GB)
    assert (tksw.cigars_from_tracebacks(*got[1:], rows)
            == jksw.cigars_from_tracebacks(*want[1:], rows))
    assert ([tksw.cigar_from_traceback(got[1][b], got[2][b], got[3][b],
                                       got[4][b]) for b in rows]
            == [jksw.cigar_from_traceback(want[1][b], want[2][b],
                                          want[3][b], want[4][b])
                for b in rows])
    if case == "narrow":      # some walks leave through a matrix edge
        assert ((want[3] >= 0) | (want[4] >= 0)).any()
