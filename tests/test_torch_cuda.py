"""The port's CUDA kernels against their plain PyTorch versions, on the
GPU, and `mem` through them.  Marked ``cuda``: they skip where there is
no CUDA device and run on the machine with the card:

    python -m pytest tests/test_torch_cuda.py -m cuda

This file imports nothing of JAX or of the JAX package, so it runs where
JAX is not installed."""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def engine(cuda, data_dir):
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    return TorchSeedingEngine(fm, cuda), bns


@pytest.fixture(params=[False, True], ids=["i32", "i64"])
def dfm(request, engine, monkeypatch):
    """The engine's index, and the same tables with int64 coordinates and
    an int64 sampled SA (the kernels' wide path)."""
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    eng, _ = engine
    if not request.param:
        return eng.dfm
    monkeypatch.setenv("BWAMEM_TPU_FORCE_I64", "1")
    d = DeviceFmIndex.from_host(eng.fm_host).to(eng.device)
    assert d.cdt == d.sa.dtype == torch.int64
    return d


def _reads(data_dir, n):
    from bwamem_tpu_torch.io.fastq import parse_fastx
    return list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[:n]


def test_superstep_kernel_matches_plain(engine, dfm, data_dir):
    from bwamem_tpu_torch.core.pipeline import encode_read
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.smem import superstep_cuda, superstep_plain
    eng, _ = engine
    B, L = 256, 128
    reads = _reads(data_dir, B)
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        encode_read(r)
        q[i, :len(r.seq_nt4)] = r.seq_nt4
        qlen[i] = len(r.seq_nt4)
    dev = eng.device
    for M, oc in ((16, 48), (16, 8), (2, 48)):
        args = (dfm, torch.from_numpy(q[:, 0::2] | (q[:, 1::2] << 4))
                .to(dev), torch.from_numpy(qlen).to(dev),
                torch.ones(B, dtype=torch.int64, device=dev),
                torch.ones(B, dtype=torch.bool, device=dev),
                torch.full((B,), 29, dtype=torch.int32, device=dev),
                torch.full((B,), 10, dtype=torch.int32, device=dev), L, M,
                oc)
        n0 = _kernels.SMEM.launches
        k = superstep_cuda(*args)
        torch.cuda.synchronize()
        assert _kernels.SMEM.launches == n0 + 1
        p = superstep_plain(*args)
        assert torch.equal(k[5], p[5])
        ok = ~p[5]
        assert torch.equal(k[4][ok], p[4][ok])
        slot = (torch.arange(oc, device=dev) < p[4].unsqueeze(1)) \
            & ok.unsqueeze(1)
        for a, b in zip(k[:4], p[:4]):
            assert torch.equal(a[slot], b[slot])


def test_sa_kernel_matches_plain(engine, dfm):
    from bwamem_tpu_torch.ops.fm import sa_lookup_batched, sa_walk_cuda
    eng, _ = engine
    d = dfm
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, d.seq_len_int + 1, 4096)
                            ).to(eng.device)
    for steps in (1024, 3):
        kv, ko = sa_walk_cuda(d, keys, steps)
        pv, po = sa_lookup_batched(d, keys, steps)
        assert torch.equal(ko, po) and torch.equal(kv, pv)


def test_empty_batch_launches_nothing(engine):
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.fm import sa_walk_cuda
    eng, _ = engine
    n0 = _kernels.SA.launches
    vals, over = sa_walk_cuda(
        eng.dfm, torch.zeros(0, dtype=torch.int64, device=eng.device), 1024)
    assert vals.numel() == over.numel() == 0
    assert _kernels.SA.launches == n0


def test_extension_kernel_matches_plain(engine, data_dir):
    from bwamem_tpu_torch.config import MemOptions, fill_scmat
    from bwamem_tpu_torch.core import nfinalize
    from bwamem_tpu_torch.ops.ksw import extend_lr_cuda, extend_lr_plain
    eng, bns = engine
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    reads = _reads(data_dir, 200)
    flat = eng.chain_batch(opt, reads).flat
    pk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, reads, flat,
                                     128, 544)
    g = np.nonzero(pk["served"] == 0)[0]

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(eng.device)
    for w0, zdrop in ((opt.w, opt.zdrop), (3, 0), (opt.w, 5)):
        args = (T(pk["lq_pk"][g]), T(pk["lt_pk"][g]), T(pk["llq"][g]),
                T(pk["llt"][g]), T(pk["rq_pk"][g]), T(pk["rt_pk"][g]),
                T(pk["rlq"][g]), T(pk["rlt"][g]), eng._mat_dev(opt),
                opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w0,
                opt.pen_clip5, opt.pen_clip3, zdrop, T(pk["scs"][g]),
                T(pk["sqb"][g]), T(pk["srb"][g]), T(pk["rmax0"][g]),
                T(pk["lqv"][g]), T(pk["slv"][g]), 128, 544)
        for a, b in zip(extend_lr_cuda(*args), extend_lr_plain(*args)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("flags,reads,golden", [
    ([], ["reads_se.fq"], "golden_se.sam"),
    (["-a", "-M"], ["reads_se.fq"], "golden_se_aM.sam"),
    ([], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam"),
], ids=["se", "se_aM", "pe"])
def test_mem_cuda_matches_golden(cuda, data_dir, flags, reads, golden,
                                 capsys):
    from bwamem_tpu_torch import cli
    from bwamem_tpu_torch.ops import _kernels
    _kernels.reset_counts()
    assert cli.main_mem(["--device", "cuda"] + flags + [
        os.path.join(data_dir, "genome.fa")]
        + [os.path.join(data_dir, r) for r in reads]) == 0
    out = [ln for ln in capsys.readouterr().out.split("\n")
           if not ln.startswith("@PG")]
    with open(os.path.join(data_dir, golden)) as f:
        want = [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]
    assert out == want
    assert all(k.launches > 0 for k in (_kernels.SMEM, _kernels.SA,
                                         _kernels.EXTEND))


def _sw_lanes(seed, n, lq, lt):
    """n query/target pairs, half of them a mutated copy (with an indel)
    of the query in the target."""
    rng = np.random.default_rng(seed)
    qb = np.full((n, lq), 4, np.int8)
    tb = np.full((n, lt), 4, np.int8)
    qlen = rng.integers(1, lq + 1, n).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(-8, lt, n), lt).clip(1) \
        .astype(np.int32)
    for b in range(n):
        q = rng.integers(0, 4, qlen[b]).astype(np.int8)
        t = rng.integers(0, 5, tlen[b]).astype(np.int8)
        if b % 2 == 0:
            c = np.concatenate([q[:qlen[b] // 2], [int(rng.integers(4))],
                                q[qlen[b] // 2:]])[:tlen[b]]
            t[:len(c)] = c
        qb[b, :qlen[b]], tb[b, :tlen[b]] = q, t
    return qb, tb, qlen, tlen, rng


def _pk(a):
    return a[:, 0::2] | (a[:, 1::2] << np.int8(4))


def test_extend2_kernel_matches_plain(engine):
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.ksw import extend2_cuda, extend2_plain
    eng, _ = engine
    qb, tb, qlen, tlen, rng = _sw_lanes(1, 512, 128, 544)
    T = lambda a: torch.from_numpy(a).to(eng.device)  # noqa: E731
    for zdrop in (100, 5):
        args = (T(_pk(qb)), T(_pk(tb)), T(qlen), T(tlen),
                eng._mat_dev(_opt()), 6, 1, 6, 1,
                T(rng.choice([100, 13, 3], 512).astype(np.int32)),
                T(rng.choice([5, 10], 512).astype(np.int32)), zdrop,
                T(rng.integers(1, 120, 512).astype(np.int32)), 128, 544)
        n0 = _kernels.EXTEND2.launches
        for a, b in zip(extend2_cuda(*args), extend2_plain(*args)):
            assert torch.equal(a, b)
        assert _kernels.EXTEND2.launches == n0 + 1


def test_global2_kernel_matches_plain(engine):
    from bwamem_tpu_torch.ops.ksw import global_cuda, global_plain
    eng, _ = engine
    qb, tb, qlen, tlen, rng = _sw_lanes(2, 1024, 128, 160)
    tlen = np.minimum(tlen, qlen + 20).astype(np.int32)
    T = lambda a: torch.from_numpy(a).to(eng.device)  # noqa: E731
    for w in (rng.integers(1, 12, 1024), rng.integers(20, 200, 1024)):
        args = (T(_pk(qb)), T(_pk(tb)), T(qlen), T(tlen),
                eng._mat_dev(_opt()), 6, 1, 6, 1, T(w.astype(np.int32)),
                128, 160)
        k, p = global_cuda(*args), global_plain(*args)
        for a, b in zip(k, p):
            assert torch.equal(a, b)


@pytest.mark.parametrize("size", [1, 2])
def test_align2_kernel_matches_plain(engine, size):
    from bwamem_tpu_torch.ops.ksw_align import align_cuda, align_plain
    eng, _ = engine
    qb, tb, qlen, tlen, rng = _sw_lanes(3 + size, 512, 128, 544)
    endsc = np.where(rng.random(512) < 0.3, rng.integers(15, 60, 512),
                     0x10000).astype(np.int32)
    T = lambda a: torch.from_numpy(a).to(eng.device)  # noqa: E731
    mat = eng._mat_dev(_opt())
    shift = -int(mat.min()) if size == 1 else 0
    args = (T(qb), T(tb), T(qlen), T(tlen), mat, 6, 1, 6, 1, T(endsc),
            shift, size, 128, 544)
    for a, b in zip(align_cuda(*args), align_plain(*args)):
        assert torch.equal(a, b)


def _opt():
    from bwamem_tpu_torch.config import MemOptions, fill_scmat
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    return opt


@pytest.mark.parametrize("flags,reads,golden", [
    (["-v", "4"], ["reads_se.fq"], "golden_se_v4.txt"),
    (["-v", "4"], ["reads_1.fq", "reads_2.fq"], "golden_pe_v4.txt"),
], ids=["se_v4", "pe_v4"])
def test_mem_cuda_trace_matches_golden(cuda, data_dir, flags, reads, golden,
                                       capsys):
    """The -v 4 traces through the generator wave path on the card."""
    from bwamem_tpu_torch import cli
    from bwamem_tpu_torch.ops import _kernels
    _kernels.reset_counts()
    assert cli.main_mem(["--device", "cuda"] + flags + [
        os.path.join(data_dir, "genome.fa")]
        + [os.path.join(data_dir, r) for r in reads]) == 0
    out = [ln for ln in capsys.readouterr().out.split("\n")
           if not ln.startswith("@PG")]
    with open(os.path.join(data_dir, golden)) as f:
        want = [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]
    assert out == want
    assert _kernels.EXTEND2.launches > 0 and _kernels.GLOBAL2.launches > 0


# ---- the long buckets, the round route and the row builder ----

def _long_queries(bns, n, L, seed):
    """n reads of L/2..L bp cut from the bundled genome (both strands),
    packed; the first four exact full-length copies (qe == L), the rest
    with substitutions and, in a third of them, an N."""
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
    return _pk(q), qlen


@pytest.mark.parametrize("L,M", [(128, 16), (256, 16), (512, 16), (256, 2)],
                         ids=["L128", "L256", "L512", "L256_m2"])
def test_iter_step_kernel_matches_plain(engine, dfm, L, M):
    """bm_smem_iter_step against smem_iter_step_plain on all 17 outputs:
    pass 1 from random positions, the re-seeding test, pass 2."""
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.smem import (smem_iter_step_cuda,
                                           smem_iter_step_plain)
    eng, bns = engine
    B = 512
    qp, qlen = _long_queries(bns, B, L, L + M)
    rng = np.random.default_rng(L)
    x = (rng.random(B) * qlen).astype(np.int32)
    x[:4] = 0
    act = rng.random(B) < 0.9
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(eng.device)
    args = (dfm, T(qp), T(qlen), T(x),
            T(np.where(rng.random(B) < 0.2, 2, 1).astype(np.int64)), T(act),
            T(np.minimum(29, qlen).astype(np.int32)),
            T(np.full(B, 10, np.int32)), L, M, min(12, M))
    n0 = _kernels.SMEM1.launches
    k = smem_iter_step_cuda(*args)
    torch.cuda.synchronize()
    assert _kernels.SMEM1.launches == n0 + 1
    p = smem_iter_step_plain(*args)
    for i, (a, b) in enumerate(zip(k, p)):
        assert torch.equal(a.long(), b.long()), i
    assert bool(k[8].any())                   # some lanes re-seed
    if M == 2:
        assert bool(k[7].any())


@pytest.mark.parametrize("L", [256, 512])
def test_superstep_kernel_long_buckets(engine, L):
    """The superstep kernel at the L=256 and L=512 buckets, with their
    stream caps, against its plain version."""
    from bwamem_tpu_torch.ops.smem import superstep_cuda, superstep_plain
    eng, bns = engine
    B, M, oc = 256, 16, (48 if L == 256 else 64)
    qp, qlen = _long_queries(bns, B, L, L)
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(eng.device)
    args = (eng.dfm, T(qp), T(qlen),
            torch.ones(B, dtype=torch.int64, device=eng.device),
            torch.ones(B, dtype=torch.bool, device=eng.device),
            T(np.minimum(29, qlen).astype(np.int32)),
            torch.full((B,), 10, dtype=torch.int32, device=eng.device), L,
            M, oc)
    k, p = superstep_cuda(*args), superstep_plain(*args)
    assert torch.equal(k[5], p[5])
    ok = ~p[5]
    assert torch.equal(k[4][ok], p[4][ok])
    slot = (torch.arange(oc, device=eng.device) < p[4].unsqueeze(1)) \
        & ok.unsqueeze(1)
    for a, b in zip(k[:4], p[:4]):
        assert torch.equal(a[slot], b[slot])
    assert bool((k[3][slot] == L).any())      # full-length matches


@pytest.mark.parametrize("LQ,LT", [(256, 800), (512, 1056)])
def test_extension_kernel_long_buckets(engine, LQ, LT):
    """bm_extend_lr and bm_extend2 at the LQ=256 and LQ=512 buckets
    against their plain versions, on lanes whose sides reach LQ."""
    from bwamem_tpu_torch.ops.ksw import (extend2_cuda, extend2_plain,
                                          extend_lr_cuda, extend_lr_plain)
    eng, _ = engine
    B = 256
    ql, tl = {}, {}
    rows = {}
    rng = None
    for side, seed in (("l", 11), ("r", 12)):
        qb, tb, ql[side], tl[side], rng = _sw_lanes(seed + LQ, B, LQ, LT)
        rows[side] = (_pk(qb), _pk(tb))
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(eng.device)
    slen = rng.integers(19, 40, B).astype(np.int32)
    qb0 = ql["l"].astype(np.int32)
    lquery = (qb0 + slen + ql["r"]).astype(np.int32)
    rb = rng.integers(10 ** 4, 10 ** 6, B).astype(np.int64)
    args = (T(rows["l"][0]), T(rows["l"][1]), T(ql["l"]), T(tl["l"]),
            T(rows["r"][0]), T(rows["r"][1]), T(ql["r"]), T(tl["r"]),
            eng._mat_dev(_opt()), 6, 1, 6, 1, 100, 5, 5, 100,
            T(rng.integers(19, 60, B).astype(np.int32)), T(qb0), T(rb),
            T(rb - tl["l"]), T(lquery), T(slen), LQ, LT)
    for a, b in zip(extend_lr_cuda(*args), extend_lr_plain(*args)):
        assert torch.equal(a, b)
    args2 = (T(rows["l"][0]), T(rows["l"][1]), T(ql["l"]), T(tl["l"]),
             eng._mat_dev(_opt()), 6, 1, 6, 1,
             T(rng.choice([100, 13, 3], B).astype(np.int32)),
             T(rng.choice([5, 10], B).astype(np.int32)), 100,
             T(rng.integers(1, 120, B).astype(np.int32)), LQ, LT)
    for a, b in zip(extend2_cuda(*args2), extend2_plain(*args2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("LQ,LT", [(128, 544), (256, 800), (512, 1056)])
def test_build_rows_kernel_matches_plain(engine, data_dir, LQ, LT):
    """bm_build_rows against its plain version and the native packer's
    rows, for the seeds of 200 bundled reads."""
    from bwamem_tpu_torch.core import nfinalize
    from bwamem_tpu_torch.core.pipeline import encode_read
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.extbuild import (build_rows_cuda,
                                               build_rows_plain, pac_tensor,
                                               reads_matrix)
    eng, bns = engine
    opt = _opt()
    reads = _reads(data_dir, 200)
    for r in reads:
        encode_read(r)
    flat = eng.chain_batch(opt, reads).flat
    pk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, reads, flat,
                                     LQ, LT)
    g = np.nonzero(pk["served"] == 0)[0]
    rid = nfinalize.seed_read_ids(flat, len(reads))
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(eng.device)
    args = (T(reads_matrix([r.seq_nt4 for r in reads], LQ)),
            pac_tensor(bns.pac).to(eng.device), bns.l_pac, T(rid[g]),
            T(pk["sqb"][g]), T(pk["slv"][g]), T(pk["srb"][g]),
            T(pk["rmax0"][g]), T((pk["srb"] + pk["slv"] + pk["rlt"])[g]),
            T(pk["lqv"][g]), LQ, LT)
    n0 = _kernels.BUILD.launches
    k = build_rows_cuda(*args)
    torch.cuda.synchronize()
    assert _kernels.BUILD.launches == n0 + 1
    p = build_rows_plain(*args)
    for a, b, key in zip(k, p, ("lq_pk", "lt_pk", "rq_pk", "rt_pk")):
        assert torch.equal(a, b)
        assert np.array_equal(a.cpu().numpy(), pk[key][g])


@pytest.mark.parametrize("route", ["BWAMEM_TPU_SUPERSTEP=0",
                                   "BWAMEM_TPU_ONCHIP_EXT=1"],
                         ids=["superstep0", "onchip_ext"])
@pytest.mark.parametrize("reads,golden", [
    (["reads_se.fq"], "golden_se.sam"),
    (["reads_1.fq", "reads_2.fq"], "golden_pe.sam"),
], ids=["se", "pe"])
def test_mem_cuda_routes_match_golden(cuda, data_dir, monkeypatch, route,
                                      reads, golden, capsys):
    """The round-per-launch seeding route and the on-device extension
    rows on the card: the goldens, through their own kernels."""
    from bwamem_tpu_torch import cli
    from bwamem_tpu_torch.ops import _kernels
    key, val = route.split("=")
    monkeypatch.setenv(key, val)
    monkeypatch.setenv("BWAMEM_TPU_MIN_SEED_WAVE", "4")
    _kernels.reset_counts()
    assert cli.main_mem(["--device", "cuda",
                         os.path.join(data_dir, "genome.fa")]
                        + [os.path.join(data_dir, r) for r in reads]) == 0
    out = [ln for ln in capsys.readouterr().out.split("\n")
           if not ln.startswith("@PG")]
    with open(os.path.join(data_dir, golden)) as f:
        want = [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]
    assert out == want
    k = _kernels.SMEM1 if key == "BWAMEM_TPU_SUPERSTEP" else _kernels.BUILD
    assert k.launches > 0


def _table(cuda, n_rows, W, seed):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (n_rows, W), dtype=torch.int32,
                         generator=g, device=cuda)


@pytest.mark.parametrize("W,transpose", [(16, False), (128, False),
                                         (128, True), (12, False)])
def test_gather_rows_kernel_matches_plain(cuda, W, transpose):
    """The row gather at the occ row (16), the TPU's wide row (128, also
    transposed, probe a+b) and a width the vector path does not take;
    ids outside the table give zero rows."""
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.occ import gather_rows_cuda, gather_rows_plain
    table = _table(cuda, 4096, W, W)
    ids = torch.randint(-2, 4098, (3001,), device=cuda)
    n0 = _kernels.GATHER.launches
    got = gather_rows_cuda(table, ids, transpose)
    torch.cuda.synchronize()
    assert _kernels.GATHER.launches == n0 + 1
    assert torch.equal(got, gather_rows_plain(table, ids, transpose))
    if not transpose:
        ids2 = ids[:3000].view(2, 30, 50)
        assert torch.equal(gather_rows_cuda(table, ids2),
                           gather_rows_plain(table, ids2))


def test_occ4_kernel_matches_plain(dfm):
    from bwamem_tpu_torch.ops import fm as tfm
    from bwamem_tpu_torch.ops.occ import occ4_cuda
    n = dfm.seq_len_int
    special = torch.tensor([-1, 0, dfm.primary_int - 1, dfm.primary_int,
                            n - 1], device=dfm.device)
    k = torch.cat([special, torch.randint(0, n, (20000,),
                                          device=dfm.device)])
    got = occ4_cuda(dfm.blocks, dfm.primary_int, k)
    assert torch.equal(got, tfm.occ4(dfm.blocks, dfm.primary_int, k))
    # a key past the table reads nothing and gives zeros
    past = torch.tensor([128 * dfm.n_blocks + 1, 1 << 40], device=dfm.device)
    assert not occ4_cuda(dfm.blocks, dfm.primary_int, past).any()


@pytest.mark.parametrize("W", [16, 128])
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["dep", "nodep", "null", "full", "xpose",
                                  "dma"])
def test_row_chain_kernel_matches_plain(cuda, mode, K, W):
    from bwamem_tpu_torch.ops.occ import row_chain_cuda, row_chain_plain
    table = _table(cuda, 1000 if W == 16 else 1 << 10, W, K)
    idx0 = torch.randint(0, table.shape[0], (K, 777), device=cuda,
                         dtype=torch.int32)
    got = row_chain_cuda(table, idx0, 9, mode)
    assert torch.equal(got, row_chain_plain(table, idx0, 9, mode))


def test_affine_loop_kernel_matches_plain(cuda):
    from bwamem_tpu_torch.ops.occ import affine_loop_cuda, affine_loop_plain
    x = torch.rand((64, 128), device=cuda)
    got = affine_loop_cuda(x, 256)
    assert torch.equal(got, affine_loop_plain(x, 256))
    c = x
    for _ in range(256):
        c = affine_loop_cuda(c, 1)
    assert torch.equal(c, got)
