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


@pytest.mark.parametrize("chunk_bp", ["2000", "5000", "10000", "20000",
                                      "40000"])
@pytest.mark.parametrize("flags,reads,golden", [
    ([], ["reads_se.fq"], "golden_se.sam"),
    (["-a", "-M"], ["reads_se.fq"], "golden_se_aM.sam"),
    ([], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam"),
], ids=["se", "se_aM", "pe"])
def test_shard_stripes_hold_the_golden_names(cuda, data_dir, flags, reads,
                                             golden, chunk_bp, capsys,
                                             monkeypatch):
    """`--shard 0/2` and `--shard 1/2` on the card (what each
    `--distributed` rank runs) together hold exactly the golden's read
    names at every chunk size: a stripe numbers its reads from 0, which
    may move a hash tie to the other equal hit but adds or drops no
    record.  The unsharded SE runs stay byte-identical to the golden at
    that chunk size (PE estimates its insert sizes per chunk, so its
    records follow the chunking)."""
    from bwamem_tpu_torch import cli
    monkeypatch.setenv("BWAMEM_TPU_CHUNK_BP", chunk_bp)
    args = flags + [os.path.join(data_dir, "genome.fa")] + [
        os.path.join(data_dir, r) for r in reads]

    def records(extra):
        assert cli.main_mem(["--device", "cuda"] + extra + args) == 0
        return [ln for ln in capsys.readouterr().out.split("\n")
                if ln and not ln.startswith("@")]
    with open(os.path.join(data_dir, golden)) as f:
        want = [ln for ln in f.read().split("\n")
                if ln and not ln.startswith("@")]
    pair = records(["--shard", "0/2"]) + records(["--shard", "1/2"])
    name = lambda ls: sorted(ln.split("\t")[0] for ln in ls)  # noqa: E731
    assert name(pair) == name(want)
    if len(reads) == 1:
        assert records([]) == want


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


@pytest.mark.parametrize("B", [1, 33, 1025])
def test_global2_kernel_at_the_edges(engine, B):
    """bm_global2 (one warp per lane, one a block, the direction bytes in
    shared memory) against global_plain on the edge lanes (tlen 0, qlen 1,
    qlen LQ, tlen LT, w 1, w above both lengths, degenerate bands), every
    output; the launch counted."""
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.ksw import global_cuda, global_plain
    from tests.test_torch_kernels_host import GLO_EDGES, _glo_args, _glo_lanes
    eng, _ = engine
    args = tuple(x.to(eng.device) if isinstance(x, torch.Tensor) else x
                 for x in _glo_args(_glo_lanes(list(GLO_EDGES), B, B)))
    n0 = _kernels.GLOBAL2.launches
    got = global_cuda(*args)
    torch.cuda.synchronize()
    assert _kernels.GLOBAL2.launches == n0 + 1
    for a, b in zip(got, global_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("size", [1, 2], ids=["u8", "i16"])
@pytest.mark.parametrize("B", [1, 33, 513])
def test_align2_kernel_at_the_edges(engine, B, size):
    """bm_align2 (one warp per lane, one a block) against align_plain on
    the edge lanes (qlen not a multiple of p, endsc met on the first row,
    qlen LQ, tlen LT, tlen 0), under match scores 1 and 3 (u8
    saturation), every output; the launch counted."""
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.ksw_align import align_cuda, align_plain
    from tests.test_torch_kernels_host import (ALN_EDGES, _aln_args,
                                               _aln_lanes, _aln_mat)
    eng, _ = engine
    lanes = _aln_lanes(list(ALN_EDGES), B + size, B)
    for match in (1, 3):
        args = tuple(x.to(eng.device) if isinstance(x, torch.Tensor) else x
                     for x in _aln_args(lanes, size, _aln_mat(match)))
        n0 = _kernels.ALIGN2.launches
        got = align_cuda(*args)
        torch.cuda.synchronize()
        assert _kernels.ALIGN2.launches == n0 + 1
        for a, b in zip(got, align_plain(*args)):
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


@pytest.mark.parametrize("n", [3001, 70001])
@pytest.mark.parametrize("W,transpose", [(4, False), (16, False),
                                         (128, False), (5, False),
                                         (16, True), (128, True), (5, True)])
def test_gather_rows_warps_match_plain_and_emulation(cuda, W, transpose, n):
    """The warp gather (csrc/occ.cu): a group of W/4 lanes a row at W = 4,
    16 and 128 (one row a group, and four where the launch fills the
    card: 70,001 ids), the word warps at W = 5, the transposed tile; ids
    outside the table give zero rows.  Equal to the plain version and to
    the host emulation (bm_gather_rows_host), launched without a sync."""
    from bwamem_tpu_torch.ops import _kernels, emulate
    from bwamem_tpu_torch.ops.occ import gather_rows_cuda, gather_rows_plain
    table = _table(cuda, 4096, W, W + n)
    g = torch.Generator(device=cuda)
    g.manual_seed(n)
    ids = torch.randint(-3, 4099, (n,), generator=g, device=cuda)
    n0 = _kernels.GATHER.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = gather_rows_cuda(table, ids, transpose)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert _kernels.GATHER.launches == n0 + 1
    assert torch.equal(got, gather_rows_plain(table, ids, transpose))
    assert torch.equal(got.cpu(),
                       emulate.gather_rows(table.cpu(), ids.cpu(), transpose))


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_occ4_groups_match_plain_and_emulation(engine, parts):
    """occ4 by groups of 4 lanes over the whole table and split in 2 and
    4 parts on card 0: k = -1, 0, primary and its neighbours, both ends
    of every block, the last key, a key past the table (zeros) and
    random keys, against the plain version and bm_occ4_host."""
    from bwamem_tpu_torch.ops import emulate, fm as tfm
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    from bwamem_tpu_torch.ops.occ import occ4_cuda
    eng, _ = engine
    d = eng.dfm
    t = d if parts == 1 else DeviceFmIndex.from_host(eng.fm_host).split(
        [torch.device("cuda", 0)] * parts)
    n, p = d.seq_len_int, d.primary_int
    edge = [b * 128 + o for b in range(d.n_blocks) for o in (0, 127)]
    keys = torch.tensor([-1, 0, p - 1, p, p + 1, n - 1, n] + edge,
                        device=eng.device)
    keys = keys[keys <= n]
    rng = np.random.default_rng(parts)
    keys = torch.cat([keys, torch.from_numpy(
        rng.integers(0, n + 1, 30000)).to(eng.device)])
    got = occ4_cuda(t.blocks, t.primary_int, keys)
    assert torch.equal(got, tfm.occ4(d.blocks, p, keys))
    assert torch.equal(got.cpu(), emulate.occ4(t.blocks, p, keys.cpu()))
    past = torch.tensor([128 * d.n_blocks + 1, 1 << 40], device=eng.device)
    assert not occ4_cuda(t.blocks, p, past).any()


@pytest.mark.parametrize("switch", ["BWAMEM_TPU_NATIVE_FINALIZE=0",
                                    "BWAMEM_TPU_NATIVE_REGIONS=0",
                                    "BWAMEM_TPU_SPECULATE=0",
                                    "BWAMEM_TPU_GCAP_PER_LANE=0",
                                    "BWAMEM_TPU_FUSE_SA=0"])
@pytest.mark.parametrize("flags,reads,golden", [
    ([], ["reads_se.fq"], "golden_se.sam"),
    ([], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam"),
    (["-v", "4"], ["reads_se.fq"], "golden_se_v4.txt"),
], ids=["se", "pe", "se_v4"])
def test_mem_cuda_switches_match_golden(cuda, data_dir, monkeypatch, switch,
                                        flags, reads, golden, capsys):
    """The no-native route (the library left out), the Python chain and
    region route, no speculation, and the unfused seeding route on the
    card: the goldens, the superstep and the SA walk launched."""
    from bwamem_tpu_torch import cli
    from bwamem_tpu_torch.ops import _kernels, engine as eng_mod
    key, val = switch.split("=")
    monkeypatch.setenv(key, val)
    for name in ("NATIVE_REGIONS", "SPECULATE"):
        if key == "BWAMEM_TPU_" + name:
            monkeypatch.setattr(eng_mod, name, False)
    _kernels.reset_counts()
    assert cli.main_mem(["--device", "cuda"] + flags + [
        os.path.join(data_dir, "genome.fa")]
        + [os.path.join(data_dir, r) for r in reads]) == 0
    out = [ln for ln in capsys.readouterr().out.split("\n")
           if not ln.startswith("@PG")]
    with open(os.path.join(data_dir, golden)) as f:
        want = [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]
    assert out == want
    assert _kernels.SMEM.launches > 0 and _kernels.SA.launches > 0


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


# ---- the warp-per-seed extension and the group-per-read SMEM kernels at
# ---- the edges: batch sizes that fill no whole block, edge lanes

def _tile(x, B):
    """The lanes of x repeated to B."""
    idx = np.resize(np.arange(len(x["llq"])), B)
    return {k: v[idx] for k, v in x.items()}


@pytest.mark.parametrize("B", [1, 33, 16385])
@pytest.mark.parametrize("LQ,LT", [(128, 544), (256, 800), (512, 1056)])
def test_extension_kernels_at_the_edges(engine, LQ, LT, B):
    """bm_extend_lr and bm_extend2 (one warp per seed, one a block)
    against their plain versions: sides of qlen 1 and LQ, targets of LT,
    one-sided and empty seeds, h0 0, z-drop 0, bands above the clamp."""
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.ksw import (extend2_cuda, extend2_plain,
                                          extend_lr_cuda, extend_lr_plain)
    from tests.test_torch_kernels_host import _edge_lanes
    eng, _ = engine
    x = _tile(_edge_lanes(LQ, 64, LQ, LT), B)
    opt = _opt()
    mat = eng._mat_dev(opt)
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(eng.device)
    for w0, zdrop in ((100, 0), (5000, 100)):
        args = (T(x["lq_pk"]), T(x["lt_pk"]), T(x["llq"]), T(x["llt"]),
                T(x["rq_pk"]), T(x["rt_pk"]), T(x["rlq"]), T(x["rlt"]), mat,
                opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w0,
                opt.pen_clip5, opt.pen_clip3, zdrop, T(x["scs"]),
                T(x["sqb"]), T(x["srb"]), T(x["rmax0"]), T(x["lqv"]),
                T(x["slv"]), LQ, LT)
        n0 = _kernels.EXTEND.launches
        got = extend_lr_cuda(*args)
        torch.cuda.synchronize()
        assert _kernels.EXTEND.launches == n0 + 1
        for a, b in zip(got, extend_lr_plain(*args)):
            assert torch.equal(a, b)
    rng = np.random.default_rng(B)
    args2 = (T(x["lq_pk"]), T(x["lt_pk"]), T(x["llq"]), T(x["llt"]), mat,
             opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
             T(rng.choice([100, 3, 10 ** 5], B).astype(np.int32)),
             T(rng.choice([0, 5], B).astype(np.int32)), 0,
             T(np.where(np.arange(B) % 3 == 0, 0,
                        rng.integers(1, 120, B)).astype(np.int32)), LQ, LT)
    for a, b in zip(extend2_cuda(*args2), extend2_plain(*args2)):
        assert torch.equal(a, b)


def _edge_reads(bns, L, B):
    """B packed reads cut from the bundled genome: full-length (qlen ==
    L) copies, an all-N read, reads with substitutions and Ns."""
    qp, qlen = _long_queries(bns, 64, L, L + 1)
    qp[5] = 4 | (4 << 4)                      # all N
    idx = np.resize(np.arange(64), B)
    return qp[idx], qlen[idx]


@pytest.mark.parametrize("L,B", [(128, 1), (128, 33), (128, 8193),
                                 (512, 33)])
def test_superstep_kernel_at_the_edges(engine, L, B):
    """bm_smem_superstep (eight threads per read, four a block) against
    its plain version, with the M-entry buffers and the OUT_CAP stream
    overflowing."""
    from bwamem_tpu_torch.ops.smem import superstep_cuda, superstep_plain
    eng, bns = engine
    qp, qlen = _edge_reads(bns, L, B)
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(eng.device)
    for M, oc in ((16, 64), (2, 64), (16, 4)):
        args = (eng.dfm, T(qp), T(qlen),
                torch.ones(B, dtype=torch.int64, device=eng.device),
                torch.ones(B, dtype=torch.bool, device=eng.device),
                T(np.minimum(29, qlen).astype(np.int32)),
                torch.full((B,), 10, dtype=torch.int32, device=eng.device),
                L, M, oc)
        k, p = superstep_cuda(*args), superstep_plain(*args)
        assert torch.equal(k[5], p[5])
        ok = ~p[5]
        assert torch.equal(k[4][ok], p[4][ok])
        slot = (torch.arange(oc, device=eng.device) < p[4].unsqueeze(1)) \
            & ok.unsqueeze(1)
        for a, b in zip(k[:4], p[:4]):
            assert torch.equal(a[slot], b[slot])
        if B > 1 and (M == 2 or oc == 4):
            assert bool(k[5].any())


@pytest.mark.parametrize("B", [1, 33, 8193])
def test_iter_step_kernel_at_the_edges(engine, B):
    """bm_smem_iter_step (the same group design) against its plain
    version on all 17 outputs, M = 2 overflowing."""
    from bwamem_tpu_torch.ops.smem import (smem_iter_step_cuda,
                                           smem_iter_step_plain)
    eng, bns = engine
    L = 256
    qp, qlen = _edge_reads(bns, L, B)
    rng = np.random.default_rng(B)
    x = (rng.random(B) * qlen).astype(np.int32)
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(eng.device)
    for M in (16, 2):
        args = (eng.dfm, T(qp), T(qlen), T(x),
                torch.ones(B, dtype=torch.int64, device=eng.device),
                torch.ones(B, dtype=torch.bool, device=eng.device),
                T(np.minimum(29, qlen).astype(np.int32)),
                torch.full((B,), 10, dtype=torch.int32, device=eng.device),
                L, M, min(12, M))
        k, p = smem_iter_step_cuda(*args), smem_iter_step_plain(*args)
        for i, (a, b) in enumerate(zip(k, p)):
            assert torch.equal(a.long(), b.long()), i


# ---- the launch path: no sync, lanes past their bucket, the row builder
# ---- at the edges

def _on(x, dev):
    """Tensors and the index of a wrapper's arguments, moved to dev."""
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    if isinstance(x, (torch.Tensor, DeviceFmIndex)):
        return x.to(dev)
    return x


def _card_case(engine, wrapper, over):
    """tests/test_torch_launch.py's case for `wrapper` on the card, the
    SMEM wrappers on the bundled index, and the kernel record it counts
    on."""
    from bwamem_tpu_torch.ops import _kernels
    from tests.test_torch_launch import WRAPPERS
    eng, _ = engine
    fn, args = WRAPPERS[wrapper](over)
    if wrapper in ("superstep", "iter_step"):
        args = (eng.dfm,) + args[1:]
    k = {"extend_lr": _kernels.EXTEND, "extend2": _kernels.EXTEND2,
         "global2": _kernels.GLOBAL2, "align2": _kernels.ALIGN2,
         "superstep": _kernels.SMEM, "iter_step": _kernels.SMEM1,
         "build_rows": _kernels.BUILD}[wrapper]
    return fn, tuple(_on(a, eng.device) for a in args), k


@pytest.mark.parametrize("wrapper", ["align2", "build_rows", "extend2",
                                     "extend_lr", "global2", "iter_step",
                                     "superstep"])
def test_lane_past_its_bucket_on_the_card_does_not_fault(engine, wrapper):
    """Lengths on the card are not read back: a lane past its bucket
    launches, the kernel bounds its reads by the bucket, the stream ends
    without a fault, and the launch is counted.  The row builder clamps
    as its plain version does, so it still equals it."""
    fn, args, k = _card_case(engine, wrapper, True)
    n0 = k.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert k.launches == n0 + 1
    if wrapper == "build_rows":
        from bwamem_tpu_torch.ops.extbuild import build_rows_plain
        for a, b in zip(got, build_rows_plain(*args)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("wrapper", ["align2", "build_rows", "extend2",
                                     "extend_lr", "global2", "iter_step",
                                     "superstep", "sa_walk", "gather_rows",
                                     "occ4", "row_chain", "affine_loop"])
def test_wrapper_launches_without_a_sync(engine, wrapper):
    """Every wrapper, its inputs on the card, runs under
    torch.cuda.set_sync_debug_mode("error"), which raises on any
    operation that waits for the stream (a device value read on the
    host, a copy to the host)."""
    from bwamem_tpu_torch.ops import fm as tfm, occ as toc
    eng, _ = engine
    dev = eng.device
    d = eng.dfm
    keys = torch.arange(0, 4096, device=dev, dtype=torch.int64)
    other = {
        "sa_walk": (lambda: tfm.sa_walk_cuda(d, keys, 64)),
        "gather_rows": (lambda: toc.gather_rows_cuda(d.blocks, keys)),
        "occ4": (lambda: toc.occ4_cuda(d.blocks, d.primary_int, keys)),
        "row_chain": (lambda: toc.row_chain_cuda(
            d.blocks, keys[:256].to(torch.int32).view(1, -1), 4)),
        "affine_loop": (lambda: toc.affine_loop_cuda(
            torch.ones(64, 128, device=dev), 8))}
    if wrapper in other:
        call = other[wrapper]
    else:
        fn, args, _ = _card_case(engine, wrapper, False)
        call = lambda: fn(*args)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("LQ,LT", [(128, 544), (512, 1056), (128, 546)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("kind", ["qb0_zero", "seed_ends_read", "forward",
                                  "reverse", "rmax0_zero",
                                  "rmax1_twice_l_pac", "last_pac_byte",
                                  "out_of_range"])
def test_build_rows_kernel_at_the_edges(engine, kind, LQ, LT):
    """bm_build_rows (a thread per 16-byte chunk) against its plain
    version and its host emulation on the edge lanes of
    tests/test_torch_extbuild_host.py, 257 seeds (a partial block), a
    reads matrix 150 bases wide; lanes out of range clamp as the plain
    version does.  The launch counted."""
    from bwamem_tpu_torch.ops import _kernels, emulate
    from bwamem_tpu_torch.ops.extbuild import build_rows_cuda, build_rows_plain
    from tests.test_torch_extbuild_host import edge_args
    eng, bns = engine
    cpu_args = edge_args(bns, kind, 257, 150, LQ, LT, LQ + LT)
    args = tuple(_on(a, eng.device) for a in cpu_args)
    n0 = _kernels.BUILD.launches
    got = build_rows_cuda(*args)
    torch.cuda.synchronize()
    assert _kernels.BUILD.launches == n0 + 1
    for a, b, c in zip(got, build_rows_plain(*args),
                       emulate.build_rows(*cpu_args)):
        assert torch.equal(a, b)
        assert torch.equal(a.cpu(), c)


# ---- the reads mesh (bwamem_tpu_torch/parallel/mesh.py) on the card ----

def _card_mesh(kind):
    """Two shards: on card 0 and on the last card (two or more cards),
    or both on card 0."""
    n = torch.cuda.device_count()
    if kind == "last_card":
        if n < 2:
            pytest.skip("needs two or more cards")
        return (torch.device("cuda", 0), torch.device("cuda", n - 1))
    return (torch.device("cuda", 0),) * 2


def _query_group(data_dir, B, L=128):
    from bwamem_tpu_torch.core.pipeline import encode_read
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    for i, r in enumerate(_reads(data_dir, B)):
        encode_read(r)
        q[i, :len(r.seq_nt4)] = r.seq_nt4
        qlen[i] = len(r.seq_nt4)
    return _pk(q), qlen


@pytest.mark.parametrize("kind", ["last_card", "one_card_twice"])
@pytest.mark.parametrize("wrapper", ["superstep", "smem1", "sa_lookup",
                                     "extend_lr", "extend2", "global2"])
def test_sharded_wrapper_matches_one_card(engine, data_dir, wrapper, kind):
    """Each ShardedKernels wrapper over two shards, its lanes given on the
    host: every shard's kernel launches on its own card (the last one
    too, made current around the launch) and the outputs equal the
    unsharded wrapper's on card 0."""
    from bwamem_tpu_torch.ops import _kernels, fm as tfm, ksw, smem
    from bwamem_tpu_torch.parallel.mesh import ShardedKernels, shard_bounds
    eng, _ = engine
    mesh = _card_mesh(kind)
    sk = ShardedKernels(mesh, eng.dfm)
    dev = eng.device
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    mat = eng._mat_dev(_opt())
    B = 256
    qpk, qlen = _query_group(data_dir, B)
    one = np.ones(B, np.int64)
    act = np.ones(B, np.uint8)
    sl, sw = np.full(B, 28, np.int32), np.full(B, 10, np.int32)
    qb, tb, ql, tl, rng = _sw_lanes(9, B, 128, 544)
    w = rng.integers(1, 100, B).astype(np.int32)
    kernel = {"superstep": _kernels.SMEM, "smem1": _kernels.SMEM1,
              "sa_lookup": _kernels.SA, "extend_lr": _kernels.EXTEND,
              "extend2": _kernels.EXTEND2, "global2": _kernels.GLOBAL2}[wrapper]
    n0, cards0 = kernel.launches, dict(kernel.by_card)
    if wrapper == "superstep":
        kw = dict(L=128, M=16, OUT_CAP=48, GCAP=12 * B // 2,
                  KEY_CAP=8 * B // 2, SA_STEPS=1024)
        got = sk.superstep(qpk, qlen, one, act, sl, sw, 19, 500, **kw)
        assert kernel.launches == n0 + 2
        cards = dict(kernel.by_card)
        assert [b for b, _ in got] == shard_bounds(B, 2)
        got = [res for _, res in got]
        want = [smem.smem_superstep_sa(
            eng.dfm, T(qpk[lo:hi]), T(qlen[lo:hi]), T(one[lo:hi]),
            T(act[lo:hi]), T(sl[lo:hi]), T(sw[lo:hi]), 19, 500, **kw)
            for lo, hi in shard_bounds(B, 2)]
        parts = list(zip(*got))
        got = [g for res in got for g in res]
        want = [x for res in want for x in res]
    else:
        if wrapper == "smem1":
            host = (qpk, qlen, np.zeros(B, np.int32), one, act, sl, sw)
            got = sk.smem1(*host, L=128, M=16, M_OUT=12)
            assert kernel.launches == n0 + 2
            cards = dict(kernel.by_card)
            want = smem.smem_iter_step(eng.dfm, *map(T, host), L=128, M=16,
                                       M_OUT=12)
        elif wrapper == "sa_lookup":
            keys = rng.integers(0, eng.dfm.seq_len_int, 4096)
            got = sk.sa_lookup(keys, 1024)
            assert kernel.launches == n0 + 2
            cards = dict(kernel.by_card)
            want = tfm.sa_lookup(eng.dfm, T(keys), 1024)
        elif wrapper == "extend_lr":
            lq, lt = _pk(qb), _pk(tb)
            z = np.zeros(B, np.int32)
            host = (lq, lt, ql, tl, lq, lt, ql, tl, mat, 6, 1, 6, 1, 100, 5,
                    5, 100, z + 20, z, z.astype(np.int64),
                    z.astype(np.int64), ql, z + 19)
            got = sk.extend_lr(*host, LQ=128, LT=544)
            assert kernel.launches == n0 + 2
            cards = dict(kernel.by_card)
            want = ksw.ksw_extend_lr_batched(
                *(T(a) if isinstance(a, np.ndarray) else a for a in host),
                LQ=128, LT=544)
        elif wrapper == "extend2":
            host = (_pk(qb), _pk(tb), ql, tl, mat, 6, 1, 6, 1, w,
                    np.full(B, 5, np.int32), 100,
                    rng.integers(1, 120, B).astype(np.int32))
            got = sk.extend2(*host, LQ=128, LT=544)
            assert kernel.launches == n0 + 2
            cards = dict(kernel.by_card)
            want = ksw.ksw_extend2_batched(
                *(T(a) if isinstance(a, np.ndarray) else a for a in host),
                LQ=128, LT=544)
        else:
            gq, gt, gql, gtl, _ = _sw_lanes(10, B, 128, 160)
            gtl = np.minimum(gtl, gql + 20).astype(np.int32)
            host = (_pk(gq), _pk(gt), gql, gtl, mat, 6, 1, 6, 1, w)
            got = sk.global2(*host, LQ=128, LT=160)
            assert kernel.launches == n0 + 2
            cards = dict(kernel.by_card)
            want = ksw.ksw_global2_batched(
                *(T(a) if isinstance(a, np.ndarray) else a for a in host),
                LQ=128, LT=160)
        parts = [g.parts for g in got]
        got = [g.cpu() for g in got]
    torch.cuda.synchronize()
    for p in parts:
        assert [t.device for t in p] == list(mesh)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    # each shard's launch counted on its own card, where it launched
    per_card = {}
    for d in mesh:
        per_card[d.index] = per_card.get(d.index, 0) + 1
    delta = {c: n - cards0.get(c, 0) for c, n in cards.items()}
    assert {c: n for c, n in delta.items() if n} == per_card


# ---- split tables (mem --shard-tables) on the card ----

def _split_index(eng, kind, parts):
    """The engine's index split into `parts` parts: all on card 0
    (one_card), or over every card in turn (cards: two or more cards,
    peer access enabled between them); seen from card 0."""
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    n = torch.cuda.device_count()
    if kind == "cards":
        if n < 2:
            pytest.skip("needs two or more cards")
        devs = [torch.device("cuda", i % n) for i in range(parts)]
        for a in range(n):
            for b in range(n):
                _kernels.enable_peer(a, b)
    else:
        devs = [torch.device("cuda", 0)] * parts
    return DeviceFmIndex.from_host(eng.fm_host).split(devs)


@pytest.mark.parametrize("kind", ["one_card", "cards"])
@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("kernel", ["superstep", "iter_step", "sa_walk",
                                    "occ4"])
def test_split_kernel_matches_plain(engine, data_dir, kernel, parts, kind):
    """Each FM kernel over the index split into parts (csrc/fm.cuh
    row_at) against its plain version over the same parts and against
    the whole-table kernel, launched without a sync and counted once."""
    from bwamem_tpu_torch.ops import _kernels, fm as tfm, occ as toc, smem
    eng, bns = engine
    s = _split_index(eng, kind, parts)
    d = eng.dfm
    dev = torch.device("cuda", 0)
    T = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(dev)
    B = 512
    rng = np.random.default_rng(parts)
    if kernel in ("superstep", "iter_step"):
        qp, qlen = _long_queries(bns, B, 128, 7 + parts)
        lanes = (T(qp), T(qlen))
        if kernel == "iter_step":
            lanes += (T((rng.random(B) * qlen).astype(np.int32)),)
        lanes += (torch.ones(B, dtype=torch.int64, device=dev),
                  torch.ones(B, dtype=torch.bool, device=dev),
                  T(np.minimum(29, qlen).astype(np.int32)),
                  T(np.full(B, 10, np.int32)), 128, 16)
        if kernel == "superstep":
            fn, plain, rec = smem.superstep_cuda, smem.superstep_plain, \
                _kernels.SMEM
            make = lambda f: (f,) + lanes + (48,)  # noqa: E731
        else:
            fn, plain, rec = smem.smem_iter_step_cuda, \
                smem.smem_iter_step_plain, _kernels.SMEM1
            make = lambda f: (f,) + lanes + (12,)  # noqa: E731
    else:
        rows = s.blocks.rows
        edge = [r * 128 + o for i in range(1, parts)
                for r in (i * rows - 1, i * rows) for o in (0, 127)]
        keys = torch.cat([torch.tensor(
            edge + [-1, 0, d.primary_int - 1, d.primary_int,
                    d.primary_int + 1, d.seq_len_int - 1, d.seq_len_int],
            device=dev), T(rng.integers(0, d.seq_len_int + 1, 8192))])
        if kernel == "sa_walk":
            keys = keys.clamp(min=0)
            fn, plain, rec = tfm.sa_walk_cuda, tfm.sa_lookup_batched, \
                _kernels.SA
            make = lambda f: (f, keys, 1024)  # noqa: E731
        else:
            fn, plain, rec = toc.occ4_cuda, tfm.occ4, _kernels.OCC4
            make = lambda f: (f.blocks, f.primary_int, keys)  # noqa: E731
    n0 = rec.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*make(s))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rec.launches == n0 + 1
    got = got if isinstance(got, tuple) else (got,)
    for want in (plain(*make(s)), fn(*make(d))):
        want = want if isinstance(want, tuple) else (want,)
        if kernel == "superstep":    # the slots the consumer reads
            ok = ~want[5]
            slot = (torch.arange(48, device=dev) < want[4].unsqueeze(1)) \
                & ok.unsqueeze(1)
            assert torch.equal(got[5], want[5])
            assert torch.equal(got[4][ok], want[4][ok])
            got_c, want_c = [a[slot] for a in got[:4]], \
                [b[slot] for b in want[:4]]
        else:
            got_c, want_c = got, want
        for a, b in zip(got_c, want_c):
            assert torch.equal(a.long(), b.long())


@pytest.mark.parametrize("kind", ["one_card_twice", "cards"])
@pytest.mark.parametrize("flags,reads,golden", [
    ([], ["reads_se.fq"], "golden_se.sam"),
    (["-a", "-M"], ["reads_se.fq"], "golden_se_aM.sam"),
    ([], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam"),
], ids=["se", "se_aM", "pe"])
def test_mem_mesh2_shard_tables_matches_golden(cuda, data_dir, monkeypatch,
                                               flags, reads, golden, kind):
    """``mem --mesh 2 --shard-tables`` on the card: over the first two
    cards (cards), or two shards of card 0 (one_card_twice: make_mesh
    gives card 0 twice), the tables split in two; byte-identical to the
    goldens, the split run's kernels counted on card 0."""
    import io
    import sys
    from bwamem_tpu_torch import cli
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.parallel import mesh as tmesh
    if kind == "cards" and torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards")
    if kind == "one_card_twice":
        monkeypatch.setattr(tmesh, "make_mesh", lambda n, device: (
            torch.device("cuda", 0),) * n)
    n0 = _kernels.SMEM.by_card.get(0, 0)
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err
    try:
        ret = cli.main_mem(["--mesh", "2", "--shard-tables"] + flags + [
            os.path.join(data_dir, "genome.fa")]
            + [os.path.join(data_dir, r) for r in reads])
    finally:
        sys.stdout, sys.stderr = old
    assert ret == 0, err.getvalue()
    assert "occ table and SA split over 2 devices" in err.getvalue()
    ours = [ln for ln in out.getvalue().split("\n")
            if not ln.startswith("@PG")]
    with open(os.path.join(data_dir, golden)) as f:
        assert ours == [ln for ln in f.read().split("\n")
                        if not ln.startswith("@PG")]
    assert _kernels.SMEM.by_card.get(0, 0) > n0


@pytest.mark.parametrize("shards", [2, 4])
def test_graft_entry_dryrun_on_card(cuda, capsys, shards):
    """python -m bwamem_tpu_torch.graft_entry on the card (n shards on
    card 0 where there are fewer cards): its checks pass, and the
    iterator-step, superstep, SA-walk and extension kernels launched."""
    import json
    from bwamem_tpu_torch import graft_entry
    assert graft_entry.main(["--shards", str(shards)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["ok"] is True and got["dryrun"]["rescued"]
    for name in ("smem1_step", "smem_superstep", "sa_walk", "extend_lr"):
        assert got["launches"][name] > 0, name


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_bench_on_card(cuda, capsys, monkeypatch, pe):
    """python -m bwamem_tpu_torch.bench on the card, one chunk and one
    pass of the bundled reads at the bench's widths: one JSON line, and
    the seeding and extension kernels launched."""
    import json
    from bwamem_tpu_torch import bench
    from bwamem_tpu_torch.ops import _kernels
    for key, val in bench.WIDTHS.items():
        monkeypatch.setenv(key, val)
    for key, val in (("CHUNKS", "1"), ("PASSES", "1")):
        monkeypatch.setenv("BWAMEM_TPU_BENCH_" + key, val)
    if pe:
        monkeypatch.setenv("BWAMEM_TPU_BENCH_PE", "1")
    n0 = {k.name: k.launches for k in (_kernels.SMEM, _kernels.EXTEND)}
    assert bench.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["metric"] == "mem_align_throughput" + ("_pe" if pe else "")
    assert got["value"] > 0
    for k in (_kernels.SMEM, _kernels.EXTEND):
        assert k.launches > n0[k.name], k.name


# ---- human scale: a table past 2^31 bytes, coordinates past 2^32 -------

_WIDE_BLOCKS = (1 << 25) + (1 << 21)   # occ rows: 2.28 GB, 4.56 G symbols


@pytest.fixture(scope="module")
def wide_text(cuda):
    """The occ table of a random 2-bit text of 128 * _WIDE_BLOCKS symbols
    made on the card: random BWT words, and checkpoints that count them
    (each block's counts of the blocks before it, 64-bit, split into
    lo/hi int32 words), so every FM walk and interval stays inside the
    table as on a real index.  Returns (blocks, L2 int64 [5], primary,
    seq_len)."""
    from bwamem_tpu_torch.ops.fm import _M32, _M55, _popcount32
    g = torch.Generator(device=cuda).manual_seed(12)
    n = _WIDE_BLOCKS
    blocks = torch.empty((n, 16), dtype=torch.int32, device=cuda)
    blocks[:, 8:] = torch.randint(-(1 << 31), 1 << 31, (n, 8),
                                  dtype=torch.int32, device=cuda,
                                  generator=g)
    counts = torch.empty((n, 4), dtype=torch.int64, device=cuda)
    step = 1 << 22
    for lo in range(0, n, step):
        w = blocks[lo:lo + step, 8:].to(torch.int64) & _M32
        hb, lb = (w >> 1) & _M55, w & _M55
        c = [_popcount32(x).sum(1) for x in (
            lb & (~hb & _M32), hb & (~lb & _M32), hb & lb)]
        counts[lo:lo + step] = torch.stack([128 - sum(c)] + c, dim=1)
    before = counts.cumsum(0) - counts
    lo32 = before & _M32
    halves = torch.stack([torch.where(lo32 >= 1 << 31, lo32 - (1 << 32),
                                      lo32), before >> 32], dim=2)
    blocks[:, :8] = halves.reshape(n, 8).to(torch.int32)
    seq_len = 128 * n
    L2 = torch.zeros(5, dtype=torch.int64, device=cuda)
    L2[1:] = counts.sum(0).cumsum(0)
    del counts, before, lo32, halves
    assert int(L2[4]) == seq_len
    primary = int(torch.randint(0, seq_len, (1,), generator=g,
                                device=cuda))
    return blocks, L2, primary, seq_len


def _wide_index(wide_text, sa_intv):
    """A DeviceFmIndex over wide_text with a random int64 SA sample of
    interval sa_intv, its values past 2^32."""
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    blocks, L2, primary, seq_len = wide_text
    g = torch.Generator(device=blocks.device).manual_seed(sa_intv)
    sa = torch.randint(0, 1 << 40, (seq_len // sa_intv + 1,),
                       dtype=torch.int64, device=blocks.device, generator=g)
    return DeviceFmIndex(blocks, L2, primary, seq_len, sa, sa_intv)


@pytest.mark.parametrize("sa_intv", [8, 32])
def test_sa_kernel_on_a_wide_table(wide_text, sa_intv):
    """The SA walk on a table of more than 2^31 bytes, keys past 2^31
    and 2^32, int64 SA values: equal to the plain version."""
    from bwamem_tpu_torch.ops.fm import sa_lookup_batched, sa_walk_cuda
    d = _wide_index(wide_text, sa_intv)
    assert d.blocks.nbytes > 1 << 31 and d.seq_len_int > 1 << 32
    rng = np.random.default_rng(sa_intv)
    keys = rng.integers(0, d.seq_len_int + 1, 32768)
    keys[:8] = [0, d.primary_int, d.seq_len_int, d.seq_len_int - 1,
                (1 << 31) - 1, 1 << 31, 1 << 32, (1 << 32) + 1]
    keys = torch.from_numpy(keys).to(d.device)
    for steps in (128, 3):
        kv, ko = sa_walk_cuda(d, keys, steps)
        pv, po = sa_lookup_batched(d, keys, steps)
        assert kv.dtype == torch.int64
        assert torch.equal(ko, po) and torch.equal(kv, pv)
        assert int((kv > 1 << 32).sum()) > 0


@pytest.mark.parametrize("M", [16, 32])
def test_superstep_kernel_on_a_wide_table(wide_text, M):
    """The superstep over the same table, at both interval buffers:
    random 101 bp queries (a few N bases), intervals past 2^32; equal to
    the plain version on every slot the consumer reads."""
    from bwamem_tpu_torch.ops.smem import superstep_cuda, superstep_plain
    d = _wide_index(wide_text, 32)
    dev = d.device
    B, L, oc = 512, 128, 48
    rng = np.random.default_rng(3)
    q = np.full((B, L), 4, np.int8)
    q[:, :101] = rng.integers(0, 4, (B, 101))
    q[rng.random((B, L)) < 0.002] = 4
    qlen = np.full(B, 101, np.int32)
    args = (d, torch.from_numpy(q[:, 0::2] | (q[:, 1::2] << 4)).to(dev),
            torch.from_numpy(qlen).to(dev),
            torch.ones(B, dtype=torch.int64, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev),
            torch.full((B,), 29, dtype=torch.int32, device=dev),
            torch.full((B,), 10, dtype=torch.int32, device=dev), L, M, oc)
    k = superstep_cuda(*args)
    p = superstep_plain(*args)
    assert torch.equal(k[5], p[5])
    ok = ~p[5]
    assert torch.equal(k[4][ok], p[4][ok])
    slot = (torch.arange(oc, device=dev) < p[4].unsqueeze(1)) \
        & ok.unsqueeze(1)
    for a, b in zip(k[:4], p[:4]):
        assert torch.equal(a[slot], b[slot])
    assert int((p[0][slot] > 1 << 32).sum()) > 0


def test_extension_kernel_at_wide_reference_begins(engine, data_dir):
    """extend_lr with the seeds' reference begins and windows moved past
    2^32 doubled bases: the kernel equals the plain version, and the
    reference coordinates it returns are the bundled ones moved."""
    from bwamem_tpu_torch.core import nfinalize
    from bwamem_tpu_torch.ops.ksw import extend_lr_cuda, extend_lr_plain
    eng, bns = engine
    opt = _opt()
    reads = _reads(data_dir, 200)
    flat = eng.chain_batch(opt, reads).flat
    pk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, reads, flat,
                                     128, 544)
    g = np.nonzero(pk["served"] == 0)[0]
    off = (3 << 32) + 12345

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(eng.device)

    def args(shift):
        return (T(pk["lq_pk"][g]), T(pk["lt_pk"][g]), T(pk["llq"][g]),
                T(pk["llt"][g]), T(pk["rq_pk"][g]), T(pk["rt_pk"][g]),
                T(pk["rlq"][g]), T(pk["rlt"][g]), eng._mat_dev(opt),
                opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
                opt.pen_clip5, opt.pen_clip3, opt.zdrop, T(pk["scs"][g]),
                T(pk["sqb"][g]), T(pk["srb"][g] + shift),
                T(pk["rmax0"][g] + shift), T(pk["lqv"][g]),
                T(pk["slv"][g]), 128, 544)
    near = extend_lr_cuda(*args(0))
    far = extend_lr_cuda(*args(off))
    for a, b in zip(far, extend_lr_plain(*args(off))):
        assert torch.equal(a, b)
    # (score, truesc, qb, rb, qe, re, aw0, aw1): rb and re move
    for i, (a, b) in enumerate(zip(far, near)):
        assert torch.equal(a, b + off if i in (3, 5) else b), i


@pytest.mark.parametrize("LQ,LT", [(128, 544), (256, 800)])
def test_build_rows_kernel_at_wide_reference_begins(cuda, LQ, LT):
    """build_rows on a 2^31 + 2^20 + 5 base reference: seeds on the
    reverse strand with begins past 2^32 doubled bases and on the forward
    strand past 2^31, against the plain version."""
    from bwamem_tpu_torch.ops.extbuild import (build_rows_cuda,
                                               build_rows_plain)
    l_pac, B, W = (1 << 31) + (1 << 20) + 5, 4096, 256
    rng = np.random.default_rng(LQ)
    g = torch.Generator(device=cuda).manual_seed(LQ)
    pac = torch.randint(0, 256, ((l_pac + 3) // 4,), dtype=torch.uint8,
                        device=cuda, generator=g)
    lanes = _wide_lanes(rng, l_pac, B, W, LT)
    reads = torch.from_numpy(rng.integers(0, 4, (64, W)).astype(np.int8))
    args = (reads.to(cuda), pac, l_pac,
            *(torch.from_numpy(a).to(cuda) for a in lanes), LQ, LT)
    assert int(args[6].max()) > 1 << 32
    for a, b in zip(build_rows_cuda(*args), build_rows_plain(*args)):
        assert torch.equal(a, b)


def _wide_lanes(rng, l_pac, B, W, LT):
    """Seeds (rid, qb0, slen, rb0, rmax0, rmax1, lquery) of 64 reads of W
    bases on an l_pac-base reference: half on the reverse strand, ending
    within 4 kbp of the doubled reference's end (begins past 2^32), half
    on the forward strand within 4 kbp of l_pac, windows inside their
    strand and their target rows at most LT bases."""
    rid = rng.integers(0, 64, B).astype(np.int32)
    slen = rng.integers(19, 60, B)
    qb0 = rng.integers(0, 60, B)
    lquery = np.minimum(qb0 + slen + rng.integers(0, 100, B), W)
    rev = np.arange(B) % 2 == 0
    end = np.where(rev, 2 * l_pac, l_pac)
    rmax1 = end - rng.integers(0, 2000, B)
    rb0 = rmax1 - slen - rng.integers(0, LT // 2, B)
    rmax0 = rb0 - rng.integers(0, LT // 2, B)
    return (rid, qb0.astype(np.int32), slen.astype(np.int32), rb0, rmax0,
            rmax1, lquery.astype(np.int32))
