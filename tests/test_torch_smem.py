"""The port's fused seeding dispatch (bwamem_tpu_torch/ops/smem.py
smem_superstep_sa: superstep, compaction, key expansion, SA walk) against
the JAX package's (bwamem_tpu/ops/smem.py, PALLAS=False) on the bundled
genome's reads.  Compared: the compact wire on slots [0, total), n_out
and over on every lane, SA values and flags on [0, n_keys), n_keys and
the key overflow.  Integer outputs: equality."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

B, L = 64, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def indexes(data_dir):
    from bwamem_tpu.index import load_index
    from bwamem_tpu.ops.fm import DeviceFmIndex as JaxIndex
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    fm, _ = load_index(os.path.join(data_dir, "genome.fa"))
    j = JaxIndex.from_host(fm)
    t = DeviceFmIndex.from_jax_arrays(
        np.asarray(j.blocks), np.asarray(j.L2), np.asarray(j.primary),
        np.asarray(j.seq_len), np.asarray(j.sa), j.sa_intv)
    return j, t


@pytest.fixture(scope="module")
def queries(data_dir):
    """B reads: the bundled reads, some with ambiguous bases, one
    inactive lane and one empty lane."""
    from bwamem_tpu.index.bntseq import NT4_TABLE
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
        s = s.copy()
        if i % 5 == 0:
            s[int(rng.integers(0, len(s)))] = 4
        q[i, :len(s)] = s
        qlen[i] = len(s)
    qlen[B - 1] = 0
    act = np.ones(B, bool)
    act[B - 2] = False
    return q, qlen, act


@pytest.mark.parametrize("M,GCAP,KEY_CAP", [
    (16, 12 * B, 8 * B),     # the seeding path's shapes
    (2, 12 * B, 8 * B),      # interval buffers overflow
    (16, 96, 16),            # compact wire spills, key expansion overflows
    (32, 12 * B, 8 * B),     # the buffer of indexes past 2^26 doubled bases
], ids=["main", "m2_overflow", "tight_caps", "m32"])
def test_superstep_sa_matches_jax(indexes, queries, M, GCAP, KEY_CAP):
    from bwamem_tpu.ops.smem import smem_superstep_sa as jax_sssa
    from bwamem_tpu_torch.ops.smem import smem_superstep_sa
    j, t = indexes
    q, qlen, act = queries
    qp = q[:, 0::2] | (q[:, 1::2] << np.int8(4))
    sl = np.minimum(29, qlen).astype(np.int32)
    sw = np.full(B, 10, np.int32)
    z8 = jnp.zeros((1, 8), jnp.bfloat16)
    want = jax_sssa(
        j.blocks, j.primary, j.L2, j.seq_len, j.sa, z8, z8,
        jnp.asarray(qp), jnp.asarray(qlen), jnp.full(B, 1, j.L2.dtype),
        jnp.asarray(act), jnp.asarray(sl), jnp.asarray(sw), jnp.int32(19),
        jnp.int32(500), L=L, M=M, OUT_CAP=48, PALLAS=False, QPACKED=True,
        GCAP=GCAP, KEY_CAP=KEY_CAP, SA_INTV=j.sa_intv, SA_STEPS=1024,
        SA_PALLAS=False)
    want = [np.asarray(w) for w in want]
    w_c0, _, w_cs, w_qb, w_qe, w_n, w_over, w_v, w_o, w_nk, w_kovf = want
    got = smem_superstep_sa(
        t, torch.from_numpy(qp), torch.from_numpy(qlen),
        torch.ones(B, dtype=torch.int64), torch.from_numpy(act),
        torch.from_numpy(sl), torch.from_numpy(sw), 19, 500, L=L, M=M,
        OUT_CAP=48, GCAP=GCAP, KEY_CAP=KEY_CAP, SA_STEPS=1024)
    c0, cs, qb, qe, n, over, v, o, nk, kovf = (g.numpy() for g in got)
    np.testing.assert_array_equal(n.astype(np.int64), w_n.astype(np.int64))
    np.testing.assert_array_equal(over, w_over)
    total = int(w_n.astype(np.int64).sum())
    for name, a, b in (("c0", c0, w_c0), ("cs", cs, w_cs), ("qb", qb, w_qb),
                       ("qe", qe, w_qe)):
        np.testing.assert_array_equal(a[:total].astype(np.int64),
                                      b[:total].astype(np.int64),
                                      err_msg=name)
    assert int(nk) == int(w_nk)
    assert bool(kovf) == bool(w_kovf)
    k = min(int(nk), KEY_CAP)
    np.testing.assert_array_equal(o[:k], w_o[:k])
    np.testing.assert_array_equal(v[:k].astype(np.int64),
                                  w_v[:k].astype(np.int64))
    if M == 2:
        assert over.sum() > B // 2
    if KEY_CAP == 16:
        assert bool(kovf) and over.sum() > 0


# ---- the long buckets and the round route, on a 6 kbp random genome ----

@pytest.fixture(scope="module")
def small_fm():
    """The 6 kbp random genome of tests/test_long_reads.py, with its
    host index and both packages' device indexes."""
    from bwamem_tpu.index.fmindex import FmIndex
    from bwamem_tpu.ops.fm import DeviceFmIndex as JaxIndex
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    rng = np.random.default_rng(23)
    fwd = rng.integers(0, 4, 6000).astype(np.uint8)
    fm = FmIndex.build(np.concatenate([fwd, 3 - fwd[::-1]]))
    return fwd, fm, JaxIndex.from_host(fm), DeviceFmIndex.from_host(fm)


def _bucket_queries(fwd, L, n, seed):
    """n reads of up to L bp from the genome: the first four exact
    full-length L bp copies (qe == L), then random lengths with
    mismatches and ambiguous bases."""
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        ln = L if i < 4 else int(rng.integers(L // 2, L + 1))
        off = int(rng.integers(0, len(fwd) - ln))
        q = fwd[off:off + ln].astype(np.int8)
        if i >= 4 and rng.random() < 0.7:
            for _ in range(int(rng.integers(1, 5))):
                q[int(rng.integers(0, ln))] = int(rng.integers(0, 5))
        qs.append(q)
    return qs


def _pad(qs, L):
    q = np.full((len(qs), L), 4, np.int8)
    qlen = np.zeros(len(qs), np.int32)
    for i, s in enumerate(qs):
        q[i, :len(s)] = s
        qlen[i] = len(s)
    return q, qlen


@pytest.mark.parametrize("L,M", [(128, 16), (256, 16), (512, 16),
                                 (256, 2), (128, 32)],
                         ids=["L128", "L256", "L512", "L256_m2_overflow",
                              "L128_m32"])
def test_iter_step_matches_jax(small_fm, L, M):
    """One iterator step (pass 1, the re-seeding test, pass 2) against
    JAX smem_iter_step(PALLAS=False): ambiguous start bases, inactive
    lanes, lanes that re-seed, M overflows and full-length matches.
    Compared: the flags on every lane; ret, n and the M_OUT columns of
    each pass where it did not overflow (JAX leaves those undefined; the
    port writes an overflowing pass as an inactive one)."""
    from bwamem_tpu.ops.smem import smem_iter_step as jax_step
    from bwamem_tpu_torch.ops.smem import smem_iter_step
    fwd, _, j, t = small_fm
    Bq, M_OUT = 32, min(12, M)
    rng = np.random.default_rng(L + M)
    q, qlen = _pad(_bucket_queries(fwd, L, Bq, L), L)
    x = np.asarray([0 if i < 4 else int(rng.integers(0, qlen[i]))
                    for i in range(Bq)], np.int32)
    act = rng.random(Bq) < 0.9
    act[:4] = True
    mi = np.where(rng.random(Bq) < 0.2, 2, 1).astype(np.int64)
    mi[:4] = 1                # the full-length copies match to their end
    sl = np.minimum(29, qlen).astype(np.int32)
    sw = np.full(Bq, 10, np.int32)
    want = [np.asarray(w) for w in jax_step(
        j.blocks, j.primary, j.L2, jnp.asarray(q), jnp.asarray(qlen),
        jnp.asarray(x), jnp.asarray(mi, j.L2.dtype), jnp.asarray(act),
        jnp.asarray(sl), jnp.asarray(sw), L=L, M=M, M_OUT=M_OUT,
        PALLAS=False)]
    qp = q[:, 0::2] | (q[:, 1::2] << np.int8(4))
    got = [g.numpy() for g in smem_iter_step(
        t, torch.from_numpy(qp), torch.from_numpy(qlen),
        torch.from_numpy(x), torch.from_numpy(mi), torch.from_numpy(act),
        torch.from_numpy(sl), torch.from_numpy(sw), L=L, M=M,
        M_OUT=M_OUT)]
    for k in (7, 8, 16):                          # over1, need2, over2
        np.testing.assert_array_equal(got[k], want[k].astype(bool))
    for base, over in ((0, got[7]), (9, got[16])):
        ok = ~over
        w = [a.astype(np.int64) for a in want[base:base + 7]]
        if L == 256:      # the JAX uint8 wire sends ret/qe == 256 as 0
            for k in (0, 6):
                w[k] = np.where(w[k] == 0, 256, w[k])
        g = [a.astype(np.int64) for a in got[base:base + 7]]
        np.testing.assert_array_equal(g[0][ok], w[0][ok])     # ret
        np.testing.assert_array_equal(g[1][ok], w[1][ok])     # n
        cols = np.arange(M_OUT)[None, :] < np.minimum(g[1], M_OUT)[:, None]
        cols &= ok[:, None]
        for k in range(2, 7):                                 # x0..qe
            np.testing.assert_array_equal(g[k][cols], w[k][cols])
            assert not g[k][~cols].any()
    need2, n1 = got[8], got[1]
    if M == 2:
        assert got[7].sum() > Bq // 4
    else:
        assert not got[7].any() and need2.sum() >= 4
        assert (n1[:4] == 1).all() and (got[6][:4, 0] == L).all()


def _timer():
    class Timer:
        stats = {}

        def _timed(self, fn, *a, _tag="", **kw):
            return fn(*a, **kw)

        def _count(self, tag, n=1):
            self.stats[tag] = self.stats.get(tag, 0) + n
    return Timer()


@pytest.mark.parametrize("L", [256, 512])
def test_round_route_streams_match_host_iterator(small_fm, monkeypatch, L):
    """BatchedSeeder.interval_streams (the BWAMEM_TPU_SUPERSTEP=0 route,
    one smem_iter_step per round) gives, per read, the host
    SmemIterator's interval stream, as tests/test_long_reads.py holds
    the JAX seeder to it; the M_OUT redo and the straggler tail run."""
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.oracle.smem import SmemIterator
    from bwamem_tpu_torch.ops.seeding import BatchedSeeder
    from bwamem_tpu_torch.parallel.mesh import ShardedKernels
    fwd, fm, _, t = small_fm
    monkeypatch.setenv("BWAMEM_TPU_SMEM_MOUT", "2")
    monkeypatch.setenv("BWAMEM_TPU_MIN_SEED_WAVE", "8")
    opt = MemOptions()
    timer = _timer()
    queries = [q.astype(np.uint8) for q in _bucket_queries(fwd, L, 40,
                                                           L + 1)]
    seeder = BatchedSeeder(t, fm, timer, ShardedKernels((t.device,), t),
                           L=L)
    streams = seeder.interval_streams(opt, queries)
    n_full = 0
    for q, got in zip(queries, streams):
        itr = SmemIterator(fm, q)
        split_len = min(int(opt.min_seed_len * opt.split_factor + .499),
                        len(q))
        want = []
        while True:
            a = itr.next(split_len, opt.split_width, 1)
            if a is None:
                break
            want.extend(a)
        assert got == want
        n_full += sum(1 for p in got if (p[3] & 0xFFFFFFFF) == L)
    assert n_full >= 4
    assert timer.stats["ovf_smem_lanes"] > 0
    assert timer.stats["smem_host_tail"] > 0


def test_superstep_512_matches_jax(small_fm):
    """The superstep's plain version at L=512 against JAX
    smem_superstep(PALLAS=False) at L=512 (its radix-1024 key, int32
    wire): the stream slots [0, n_out) of lanes that did not overflow,
    n_out and over."""
    from bwamem_tpu.ops.smem import smem_superstep
    from bwamem_tpu_torch.ops.smem import superstep_plain
    fwd, _, j, t = small_fm
    Bq, L = 16, 512
    q, qlen = _pad(_bucket_queries(fwd, L, Bq, 5), L)
    qp = q[:, 0::2] | (q[:, 1::2] << np.int8(4))
    sl = np.minimum(29, qlen).astype(np.int32)
    sw = np.full(Bq, 10, np.int32)
    act = np.ones(Bq, bool)
    want = [np.asarray(w) for w in smem_superstep(
        j.blocks, j.primary, j.L2, jnp.asarray(qp), jnp.asarray(qlen),
        jnp.ones(Bq, j.L2.dtype), jnp.asarray(act), jnp.asarray(sl),
        jnp.asarray(sw), L=L, M=16, OUT_CAP=64, NEED_X1=True,
        PALLAS=False, QPACKED=True)]
    w0, _, ws, wqb, wqe, wn, wover = want
    got = [g.numpy() for g in superstep_plain(
        t, torch.from_numpy(qp), torch.from_numpy(qlen),
        torch.ones(Bq, dtype=torch.int64), torch.from_numpy(act),
        torch.from_numpy(sl), torch.from_numpy(sw), L, 16, 64)]
    o0, os_, oqb, oqe, n_out, over = got
    np.testing.assert_array_equal(over, wover)
    ok = ~over
    np.testing.assert_array_equal(n_out[ok], wn[ok].astype(np.int64))
    slot = (np.arange(64)[None, :] < n_out[:, None]) & ok[:, None]
    for a, b in ((o0, w0), (os_, ws), (oqb, wqb), (oqe, wqe)):
        np.testing.assert_array_equal(a[slot].astype(np.int64),
                                      b[slot].astype(np.int64))
    assert (oqe[:4][slot[:4]] == L).any()
