"""The port's local Smith-Waterman (bwamem_tpu_torch/ops/ksw_align.py)
against the JAX package's ksw_align_batched (its XLA path on the CPU)
and against the scalar oracle's ksw_align2, and the engine's
drive_waves against core.swdrive.drive_host.  Inputs from numpy seeds;
integer outputs, compared for equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

LQV, LT = 128, 544


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(seed, n, lq=LQV, lt=LT):
    """Half the lanes hold a mutated copy of the query in the target."""
    rng = np.random.default_rng(seed)
    qb = np.full((n, lq), 4, np.int8)
    tb = np.full((n, lt), 4, np.int8)
    qlen = rng.integers(10, lq + 1, n).astype(np.int32)
    tlen = rng.integers(20, lt + 1, n).astype(np.int32)
    for b in range(n):
        q = rng.integers(0, 4, qlen[b]).astype(np.int8)
        t = rng.integers(0, 4, tlen[b]).astype(np.int8)
        if b % 2 == 0 and tlen[b] > qlen[b]:
            off = int(rng.integers(0, tlen[b] - qlen[b]))
            t[off:off + qlen[b]] = q
            nm = int(rng.integers(0, 6))
            t[rng.integers(0, tlen[b], nm)] = rng.integers(0, 4, nm)
        qb[b, :qlen[b]], tb[b, :tlen[b]] = q, t
    return qb, tb, qlen, tlen, rng


def _compare(qb, tb, qlen, tlen, mat, endsc, size):
    from bwamem_tpu.ops.ksw_align import ksw_align_batched as jax_align
    from bwamem_tpu_torch.ops.ksw_align import ksw_align_batched
    lqv, lt = qb.shape[1], tb.shape[1]
    want = jax_align(jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(qlen),
                     jnp.asarray(tlen), jnp.asarray(mat.astype(np.int32)),
                     6, 1, 6, 1, jnp.full(len(qb), 0x10000, jnp.int32),
                     jnp.asarray(endsc), size=size, LQV=lqv, LT=lt)
    T = torch.from_numpy
    got = ksw_align_batched(T(qb), T(tb), T(qlen), T(tlen),
                            T(mat.astype(np.int8)), 6, 1, 6, 1, T(endsc),
                            shift=-int(mat.min()), size=size, LQV=lqv, LT=lt)
    for name, g, w in zip(("gmax", "te", "qe", "saturated", "row_max",
                           "last"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("size", [1, 2])
def test_align_matches_jax(size):
    """Both striped widths, with endsc stops on a third of the lanes."""
    from bwamem_tpu.config import fill_scmat
    qb, tb, qlen, tlen, rng = _lanes(size, 64)
    mat = np.asarray(fill_scmat(1, 4), np.int64)
    endsc = np.where(rng.random(64) < 0.33, rng.integers(15, 60, 64),
                     0x10000).astype(np.int32)
    tlen[5] = 0                                   # an empty lane
    gmax, _te, _qe, _sat, _rm, last = _compare(qb, tb, qlen, tlen, mat,
                                               endsc, size)
    stopped = (endsc < 0x10000) & (gmax >= endsc)
    assert stopped.any() and (last[stopped] < tlen[stopped] - 1).any()
    assert last[5] == -1


def test_align_u8_saturates():
    """A match score of 4 takes a 100 bp exact match past 255: the u8
    pass stops there and flags it."""
    from bwamem_tpu.config import fill_scmat
    qb, tb, qlen, tlen, rng = _lanes(11, 16)
    qlen[:8] = 100
    for b in range(8):
        qb[b] = 4
        qb[b, :100] = rng.integers(0, 4, 100)
        tb[b, 50:150] = qb[b, :100]
        tlen[b] = max(tlen[b], 300)
    mat = np.asarray(fill_scmat(4, 4), np.int64)
    got = _compare(qb, tb, qlen, tlen, mat,
                   np.full(16, 0x10000, np.int32), 1)
    assert got[3][:8].all()


def test_align2_wave_matches_oracle():
    """align2_wave against the oracle's ksw_align2 on the requests of
    tests/test_ksw_batched.py test_align2_wave_parity: score, te, qe,
    the second best and the start positions."""
    from bwamem_tpu.config import MemOptions
    from bwamem_tpu.oracle import ksw as oksw
    from bwamem_tpu_torch.ops.ksw_align import align2_wave
    opt = MemOptions()
    rng = np.random.default_rng(9)
    mat = np.asarray(opt.mat, dtype=np.int64)
    reqs = []
    for t in range(40):
        ql = int(rng.integers(10, 101))
        tl = int(rng.integers(20, 400))
        q = rng.integers(0, 4, ql).astype(np.uint8)
        tgt = rng.integers(0, 4, tl).astype(np.uint8)
        if t % 2 == 0 and tl > ql:
            off = int(rng.integers(0, tl - ql))
            tgt[off:off + ql] = q
            nm = rng.integers(0, 5)
            tgt[rng.integers(0, tl, nm)] = rng.integers(0, 4, nm)
        xtra = (oksw.KSW_XSUBO | oksw.KSW_XSTART
                | (oksw.KSW_XBYTE if t % 3 else 0)
                | (opt.min_seed_len * opt.a))
        reqs.append(("align2", q, tgt, xtra))
    counts = {}
    outs = align2_wave(opt, reqs, 16, torch.from_numpy(mat.astype(np.int8)),
                       count=lambda k, n: counts.update({k: n}))
    for i, (_, q, tgt, xtra) in enumerate(reqs):
        want = oksw.ksw_align2(q, tgt, mat, opt.o_del, opt.e_del,
                               opt.o_ins, opt.e_ins, xtra)
        got = outs[i]
        assert (got.score, got.te, got.qe, got.score2, got.te2,
                got.tb, got.qb) == (want.score, want.te, want.qe,
                                    want.score2, want.te2, want.tb,
                                    want.qb), i
    assert not counts        # every request fit the kernel's shapes


def test_drive_waves_matches_host(data_dir):
    """The engine's drive_waves against core.swdrive.drive_host on the
    SE finalize generators of the bundled reads (global2 requests), with
    the tail threshold at 1 so every round is batched; a query longer
    than the kernel's LQ goes to the host and is counted."""
    import copy
    import os
    from bwamem_tpu.config import MemOptions, fill_scmat
    from bwamem_tpu.core.pipeline import align1_core, reg2sam_se_gen
    from bwamem_tpu.core.swdrive import drive_host
    from bwamem_tpu.index import load_index
    from bwamem_tpu.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[:48]
    regs = [align1_core(opt, fm, bns, bns.pac, r) for r in reads]
    eng = TorchSeedingEngine(fm, "cpu")
    eng.min_wave = 1
    eng.warm_shapes(opt)      # every fixed launch shape, on empty lanes

    def gens(rs):
        return [reg2sam_se_gen(opt, bns, bns.pac, r, copy.deepcopy(g), 0,
                               None, "") for r, g in zip(rs, regs)]
    host = copy.deepcopy(reads)
    for g in gens(host):
        drive_host(g, opt)
    dev = copy.deepcopy(reads)
    eng.drive_waves(opt, gens(dev))
    assert [r.sam for r in dev] == [r.sam for r in host]
    kt = eng.kernel_time_by_tag
    assert kt["n_global2"] > 0 and kt["wave_rounds"] > 0
    # one request past LQ=128: served on the host, counted
    q = np.zeros(130, np.uint8)
    out = eng.drive_waves(opt, [_one(("global2", q, q, 5))])
    assert out[0] == drive_host(_one(("global2", q, q, 5)), opt)
    assert kt["wave_host_oversize_global2"] == 1


def _one(req):
    """A generator that yields one request and returns its answer."""
    out = yield req
    return out
