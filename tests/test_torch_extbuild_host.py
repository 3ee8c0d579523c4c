"""The row builder's kernel (csrc/extbuild.cu bm_build_rows: a thread per
16-byte chunk of 32 bases) on the CPU: built by g++
(bwamem_tpu_torch/ops/emulate.py build_rows) and held against the plain
version (ops/extbuild.py build_rows_plain) and the native packer's rows,
tolerance zero, on the bundled genome's seeds and on edge lanes: qb0 0, a
seed ending its read, forward and reverse-strand windows, rmax0 0, rmax1
2*l_pac, windows ending at the last pac byte, a reads matrix whose width
is not a multiple of 16, a target bucket whose half is not a multiple of
16, LT 544/800/1056, and lanes out of range (the kernel clamps a position
into the read's row and the pac, as the plain version does).  Skips only
where g++ is missing."""

import os

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops import emulate
from bwamem_tpu_torch.ops.extbuild import (build_rows_plain, pac_tensor,
                                           reads_matrix)

BUCKETS = [(128, 544), (256, 800), (512, 1056), (128, 546)]
EDGES = ("qb0_zero", "seed_ends_read", "forward", "reverse", "rmax0_zero",
         "rmax1_twice_l_pac", "last_pac_byte", "out_of_range")


@pytest.fixture(scope="module", autouse=True)
def _gxx():
    if not emulate.available():
        pytest.skip("needs g++ to build the host emulation")


@pytest.fixture(scope="module")
def bns(data_dir):
    from bwamem_tpu_torch.index import load_index
    return load_index(os.path.join(data_dir, "genome.fa"))[1]


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want):
    for name, g, w in zip(("lq", "lt", "rq", "rt"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def edge_lanes(l_pac, kind, B, W, LT, seed):
    """B lanes of a reads matrix of width W (300 random reads) whose
    windows show `kind`; the rest of each lane random but in range.
    Returns the builder's arguments after pac and l_pac: (reads, rid,
    qb0, slen, rb0, rmax0, rmax1, lquery)."""
    rng = np.random.default_rng(seed)
    i32, i64 = np.int32, np.int64
    reads = rng.integers(0, 5, (300, W)).astype(np.int8)
    rid = rng.integers(0, 300, B)
    lquery = rng.integers(1, W + 1, B)
    qb0 = (rng.random(B) * (lquery + 1)).astype(i64)
    slen = (rng.random(B) * (lquery - qb0 + 1)).astype(i64)
    rev = rng.random(B) < 0.5
    if kind in ("forward", "rmax0_zero"):
        rev[:] = False
    elif kind in ("reverse", "rmax1_twice_l_pac"):
        rev[:] = True
    lo = np.where(rev, l_pac, 0)
    hi = np.where(rev, 2 * l_pac, l_pac)
    rmax0 = lo + rng.integers(0, l_pac // 2, B)
    rb0 = rmax0 + rng.integers(0, LT + 40, B)
    rmax1 = np.minimum(rb0 + slen + rng.integers(0, LT + 40, B), hi)
    if kind == "qb0_zero":
        qb0[:] = 0
    elif kind == "seed_ends_read":
        slen = lquery - qb0
    elif kind == "rmax0_zero":
        rmax0[:] = 0
        rb0 = rng.integers(0, LT + 40, B)
        rmax1 = np.minimum(rb0 + slen + rng.integers(0, LT + 40, B), hi)
    elif kind == "rmax1_twice_l_pac":
        rmax1[:] = 2 * l_pac
        rb0 = 2 * l_pac - slen - rng.integers(0, LT + 40, B)
        rmax0 = np.maximum(rb0 - rng.integers(0, LT + 40, B), l_pac)
    elif kind == "last_pac_byte":
        # forward windows ending at l_pac; reverse ones starting there
        # (their first base is the forward strand's last)
        rmax1 = np.where(rev, rmax1, l_pac)
        rb0 = np.where(rev, l_pac + rng.integers(0, 40, B),
                       l_pac - slen - rng.integers(0, 40, B))
        rmax0 = np.where(rev, l_pac, np.maximum(rb0 - LT, 0))
        rmax1 = np.where(rev, np.minimum(rb0 + slen + LT, 2 * l_pac), rmax1)
    elif kind == "out_of_range":
        # windows past the read, the pac, and both strands at once
        lquery = lquery + rng.integers(0, 3 * W, B)
        qb0 = qb0 + rng.integers(0, W, B)
        rmax0 = rmax0 - rng.integers(0, 2 * l_pac, B)
        rmax1 = rmax1 + rng.integers(0, 2 * l_pac, B)
    return (reads, rid.astype(i32), qb0.astype(i32), slen.astype(i32),
            rb0.astype(i64), rmax0.astype(i64), rmax1.astype(i64),
            lquery.astype(i32))


def edge_args(bns, kind, B, W, LQ, LT, seed):
    """build_rows' arguments (CPU tensors) for edge_lanes."""
    reads, *lanes = edge_lanes(bns.l_pac, kind, B, W, LT, seed)
    return (_T(reads), pac_tensor(bns.pac), bns.l_pac,
            *(_T(a) for a in lanes), LQ, LT)


@pytest.fixture(scope="module")
def seeds(data_dir):
    """The first 64 bundled reads and their seeds, chained on the CPU."""
    from bwamem_tpu_torch.config import MemOptions, fill_scmat
    from bwamem_tpu_torch.core.pipeline import encode_read
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[:64]
    for r in reads:
        encode_read(r)
    fm, _ = load_index(os.path.join(data_dir, "genome.fa"))
    flat = TorchSeedingEngine(fm, "cpu").chain_batch(opt, reads).flat
    return opt, reads, flat


@pytest.mark.parametrize("LQ,LT", BUCKETS, ids=lambda v: str(v))
def test_build_rows_emulation_on_bundled_seeds(bns, seeds, LQ, LT):
    """The seeds of 64 bundled reads: the emulation equals the plain
    version and the native packer's rows (LT 546: its half, 273 bytes, is
    not a multiple of 16, so each row's last chunk is narrower)."""
    from bwamem_tpu_torch.core import nfinalize
    opt, reads, flat = seeds
    pk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, reads, flat,
                                     LQ, LT)
    g = np.nonzero(pk["served"] == 0)[0]
    assert len(g) > 64
    rid = nfinalize.seed_read_ids(flat, len(reads))
    W = max(len(r.seq_nt4) for r in reads)
    args = (_T(reads_matrix([r.seq_nt4 for r in reads], W)),
            pac_tensor(bns.pac), bns.l_pac, _T(rid[g]), _T(pk["sqb"][g]),
            _T(pk["slv"][g]), _T(pk["srb"][g]), _T(pk["rmax0"][g]),
            _T((pk["srb"] + pk["slv"] + pk["rlt"])[g]), _T(pk["lqv"][g]),
            LQ, LT)
    got = emulate.build_rows(*args)
    _equal(got, build_rows_plain(*args))
    for name, a, key in zip(("lq", "lt", "rq", "rt"), got,
                            ("lq_pk", "lt_pk", "rq_pk", "rt_pk")):
        np.testing.assert_array_equal(a.numpy(), pk[key][g][:, :a.shape[1]],
                                      err_msg=name)


@pytest.mark.parametrize("LQ,LT", BUCKETS, ids=lambda v: str(v))
@pytest.mark.parametrize("kind", EDGES)
def test_build_rows_emulation_at_the_edges(bns, kind, LQ, LT):
    """Edge lanes over a reads matrix 150 bases wide (not a multiple of
    16): the emulation equals the plain version byte for byte."""
    args = edge_args(bns, kind, 257, 150, LQ, LT, LQ + LT)
    _equal(emulate.build_rows(*args), build_rows_plain(*args))


def test_edge_lanes_show_their_edges(bns):
    """The edge lanes hold what their names say."""
    L = bns.l_pac
    for kind, pred in (
            ("qb0_zero", lambda r, q, s, b, m0, m1, lq: (q == 0).all()),
            ("seed_ends_read",
             lambda r, q, s, b, m0, m1, lq: (q + s == lq).all()),
            ("forward", lambda r, q, s, b, m0, m1, lq: (m1 <= L).all()),
            ("reverse", lambda r, q, s, b, m0, m1, lq: (m0 >= L).all()),
            ("rmax0_zero", lambda r, q, s, b, m0, m1, lq: (m0 == 0).all()),
            ("rmax1_twice_l_pac",
             lambda r, q, s, b, m0, m1, lq: (m1 == 2 * L).all()),
            ("last_pac_byte",
             lambda r, q, s, b, m0, m1, lq: ((m1 == L) | (m0 == L)).all()),
            ("out_of_range",
             lambda r, q, s, b, m0, m1, lq: (lq > 150).any()
             and (m0 < 0).any() and (m1 > 2 * L).any())):
        _, *lanes = edge_lanes(L, kind, 257, 150, 544, 0)
        assert pred(*(a.astype(np.int64) for a in lanes)), kind
