"""The port's extension-row builder (bwamem_tpu_torch/ops/extbuild.py)
against the native packer's rows and the JAX package's builder
(bwamem_tpu/ops/pallas_extbuild.py build_rows_pallas, interpret mode),
and the on-device extension route against the packed-row one.  Integer
outputs: equality."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(scope="module")
def packed_case(data_dir):
    """The case of tests/test_extbuild.py: the first 64 bundled reads,
    their chains, and their per-seed scalars, with the native packer's
    rows at each of the two query buckets compared here."""
    from bwamem_tpu.config import MemOptions, fill_scmat
    from bwamem_tpu.core import nfinalize
    from bwamem_tpu.index import load_index
    from bwamem_tpu.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[:64]
    flat = TorchSeedingEngine(fm, "cpu").chain_batch(opt, reads).flat
    packs = {shape: nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac,
                                                reads, flat, *shape)
             for shape in ((128, 544), (256, 800))}
    rid = nfinalize.seed_read_ids(flat, len(reads))
    return bns, reads, opt, rid, packs


def _lanes(bns, reads, rid, pk, LQ):
    """The builder's inputs for the device-served seeds of a pack."""
    from bwamem_tpu_torch.ops.extbuild import pac_tensor, reads_matrix
    g = np.nonzero(pk["served"] == 0)[0]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    rmax1 = pk["srb"] + pk["slv"] + pk["rlt"]
    args = (T(reads_matrix([r.seq_nt4 for r in reads], LQ)),
            pac_tensor(bns.pac), bns.l_pac, T(rid[g]), T(pk["sqb"][g]),
            T(pk["slv"][g]), T(pk["srb"][g]), T(pk["rmax0"][g]),
            T(rmax1[g]), T(pk["lqv"][g]))
    return g, args


@pytest.mark.parametrize("LQ,LT", [(128, 544), (256, 800)],
                         ids=["LQ128_LT544", "LQ256_LT800"])
def test_rows_match_native_pack(packed_case, LQ, LT):
    """build_rows gives the native packer's four packed rows byte for
    byte, on forward and reverse-strand windows, with seeds that start
    and that end their read."""
    from bwamem_tpu_torch.ops.extbuild import build_rows
    bns, reads, _, rid, packs = packed_case
    pk = packs[(LQ, LT)]
    g, args = _lanes(bns, reads, rid, pk, LQ)
    assert len(g) > 64
    rev = pk["rmax0"][g] >= bns.l_pac
    assert rev.any() and (~rev).any()
    assert (pk["sqb"][g] == 0).any()
    assert (pk["sqb"][g] + pk["slv"][g] == pk["lqv"][g]).any()
    got = build_rows(*args, LQ, LT)
    for name, a, key in zip(("lq", "lt", "rq", "rt"), got,
                            ("lq_pk", "lt_pk", "rq_pk", "rt_pk")):
        np.testing.assert_array_equal(a.numpy(), pk[key][g], err_msg=name)


def _unpack4(p, L):
    out = np.empty((p.shape[0], L), np.int8)
    out[:, 0::2] = p & 15
    out[:, 1::2] = (p >> 4) & 15
    return out


def test_rows_match_jax_builder(packed_case):
    """build_rows against JAX build_rows_pallas in interpret mode at
    LQ=128, LT=544 (the JAX builder takes LT <= 769 only)."""
    from bwamem_tpu.ops import pallas_extbuild as pe
    from bwamem_tpu_torch.ops.extbuild import build_rows
    bns, reads, _, rid, packs = packed_case
    LQ, LT, B = 128, 544, 128
    pk = packs[(LQ, LT)]
    g, args = _lanes(bns, reads, rid, pk, LQ)
    g, args = g[:B], args[:3] + tuple(a[:B] for a in args[3:])
    n = len(g)
    q = np.full((LQ, 128), 4, np.int8)
    for i, r in enumerate(reads):
        q[:len(r.seq_nt4), i] = r.seq_nt4

    def pad(a):
        out = np.zeros(B, np.int32)
        out[:n] = a.numpy()
        return jnp.asarray(out)
    want = pe.build_rows_pallas(
        jnp.asarray(q).astype(jnp.bfloat16),
        jnp.asarray(pe.prep_pac_planes(bns.pac), jnp.bfloat16),
        jnp.asarray(np.int32(bns.l_pac)), *(pad(a) for a in args[3:]), LQ,
        LT, interpret=True)
    got = build_rows(*args, LQ, LT)
    for name, a, w, width in zip(("lq", "lt", "rq", "rt"), got, want,
                                 (LQ, LT, LQ, LT)):
        np.testing.assert_array_equal(_unpack4(a.numpy(), width),
                                      np.asarray(w).T[:n], err_msg=name)


def test_extend_lr_onchip_matches_packed_rows(packed_case):
    """extend_lr_onchip (rows built from the scalars) equals
    ksw_extend_lr_batched on the native packer's rows, on all eight
    outputs."""
    from bwamem_tpu_torch.ops.extbuild import extend_lr_onchip
    from bwamem_tpu_torch.ops.ksw import ksw_extend_lr_batched
    bns, reads, opt, rid, packs = packed_case
    LQ, LT = 128, 544
    pk = packs[(LQ, LT)]
    g, args = _lanes(bns, reads, rid, pk, LQ)
    g, args = g[:48], args[:3] + tuple(a[:48] for a in args[3:])
    T = lambda k: torch.from_numpy(np.ascontiguousarray(pk[k][g]))  # noqa
    mat = torch.from_numpy(np.asarray(opt.mat, np.int8))
    gap = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
           opt.pen_clip5, opt.pen_clip3, opt.zdrop)
    want = ksw_extend_lr_batched(
        T("lq_pk"), T("lt_pk"), T("llq"), T("llt"), T("rq_pk"), T("rt_pk"),
        T("rlq"), T("rlt"), mat, *gap, T("scs"), T("sqb"), T("srb"),
        T("rmax0"), T("lqv"), T("slv"), LQ=LQ, LT=LT)
    got = extend_lr_onchip(*args, T("llq"), T("llt"), T("rlq"), T("rlt"),
                           T("scs"), mat, *gap, LQ=LQ, LT=LT)
    for name, a, b in zip(("score", "truesc", "qb", "rb", "qe", "re",
                           "aw0", "aw1"), got, want):
        assert torch.equal(a, b), name
