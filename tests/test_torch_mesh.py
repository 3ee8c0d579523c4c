"""The port's reads mesh (bwamem_tpu_torch/parallel/mesh.py) on the CPU,
against the JAX package's (bwamem_tpu/parallel/mesh.py) and against the
goldens.  The outputs are integers and SAM text: the tolerance is
equality throughout.

A CPU mesh is a tuple of CPU devices, its shards running the kernels'
plain versions one after another, the counterpart of the 8 virtual CPU
devices tests/conftest.py gives JAX."""

import copy
import io
import os
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh8():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    from bwamem_tpu.parallel.mesh import make_mesh
    return make_mesh(8)


@pytest.mark.parametrize("n,shards,width", [(0, 4, 1), (5, 4, 1),
                                            (8, 4, 3), (13, 8, 2),
                                            (64, 2, 1)])
def test_pad_to_shards_matches_jax(n, shards, width):
    from bwamem_tpu.parallel.mesh import pad_to_shards as jax_pad
    rng = np.random.default_rng(n)
    a = rng.integers(-50, 50, (n, width)).astype(np.int32)
    got = tmesh.pad_to_shards(a, shards, -1)
    want = jax_pad(a, shards, -1)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(got) % shards == 0


def _pestat_inputs(seed, n=64):
    """Seeded insert sizes, past both ends of the histogram too, and
    orientations with -1 (no observation)."""
    rng = np.random.default_rng(seed)
    isize = rng.integers(-100, 70000, n).astype(np.int64)
    isize[::7] = rng.integers(0, 600, len(isize[::7]))
    orient = rng.integers(-1, 4, n).astype(np.int32)
    return isize, orient


def jax_pestat(isize, orient):
    """JAX pestat_histograms on the 8-device CPU mesh, as numpy."""
    import jax
    from bwamem_tpu.parallel.mesh import pestat_histograms
    counts, hist = pestat_histograms(_jax_mesh8())(jax.numpy.asarray(isize),
                                                   jax.numpy.asarray(orient))
    return np.asarray(counts), np.asarray(hist)


@pytest.mark.parametrize("shards", [2, 4])
def test_pestat_histograms_match_jax(shards):
    isize, orient = _pestat_inputs(shards)
    counts, hist = tmesh.pestat_histograms(tmesh.make_mesh(shards, "cpu"))(
        torch.from_numpy(isize), torch.from_numpy(orient))
    want_c, want_h = jax_pestat(isize, orient)
    assert counts.dtype == torch.int64 and hist.dtype == torch.int32
    assert np.array_equal(counts.numpy(), want_c)
    assert np.array_equal(hist.numpy(), want_h)
    assert int(counts.sum()) == int((orient >= 0).sum())


def _fields(regs):
    """The region fields tests/test_mesh_engine.py compares."""
    return [[(p.rb, p.re, p.qb, p.qe, p.score, p.truesc, p.csub, p.w,
              p.seedcov) for p in g] for g in regs]


def test_sharded_engine_regions_match_jax_mesh(data_dir, monkeypatch):
    """The port's engine over 8 CPU shards against JaxSeedingEngine over
    the 8-device JAX mesh on the first 128 SE reads: the region fields of
    tests/test_mesh_engine.py."""
    from bwamem_tpu.config import MemOptions as JaxOptions
    from bwamem_tpu.index import load_index as jax_load_index
    from bwamem_tpu.io.fastq import ChunkReader as JaxReader
    from bwamem_tpu.ops.engine import JaxSeedingEngine
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import ChunkReader
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    jmesh = _jax_mesh8()
    fq = os.path.join(data_dir, "reads_se.fq")
    jfm, jbns = jax_load_index(os.path.join(data_dir, "genome.fa"))
    jreads = JaxReader(fq).read_chunk(1 << 30)[:128]
    e8 = JaxSeedingEngine(jfm, mesh=jmesh)
    want = _fields(e8.align_batch(JaxOptions(), jfm, jbns, jbns.pac,
                                  [copy.copy(r) for r in jreads]))

    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    reads = ChunkReader(fq).read_chunk(1 << 30)[:128]
    # the lanes each shard's wrapper is given, seen from outside the mesh
    lanes = {"superstep": [], "extend_lr": []}
    for name, fn in (("superstep", "smem_superstep_sa"),
                     ("extend_lr", "ksw_extend_lr_batched")):
        def spy(*a, _name=name, _fn=getattr(tmesh, fn), **kw):
            lanes[_name].append(len(a[1] if _name == "superstep" else a[0]))
            return _fn(*a, **kw)
        monkeypatch.setattr(tmesh, fn, spy)
    eng = TorchSeedingEngine(fm, "cpu", mesh=tmesh.make_mesh(8, "cpu"))
    assert eng.kernels.n == 8
    assert _fields(eng.align_batch(MemOptions(), fm, bns, bns.pac,
                                   [copy.copy(r) for r in reads])) == want
    # two lane groups of 64 (tests/conftest.py), each over every shard
    assert lanes["superstep"] == [8] * 16
    assert lanes["extend_lr"] and len(lanes["extend_lr"]) % 8 == 0


def test_indivisible_lane_width_raises(data_dir, monkeypatch):
    """A launch width the shard count does not divide is refused with the
    JAX engine's error."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, _ = load_index(os.path.join(data_dir, "genome.fa"))
    monkeypatch.setenv("BWAMEM_TPU_LANES", "64")
    with pytest.raises(ValueError, match="lane width 64 not divisible by "
                                         "mesh size 3; adjust "
                                         "BWAMEM_TPU_LANES/WAVE"):
        TorchSeedingEngine(fm, "cpu", mesh=tmesh.make_mesh(3, "cpu"))
    monkeypatch.setenv("BWAMEM_TPU_LANES", "96")
    monkeypatch.setenv("BWAMEM_TPU_SA_SLICE", "3072")
    monkeypatch.setenv("BWAMEM_TPU_WAVE", "100")
    with pytest.raises(ValueError, match="lane width 100 not divisible"):
        TorchSeedingEngine(fm, "cpu", mesh=tmesh.make_mesh(3, "cpu"))


def _sw_lanes(seed, B, LQ, LT):
    """B seeded extend2 lanes: packed query/target rows, lengths, bands."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, LQ)).astype(np.int8)
    t = rng.integers(0, 4, (B, LT)).astype(np.int8)
    qlen = rng.integers(1, LQ + 1, B).astype(np.int32)
    tlen = rng.integers(1, LT + 1, B).astype(np.int32)
    pk = lambda a: a[:, 0::2] | (a[:, 1::2] << np.int8(4))  # noqa: E731
    return (pk(q), pk(t), qlen, tlen,
            rng.integers(0, 30, B).astype(np.int32),
            rng.integers(0, 10, B).astype(np.int32),
            rng.integers(0, 40, B).astype(np.int32))


@pytest.mark.parametrize("B,shards", [(5, 4), (3, 8), (16, 2)])
def test_uneven_lanes_come_back_in_order(data_dir, B, shards):
    """Lanes that do not split evenly (a wave path group is its requests'
    count) go out in contiguous blocks and come back in lane order, equal
    to the unsharded call, each shard's part its block's length (a shard
    without lanes gets none, and its wrapper launches nothing)."""
    from bwamem_tpu_torch.config import MemOptions, fill_scmat
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    from bwamem_tpu_torch.ops.ksw import ksw_extend2_batched
    opt = MemOptions()
    mat = torch.as_tensor(np.asarray(fill_scmat(opt.a, opt.b), np.int8))
    q, t, ql, tl, w, eb, h0 = _sw_lanes(B, B, 128, 160)
    T = torch.from_numpy
    args = (q, t, ql, tl, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
            w, eb, opt.zdrop, h0)
    fm, _ = load_index(os.path.join(data_dir, "genome.fa"))
    sk = tmesh.ShardedKernels(tmesh.make_mesh(shards, "cpu"),
                              DeviceFmIndex.from_host(fm))
    got = sk.extend2(*args, LQ=128, LT=160)
    want = ksw_extend2_batched(*(T(a) if isinstance(a, np.ndarray) else a
                                 for a in args), LQ=128, LT=160)
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)
    assert [len(p) for p in got[0].parts] == [
        hi - lo for lo, hi in tmesh.shard_bounds(B, shards)]


def _lane_group(data_dir, B, L=128):
    """The first B SE reads as a lane group: packed queries and lengths."""
    from bwamem_tpu_torch.core.pipeline import encode_read
    from bwamem_tpu_torch.io.fastq import ChunkReader
    reads = ChunkReader(os.path.join(data_dir, "reads_se.fq")) \
        .read_chunk(1 << 30)[:B]
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    for i, r in enumerate(reads):
        encode_read(r)
        q[i, :len(r.seq_nt4)] = r.seq_nt4
        qlen[i] = len(r.seq_nt4)
    return q[:, 0::2] | (q[:, 1::2] << np.int8(4)), qlen


def test_sharded_smem1_and_sa_lookup_match_unsharded(data_dir):
    """sharded_smem1 (an iterator step over the mesh) and
    sharded_sa_lookup over 4 CPU shards equal the unsharded calls."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex, sa_lookup
    from bwamem_tpu_torch.ops.smem import smem_iter_step
    fm, _ = load_index(os.path.join(data_dir, "genome.fa"))
    d = DeviceFmIndex.from_host(fm)
    B = 32
    qpk, qlen = _lane_group(data_dir, B)
    x = np.zeros(B, np.int32)
    mi = np.ones(B, np.int64)
    act = np.ones(B, np.uint8)
    sl = np.full(B, 28, np.int32)
    sw = np.full(B, 10, np.int32)
    mesh = tmesh.make_mesh(4, "cpu")
    got = tmesh.sharded_smem1(mesh, d, L=128, M=16, M_OUT=12)(
        qpk, qlen, x, mi, act, sl, sw)
    T = torch.from_numpy
    want = smem_iter_step(d, T(qpk), T(qlen), T(x), T(mi), T(act), T(sl),
                          T(sw), L=128, M=16, M_OUT=12)
    assert len(got) == len(want) == 17
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    keys = np.random.default_rng(1).integers(0, d.seq_len_int, 1000)
    gv, go = tmesh.sharded_sa_lookup(mesh, d, max_steps=64)(keys)
    wv, wo = sa_lookup(d, T(keys), 64)
    assert torch.equal(gv.cpu(), wv) and torch.equal(go.cpu(), wo)


def _run_mem(args, stderr=None):
    """SAM lines (without @PG) and the return code of the port's
    main_mem; `stderr`, a StringIO, takes what it writes there."""
    from bwamem_tpu_torch import cli
    out = io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout = out
    if stderr is not None:
        sys.stderr = stderr
    try:
        ret = cli.main_mem(args)
    finally:
        sys.stdout, sys.stderr = old
    return ret, [ln for ln in out.getvalue().split("\n")
                 if not ln.startswith("@PG")]


@pytest.mark.parametrize("flags,reads,golden,route", [
    ([], ["reads_se.fq"], "golden_se.sam", "1"),
    (["-a", "-M"], ["reads_se.fq"], "golden_se_aM.sam", "1"),
    ([], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam", "1"),
    (["-v", "4"], ["reads_se.fq"], "golden_se_v4.txt", "1"),
    ([], ["reads_se.fq"], "golden_se.sam", "0"),
], ids=["se", "se_aM", "pe", "se_v4", "se_superstep0"])
def test_mem_mesh2_matches_golden(data_dir, monkeypatch, flags, reads,
                                  golden, route):
    """``mem --device cpu --mesh 2`` is byte-identical to the goldens; the
    -v 4 trace runs the sharded extend2/global2 wave path, and
    BWAMEM_TPU_SUPERSTEP=0 the iterator steps on the first device with
    the sharded SA walk."""
    monkeypatch.setenv("BWAMEM_TPU_SUPERSTEP", route)
    err = io.StringIO()
    ret, ours = _run_mem(["--device", "cpu", "--mesh", "2"] + flags + [
        os.path.join(data_dir, "genome.fa")]
        + [os.path.join(data_dir, r) for r in reads], stderr=err)
    assert ret == 0, err.getvalue()
    assert "[M::main_mem] reads mesh over 2 devices" in err.getvalue()
    with open(os.path.join(data_dir, golden)) as f:
        want = [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]
    assert ours == want
    if "-v" in flags:
        assert '"n_global2"' in err.getvalue()
