"""Split tables (``mem --shard-tables``): the occ table and the sampled SA
cut by rows into one part per shard of a mesh (bwamem_tpu_torch/ops/fm.py
SplitTable, parallel/mesh.py ShardedKernels(shard_tables=True)), on the
CPU.  The plain versions over 2, 3 and 8 parts against the whole table
and against the JAX package (its split occ4 under shard_map on the
8-virtual-device CPU mesh, as tests/test_shard_tables.py runs it); the
kernel sources with 1, 2, 3 and 8 parts, built by g++
(ops/emulate.py); the split engine against JAX's split-table engine; the
CLI against the goldens.  Every output is an integer or SAM text: the
tolerance is zero throughout.

The bundled index has 1,641 occ rows and 26,251 SA rows: 2 and 8 parts
do not divide them, 3 divides the occ table."""

import copy
import io
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwamem_tpu_torch.ops import emulate
from bwamem_tpu_torch.ops import fm as tfm
from bwamem_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundled(data_dir):
    from bwamem_tpu_torch.index import load_index
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    return fm, bns


@pytest.fixture(params=[False, True], ids=["i32", "i64"])
def both(request, ref_index, bundled, monkeypatch):
    """(JAX index, port index) of the bundled genome; i64 forces int64
    coordinates and an int64 sampled SA."""
    from bwamem_tpu.ops.fm import DeviceFmIndex as JaxIndex
    if request.param:
        monkeypatch.setenv("BWAMEM_TPU_FORCE_I64", "1")
    return (JaxIndex.from_host(ref_index[0]),
            tfm.DeviceFmIndex.from_host(bundled[0]))


def _boundary_keys(d, parts: int) -> np.ndarray:
    """Keys whose occ rows are the first and last row of each part, and
    -1, 0, primary and its neighbours, seq_len - 1 and seq_len."""
    rows = tfm.SplitTable.part_rows(d.n_blocks, parts)
    edge = set()
    for i in range(parts):
        lo, hi = i * rows, min((i + 1) * rows, d.n_blocks)
        edge.update(r for r in (lo, hi - 1) if 0 <= r < d.n_blocks)
    kk = np.array(sorted({r * 128 + o for r in edge for o in (0, 1, 127)}),
                  np.int64)
    kk = kk[kk < d.seq_len_int]
    k = kk + (kk >= d.primary_int)        # $-removed position -> key
    p, n = d.primary_int, d.seq_len_int
    return np.concatenate([k, [-1, 0, p - 1, p, p + 1, n - 1, n]])


def _keys(d, parts: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = rng.integers(-1, d.seq_len_int + 1, n).astype(np.int64)
    return np.concatenate([_boundary_keys(d, parts), k])


def test_split_is_contiguous_rows_one_part_per_device(bundled):
    """Each part holds ceil(n / k) rows (the last what is left), copied
    on its own: no part is a view of the whole table."""
    d = tfm.DeviceFmIndex.from_host(bundled[0])
    s = d.split(["cpu"] * 8)
    for table, whole in ((s.blocks, d.blocks), (s.sa, d.sa)):
        rows = -(-whole.shape[0] // 8)
        assert table.rows == rows
        assert [p.shape[0] for p in table.parts] == \
            [rows] * 7 + [whole.shape[0] - 7 * rows]
        assert torch.equal(torch.cat(table.parts), whole)
        for p in table.parts:
            assert p.untyped_storage().nbytes() == p.numel() * \
                p.element_size()
    assert (s.n_blocks, s.cdt, s.device) == (d.n_blocks, d.cdt,
                                             torch.device("cpu"))
    with pytest.raises(ValueError, match="2 to 8 parts"):
        d.split(["cpu"] * 9)


@pytest.mark.parametrize("parts", [2, 3, 8])
def test_split_occ4_matches_whole(both, parts):
    _, d = both
    k = torch.from_numpy(_keys(d, parts, 3000, parts))
    s = d.split(["cpu"] * parts)
    got = tfm.occ4(s.blocks, s.primary_int, k)
    assert torch.equal(got, tfm.occ4(d.blocks, d.primary_int, k))


def test_split_occ4_matches_jax_shard_map(both):
    """8 parts against JAX's occ4 over the table row-sharded on the
    8-device CPU mesh (fm.table_axis under shard_map: an all_gather of
    the indices, a local gather and a psum_scatter)."""
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from bwamem_tpu.ops import fm as jfm
    from bwamem_tpu.parallel.mesh import READS_AXIS, make_mesh, pad_to_shards
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    j, d = both
    k = _keys(d, 8, 4096 - len(_boundary_keys(d, 8)), 7)
    blocks = pad_to_shards(np.asarray(j.blocks), 8, 0)

    def body(blocks_l, primary, kk):
        with jfm.table_axis(READS_AXIS):
            return jfm.occ4(blocks_l, primary, kk)

    fn = jax.jit(shard_map(
        body, mesh=make_mesh(8),
        in_specs=(P(READS_AXIS, None), P(), P(READS_AXIS)),
        out_specs=P(READS_AXIS), check_vma=False))
    want = np.asarray(fn(blocks, j.primary, jnp.asarray(k, j.cdt)), np.int64)
    s = d.split(["cpu"] * 8)
    got = tfm.occ4(s.blocks, s.primary_int, torch.from_numpy(k))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("parts", [2, 3, 8])
def test_split_b0_inv_psi_sa_lookup_match_whole_and_jax(both, parts):
    from bwamem_tpu.ops import fm as jfm
    j, d = both
    s = d.split(["cpu"] * parts)
    k = _keys(d, parts, 2000, 10 + parts)
    k = k[(k >= 0) & (k <= d.seq_len_int)]
    kt = torch.from_numpy(k)
    x = kt - (kt > d.primary_int).to(torch.int64)
    x = x[x < d.seq_len_int]
    assert torch.equal(tfm.bwt_b0(s.blocks, x), tfm.bwt_b0(d.blocks, x))
    got = tfm.inv_psi(s.blocks, s.primary_int, s.L2, s.seq_len_int, kt)
    assert torch.equal(got, tfm.inv_psi(d.blocks, d.primary_int, d.L2,
                                        d.seq_len_int, kt))
    for steps in (1024, 3):
        v, o = tfm.sa_lookup_batched(s, kt, steps)
        wv, wo = tfm.sa_lookup_batched(d, kt, steps)
        assert torch.equal(v, wv) and torch.equal(o, wo)
        jv, jo = jfm.sa_lookup_batched(
            j.blocks, j.primary, j.L2, j.seq_len, j.sa, j.sa_intv,
            jnp.asarray(k.astype(np.asarray(j.L2).dtype)), max_steps=steps)
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(v.numpy().astype(np.int64),
                                      np.asarray(jv, np.int64))
        assert v.dtype == d.cdt


# ---- the kernel sources with parts, built by g++ ----

def _index(bundled, parts):
    d = tfm.DeviceFmIndex.from_host(bundled[0])
    return d, (d if parts == 1 else d.split(["cpu"] * parts))


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def gxx():
    if not emulate.available():
        pytest.skip("needs g++ to build the host emulation")


@pytest.mark.parametrize("n", [3, 1641, 26251, (1 << 29) + 5, (1 << 32) - 1,
                               1 << 32, (1 << 40) + 12345, 3 << 43])
@pytest.mark.parametrize("parts", [2, 3, 7, 8])
def test_part_lookup_divides_exactly(gxx, n, parts):
    """The kernels' part lookup (csrc/fm.cuh row_at: a multiply-high of
    32-bit numbers) against Python's division, at the first and last row
    of every part and at random rows, for tables of 3 rows to 2^44."""
    rows = tfm.SplitTable.part_rows(n, parts)
    assert rows >= -(-n // parts) and rows * parts - n < rows + (1 << 17)
    edge = [r for i in range(parts) for r in (i * rows - 1, i * rows)
            if 0 <= r < n] + [n - 1]
    rng = np.random.default_rng(n % 1000 + parts)
    r = np.concatenate([edge, rng.integers(0, n, 4096)]).astype(np.uint64)
    part, off = emulate.part_of(rows, parts, r)
    want = r.astype(object) // rows
    np.testing.assert_array_equal(part, want.astype(np.int64))
    np.testing.assert_array_equal(off, (r.astype(object) - want * rows)
                                  .astype(np.int64))


@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_occ4_source_with_parts(gxx, bundled, parts):
    d, s = _index(bundled, parts)
    k = torch.from_numpy(_keys(d, parts, 5000, 20 + parts))
    past = torch.tensor([128 * d.n_blocks + 1, 1 << 40])
    got = emulate.occ4(s.blocks, s.primary_int, torch.cat([k, past]))
    assert torch.equal(got[:len(k)], tfm.occ4(d.blocks, d.primary_int, k))
    assert not got[len(k):].any()       # past the table: zeros, no read


@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_sa_walk_source_with_parts(gxx, bundled, parts):
    d, s = _index(bundled, parts)
    k = _keys(d, parts, 5000, 30 + parts)
    k = torch.from_numpy(k[k <= d.seq_len_int])
    for steps in (1024, 3):
        v, o = emulate.sa_walk(s, k, steps)
        wv, wo = tfm.sa_lookup_batched(d, k.clamp(min=0), steps)
        neg = k < 0                      # a key below 0 walks nothing
        assert bool(o[neg].all()) and bool((v[neg] == -1).all())
        assert torch.equal(v[~neg], wv[~neg]) and torch.equal(o[~neg],
                                                              wo[~neg])


@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_superstep_source_with_parts(gxx, bundled, data_dir, parts):
    from bwamem_tpu_torch.ops.smem import superstep_plain
    from tests.test_torch_kernels_host import (_bundled_queries,
                                               _superstep_equal)
    d, s = _index(bundled, parts)
    B, L, M, oc = 48, 128, 16, 48
    qp, qlen, act = _bundled_queries(data_dir, B, L)
    lanes = (_T(qp), _T(qlen), torch.ones(B, dtype=torch.int64), _T(act),
             _T(np.minimum(29, qlen).astype(np.int32)),
             torch.full((B,), 10, dtype=torch.int32), L, M, oc)
    got = emulate.superstep(s, *lanes)
    _, slot = _superstep_equal(got, superstep_plain(d, *lanes), oc)
    assert bool(slot.any())


@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_iter_step_source_with_parts(gxx, bundled, parts):
    from bwamem_tpu_torch.ops.smem import smem_iter_step_plain
    from tests.test_torch_kernels_host import _long_queries
    d, s = _index(bundled, parts)
    B, L, M = 16, 128, 16
    qp, qlen, _ = _long_queries(bundled[1], B, L, 40 + parts)
    rng = np.random.default_rng(parts)
    x = (rng.random(B) * qlen).astype(np.int32)
    x[:4] = 0
    lanes = (_T(qp), _T(qlen), _T(x), torch.ones(B, dtype=torch.int64),
             torch.ones(B, dtype=torch.bool),
             _T(np.minimum(29, qlen).astype(np.int32)),
             torch.full((B,), 10, dtype=torch.int32), L, M, 12)
    got = emulate.smem_iter_step(s, *lanes)
    want = smem_iter_step_plain(d, *lanes)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a.long(), b.long()), i
    assert bool(got[8].any())                    # some lanes re-seed


# ---- the engine and the CLI ----

def _fields(regs):
    """The region fields tests/test_shard_tables.py compares."""
    return [[(p.rb, p.re, p.qb, p.qe, p.score, p.truesc, p.csub, p.w,
              p.seedcov) for p in g] for g in regs]


def _tensors(obj, seen=None):
    """Every tensor reachable from obj through attributes, dicts, lists
    and tuples."""
    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (str, bytes, int, float,
                                           np.ndarray, type)):
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
        return
    if isinstance(obj, dict):
        items = list(obj.keys()) + list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return
    for x in items:
        yield from _tensors(x, seen)


def test_split_engine_regions_match_jax(ref_index, bundled, data_dir,
                                        monkeypatch):
    """The port's engine over 8 CPU shards with split tables against
    JaxSeedingEngine over the 8-device mesh with
    BWAMEM_TPU_SHARD_TABLES=1, on the first 128 SE reads; each shard's
    part holds 1/8 of the rows, and no tensor of the engine or of its
    ShardedKernels holds the whole occ table or the whole SA."""
    import jax
    from bwamem_tpu.config import MemOptions as JaxOptions
    from bwamem_tpu.io.fastq import ChunkReader as JaxReader
    from bwamem_tpu.ops.engine import JaxSeedingEngine
    from bwamem_tpu.parallel.mesh import make_mesh
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.io.fastq import ChunkReader
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    fq = os.path.join(data_dir, "reads_se.fq")
    jfm, jbns = ref_index
    monkeypatch.setenv("BWAMEM_TPU_SHARD_TABLES", "1")
    e8 = JaxSeedingEngine(jfm, mesh=make_mesh(8))
    assert e8.kernels.shard_tables
    want = _fields(e8.align_batch(
        JaxOptions(), jfm, jbns, jbns.pac,
        [copy.copy(r) for r in JaxReader(fq).read_chunk(1 << 30)[:128]]))
    monkeypatch.delenv("BWAMEM_TPU_SHARD_TABLES")

    fm, bns = bundled
    eng = TorchSeedingEngine(fm, "cpu", mesh=tmesh.make_mesh(8, "cpu"),
                             shard_tables=True)
    assert eng.shard_tables and eng.kernels.shard_tables
    reads = ChunkReader(fq).read_chunk(1 << 30)[:128]
    assert _fields(eng.align_batch(MemOptions(), fm, bns, bns.pac,
                                   [copy.copy(r) for r in reads])) == want

    whole = tfm.DeviceFmIndex.from_host(fm)
    for d in (eng.dfm, eng.kernels.index_on("cpu")):
        assert isinstance(d, tfm.SplitFmIndex)
        for table, full in ((d.blocks, whole.blocks), (d.sa, whole.sa)):
            n = full.shape[0]
            assert len(table.parts) == 8
            assert all(abs(p.shape[0] - n / 8) < 8 for p in table.parts)
    limit = min(whole.blocks.numel() * 4, whole.sa.numel()
                * whole.sa.element_size())
    big = [tuple(t.shape) for t in _tensors((eng, eng.kernels))
           if t.untyped_storage().nbytes() >= limit]
    assert not big, big


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


def _golden(data_dir, name):
    with open(os.path.join(data_dir, name)) as f:
        return [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]


@pytest.mark.parametrize("mesh,flags,reads,golden,route", [
    ("8", [], ["reads_se.fq"], "golden_se.sam", "1"),
    ("8", ["-a", "-M"], ["reads_se.fq"], "golden_se_aM.sam", "1"),
    ("8", [], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam", "1"),
    ("2", ["-v", "4"], ["reads_se.fq"], "golden_se_v4.txt", "1"),
    ("2", [], ["reads_se.fq"], "golden_se.sam", "0"),
], ids=["mesh8_se", "mesh8_se_aM", "mesh8_pe", "mesh2_se_v4",
        "mesh2_se_superstep0"])
def test_mem_shard_tables_matches_golden(data_dir, monkeypatch, mesh, flags,
                                         reads, golden, route):
    """``mem --device cpu --mesh N --shard-tables`` is byte-identical to
    the goldens: the flat route, the -v 4 wave path, and
    BWAMEM_TPU_SUPERSTEP=0, whose iterator steps read every part from
    the mesh's first device."""
    monkeypatch.setenv("BWAMEM_TPU_SUPERSTEP", route)
    err = io.StringIO()
    ret, ours = _run_mem(["--device", "cpu", "--mesh", mesh,
                          "--shard-tables"] + flags
                         + [os.path.join(data_dir, "genome.fa")]
                         + [os.path.join(data_dir, r) for r in reads],
                         stderr=err)
    assert ret == 0, err.getvalue()
    assert f"occ table and SA split over {mesh} devices" in err.getvalue()
    assert ours == _golden(data_dir, golden)


def test_shard_tables_without_mesh_changes_nothing(data_dir):
    ref = os.path.join(data_dir, "genome.fa")
    fq = os.path.join(data_dir, "reads_se1.fq")
    err = io.StringIO()
    ret, ours = _run_mem(["--device", "cpu", "--shard-tables", ref, fq],
                         stderr=err)
    assert ret == 0 and "split over" not in err.getvalue()
    plain = _run_mem(["--device", "cpu", ref, fq])
    assert plain[0] == 0 and ours == plain[1]


def test_shard_tables_with_distributed_exits_1(data_dir):
    err = io.StringIO()
    ret, _ = _run_mem(["--device", "cpu", "--shard-tables", "--distributed",
                       "127.0.0.1:1,2,0", os.path.join(data_dir, "genome.fa"),
                       os.path.join(data_dir, "reads_se1.fq")], stderr=err)
    assert ret == 1
    assert "--shard-tables with --distributed is not ported" in \
        err.getvalue()


def test_microbench_occ4_takes_a_split_table(data_dir):
    """microbench.Bench.gather given an index's occ table split in parts
    (load_occ_table(..., parts=3)) runs occ4 only, and its occ4 equals
    the whole table's on the same keys."""
    from bwamem_tpu_torch import microbench
    outs = {}

    def check(kernel, line, out, args, library=None):
        outs.setdefault(kernel, []).append((line, out))
    prefix = os.path.join(data_dir, "genome.fa")
    for parts in (1, 3):
        table, primary, seq_len = microbench.load_occ_table(prefix, "cpu",
                                                            parts)
        b = microbench.Bench("cpu", emit=lambda ln: None, check=check)
        b.gather(table, [256], "index", primary, seq_len)
    (whole_line, whole), (split_line, split) = outs["occ4"]
    assert torch.equal(whole, split)
    assert split_line["parts"] == ["cpu"] * 3 and "parts" not in whole_line
    assert len(outs["gather_rows"]) == 1     # the whole table's only
