"""The port's `mem` without the native host library and on the routes
its switches select, on the CPU (the kernels' plain versions):

- BWAMEM_TPU_NATIVE_FINALIZE=0 (the library left out: Python chaining,
  the speculative extension cache, the generators' regions and the
  Python finalize), BWAMEM_TPU_NATIVE_REGIONS=0 (the same route with the
  library there for the finalize) and BWAMEM_TPU_SPECULATE=0 (no
  up-front extension: every chunk through the generators' live waves):
  the goldens and the -v 4 trace, byte-identical;
- the unfused seeding route (BWAMEM_TPU_GCAP_PER_LANE=0,
  BWAMEM_TPU_FUSE_SA=0): the SE golden, and its interval arrays and
  seeds equal to the fused route's;
- the Python route's seed lists and speculative cache equal to the JAX
  engine's (bwamem_tpu/ops/engine.py) on the same chunk;
- ``--mesh`` with ``--distributed`` refused."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_JAX_READS = 64   # one lane group of the tests' widths (conftest.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_mem(args, stderr=None):
    """The port's `mem` in this process: its return code and SAM lines
    without @PG."""
    from bwamem_tpu_torch import cli
    out = io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout = out
    if stderr is not None:
        sys.stderr = stderr
    try:
        ret = cli.main_mem(["--device", "cpu"] + args)
    finally:
        sys.stdout, sys.stderr = old
    return ret, [ln for ln in out.getvalue().split("\n")
                 if not ln.startswith("@PG")]


def golden(data_dir, name):
    with open(os.path.join(data_dir, name)) as f:
        return [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]


def stats(err):
    import json
    tag = "[M::main_mem] device stats: "
    return next(json.loads(ln[len(tag):]) for ln in err.splitlines()
                if ln.startswith(tag))


def switch(monkeypatch, setting):
    """Set a route's switch: its variable, and the engine's module
    constant where the engine reads it at import (NATIVE_REGIONS,
    SPECULATE), as tests/test_native_fuzz.py sets the JAX engine's."""
    from bwamem_tpu_torch.ops import engine
    key, val = setting.split("=")
    monkeypatch.setenv(key, val)
    name = key[len("BWAMEM_TPU_"):]
    if name in ("NATIVE_REGIONS", "SPECULATE"):
        monkeypatch.setattr(engine, name, val != "0")


def test_cli_without_native_library_matches_golden(data_dir):
    """`python -m bwamem_tpu_torch.cli mem --device cpu` with
    BWAMEM_TPU_NATIVE_FINALIZE=0 in a process of its own: the SE
    golden."""
    env = dict(os.environ, BWAMEM_TPU_NATIVE_FINALIZE="0",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch.cli", "mem", "--device",
         "cpu", os.path.join(data_dir, "genome.fa"),
         os.path.join(data_dir, "reads_se.fq")],
        cwd=REPO, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    got = [ln for ln in res.stdout.split("\n") if not ln.startswith("@PG")]
    assert got == golden(data_dir, "golden_se.sam")


@pytest.mark.parametrize("setting", ["BWAMEM_TPU_NATIVE_FINALIZE=0",
                                     "BWAMEM_TPU_NATIVE_REGIONS=0",
                                     "BWAMEM_TPU_SPECULATE=0"],
                         ids=["no_native", "native_regions0", "speculate0"])
@pytest.mark.parametrize("flags,reads,gold", [
    (["-a", "-M"], ["reads_se.fq"], "golden_se_aM.sam"),
    ([], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam"),
    (["-v", "4"], ["reads_se.fq"], "golden_se_v4.txt"),
], ids=["se_aM", "pe", "se_v4"])
def test_switches_match_golden(data_dir, monkeypatch, setting, flags, reads,
                               gold):
    """SE -a -M, PE and the -v 4 SE trace under each switch."""
    switch(monkeypatch, setting)
    err = io.StringIO()
    ret, got = run_mem(flags + [os.path.join(data_dir, "genome.fa")]
                       + [os.path.join(data_dir, r) for r in reads],
                       stderr=err)
    assert ret == 0
    assert got == golden(data_dir, gold)
    st = stats(err.getvalue())
    assert st["n_smem"] > 0
    if flags != ["-v", "4"] and setting.endswith("SPECULATE=0"):
        assert st["wave_rounds"] > 0     # the generators' live waves


@pytest.mark.parametrize("setting", ["BWAMEM_TPU_GCAP_PER_LANE=0",
                                     "BWAMEM_TPU_FUSE_SA=0"],
                         ids=["gcap0", "fuse_sa0"])
def test_unfused_route_matches_golden(data_dir, monkeypatch, setting):
    """The superstep alone, then the SA walk as a launch of its own: the
    SE golden."""
    switch(monkeypatch, setting)
    err = io.StringIO()
    ret, got = run_mem([os.path.join(data_dir, "genome.fa"),
                        os.path.join(data_dir, "reads_se.fq")], stderr=err)
    assert ret == 0
    assert got == golden(data_dir, "golden_se.sam")
    st = stats(err.getvalue())
    assert st["n_smem"] > 0 and st["n_sa"] > 0


@pytest.fixture(scope="module")
def port(data_dir):
    """The port's engine on the CPU over the bundled index, its first
    N_JAX_READS SE reads encoded, and the default options."""
    from bwamem_tpu_torch.config import MemOptions, fill_scmat
    from bwamem_tpu_torch.core.pipeline import encode_read
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    fm, bns = load_index(os.path.join(data_dir, "genome.fa"))
    reads = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))
    for r in reads:
        encode_read(r)
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    return TorchSeedingEngine(fm, "cpu"), bns, reads, opt


def test_unfused_arrays_equal_fused(port, monkeypatch):
    """The unfused route's interval arrays and seeds equal the fused
    route's on the bundled reads."""
    from bwamem_tpu_torch.ops.seeding import BatchedSeeder
    eng, _, reads, opt = port
    queries = [r.seq_nt4 for r in reads]
    fused = eng.seeder
    monkeypatch.setenv("BWAMEM_TPU_GCAP_PER_LANE", "0")
    unfused = BatchedSeeder(eng.dfm, eng.fm_host, eng, eng.kernels)
    assert fused.fuse and not unfused.fuse
    outs = []
    for sd in (fused, unfused):
        iv = sd.interval_arrays(opt, queries)
        outs.append((iv, sd.seeds_from_arrays(eng.fm_host, iv, opt)))
    (iv_f, s_f), (iv_u, s_u) = outs
    for a, b in zip(iv_f + s_f, iv_u + s_u):
        np.testing.assert_array_equal(a, b)
    assert len(s_f[1]) > len(reads)


def _chains_key(chains):
    return [[(c.pos, list(map(tuple, c.seeds))) for c in lst]
            for lst in chains]


@pytest.fixture(scope="module")
def jax_route(ref_index, data_dir):
    """The JAX engine's Python route on the same chunk (its
    NATIVE_REGIONS off): the interval streams, the seeds, the chains and
    the speculative cache."""
    from bwamem_tpu.config import MemOptions, fill_scmat
    from bwamem_tpu.core.pipeline import encode_read
    from bwamem_tpu.io.fastq import parse_fastx
    from bwamem_tpu.ops import engine as jeng
    fm, jbns = ref_index
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)
    eng = jeng.JaxSeedingEngine(fm)
    chunk = list(parse_fastx(os.path.join(data_dir, "reads_se.fq")))[
        :N_JAX_READS]
    for r in chunk:
        encode_read(r)
    queries = [r.seq_nt4 for r in chunk]
    streams = eng.seeder.interval_streams(opt, queries, need_x1=False)
    seeds = eng.seeder.seed_positions(fm, streams, opt)
    old = jeng.NATIVE_REGIONS
    jeng.NATIVE_REGIONS = False
    try:
        chains = eng.chain_batch(opt, chunk)
    finally:
        jeng.NATIVE_REGIONS = old
    cache = eng._speculate_extensions(opt, jbns, jbns.pac, chunk, chains)
    return streams, seeds, chains, cache


def _copy_read(r):
    import copy
    return copy.copy(r)


def test_seed_positions_match_jax(port, jax_route):
    """The port's interval streams (the unfused superstep) and
    seed_positions (the SA walk as its own launch) equal the JAX
    engine's list forms on the same reads."""
    eng, _, reads, opt = port
    streams, seeds, _, _ = jax_route
    queries = [r.seq_nt4 for r in reads[:N_JAX_READS]]
    got_streams = eng.seeder.superstep_streams(opt, queries)
    assert got_streams == [[tuple(int(v) for v in p) for p in st]
                           for st in streams]
    got = eng.seeder.seed_positions(eng.fm_host, got_streams, opt)
    assert got == [[tuple(int(v) for v in s) for s in lst] for lst in seeds]
    assert sum(map(len, got)) > N_JAX_READS


def test_speculative_cache_matches_jax(port, jax_route, monkeypatch):
    """The Python chain route's chains, then the speculative cache: its
    keys (_lr_key) and its `.outs` in (read, chain, seed) order, equal to
    the JAX engine's on the same chunk."""
    from bwamem_tpu_torch.ops import engine
    eng, bns, reads, opt = port
    _, _, jchains, jcache = jax_route
    chunk = [_copy_read(r) for r in reads[:N_JAX_READS]]
    monkeypatch.setattr(engine, "NATIVE_REGIONS", False)
    chains = eng.chain_batch(opt, chunk)
    assert _chains_key(chains) == _chains_key(jchains)
    cache = eng._speculate_extensions(opt, bns, bns.pac, chunk, chains)
    assert isinstance(cache, engine.ExtCache)
    assert len(cache.outs) == sum(c.n for lst in chains for c in lst) > 0
    assert [tuple(map(int, o)) for o in cache.outs] == \
        [tuple(map(int, o)) for o in jcache.outs]
    assert set(cache) == set(jcache)
    assert all(tuple(map(int, cache[k])) == tuple(map(int, jcache[k]))
               for k in cache)


def test_mesh_with_distributed_refused(data_dir):
    """--mesh 2 with --distributed exits 1 before any rendezvous."""
    err = io.StringIO()
    ret, _ = run_mem(["--mesh", "2", "--distributed", "127.0.0.1:1,2,0",
                      os.path.join(data_dir, "genome.fa"),
                      os.path.join(data_dir, "reads_se1.fq")], stderr=err)
    assert ret == 1
    assert "--mesh with --distributed" in err.getvalue()
