"""The port's entry points beside its CLI, on the CPU: graft_entry (the
compile check against the JAX iterator step on the same tiny problem,
the sharded dry run on CPU shards), the bench's JSON line, and the
refusal of all three (bench, graft_entry, run_eval) to run on the CPU
when a card was asked for and there is none."""

import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_graft_entry(monkeypatch):
    """The repository's __graft_entry__, whose import re-points the JAX
    compile cache and C++ log level in os.environ: both are restored
    after the test."""
    for key in ("JAX_COMPILATION_CACHE_DIR", "TF_CPP_MIN_LOG_LEVEL"):
        monkeypatch.setenv(key, os.environ.get(key, ""))
        if not os.environ[key]:
            monkeypatch.delenv(key)
    return importlib.import_module("__graft_entry__")


def test_entry_matches_jax_iter_step(jax_graft_entry):
    """entry("cpu") (the plain iterator step) against the JAX
    smem_iter_step (PALLAS=False) on __graft_entry__._tiny_problem's
    inputs: the same queries, then every flag, and ret, n and the
    fetched columns of each pass that did not overflow (the JAX buffers
    are undefined there), tolerance zero."""
    from bwamem_tpu.ops.smem import smem_iter_step as jax_step
    from bwamem_tpu_torch import graft_entry as ge

    fn, args = ge.entry("cpu")
    dfm, q_pk, qlen, x, mi, act, sl, sw = args
    jdfm, (q, jqlen, jx, jmi, jact) = jax_graft_entry._tiny_problem(32, ge.L)
    q = np.asarray(q).astype(np.int8)
    np.testing.assert_array_equal(
        q_pk.numpy(), q[:, 0::2] | (q[:, 1::2] << np.int8(4)))
    for mine, theirs in ((qlen, jqlen), (x, jx), (mi, jmi), (act, jact)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    want = [np.asarray(w) for w in jax_step(
        jdfm.blocks, jdfm.primary, jdfm.L2, jnp.asarray(q), jqlen, jx,
        jnp.asarray(mi.numpy(), jdfm.L2.dtype), jact,
        jnp.asarray(sl.numpy()), jnp.asarray(sw.numpy()), L=ge.L, M=ge.M,
        M_OUT=ge.M_OUT, PALLAS=False)]
    got = [g.numpy() for g in fn(*args)]
    for k in (7, 8, 16):                          # over1, need2, over2
        np.testing.assert_array_equal(got[k], want[k].astype(bool))
    for base, over in ((0, got[7]), (9, got[16])):
        ok = ~over
        g = [a.astype(np.int64) for a in got[base:base + 7]]
        w = [a.astype(np.int64) for a in want[base:base + 7]]
        np.testing.assert_array_equal(g[0][ok], w[0][ok])     # ret
        np.testing.assert_array_equal(g[1][ok], w[1][ok])     # n
        cols = np.arange(ge.M_OUT)[None, :] < np.minimum(g[1], ge.M_OUT)[
            :, None]
        cols &= ok[:, None]
        for k in range(2, 7):                                 # x0..qe
            np.testing.assert_array_equal(g[k][cols], w[k][cols])
    # every read is an exact substring: one full-length SMEM, and the
    # re-seeding pass runs
    assert (got[1] == 1).all() and (got[6][:, 0] == ge.L).all()
    assert got[8].any()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu_shards(n):
    """The dry run over n CPU shards: its checks raise on any mismatch
    (the sharded step against the one-device step, the SA walk against
    the host index, the split tables' regions, the PE SAM against the
    host path), and mates are rescued."""
    from bwamem_tpu_torch import graft_entry as ge
    got = ge.dryrun_multichip(n, "cpu")
    assert got["shards"] == ["cpu"] * n
    assert got["smems"] > 0 and sum(got["pestat_counts"]) == 4 * n
    assert got["regions"] >= got["reads"] == 4 * n
    assert got["rescued"]


def test_graft_entry_main_prints_one_ok_line(capsys):
    from bwamem_tpu_torch import graft_entry as ge
    assert ge.main(["--device", "cpu", "--shards", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["ok"] is True and got["entry"]["smems"] > 0
    assert got["dryrun"]["shards"] == ["cpu"]


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_bench_cpu_prints_the_json_line(monkeypatch, capsys, pe):
    """One chunk, one pass of the bundled reads through the plain
    versions: exactly one stdout line, bench.py's keys and metric
    names."""
    from bwamem_tpu_torch import bench
    for key in bench.WIDTHS:        # bench sets these where they are unset
        monkeypatch.setenv(key, os.environ.get(key, "64"))
    monkeypatch.setenv("BWAMEM_TPU_WAVE_EXT", "128")
    monkeypatch.setenv("BWAMEM_TPU_SA_SLICE", "4096")
    for key, val in (("CHUNKS", "1"), ("PASSES", "1"), ("REP", "1")):
        monkeypatch.setenv("BWAMEM_TPU_BENCH_" + key, val)
    if pe:
        monkeypatch.setenv("BWAMEM_TPU_BENCH_PE", "1")
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert list(got) == ["metric", "value", "unit", "vs_baseline"]
    assert got["metric"] == "mem_align_throughput" + ("_pe" if pe else "")
    assert got["unit"] == "reads/s" and got["value"] > 0
    assert got["vs_baseline"] == round(got["value"] / 1199.0, 4)


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]],
                         ids=["default", "cuda"])
@pytest.mark.parametrize("module", ["bench", "graft_entry", "run_eval"])
def test_entry_points_refuse_without_a_card(monkeypatch, capsys, data_dir,
                                            module, argv):
    """Asked for the card (the default) where there is none, each entry
    point exits non-zero and prints no result: no fallback to the
    CPU."""
    mod = importlib.import_module("bwamem_tpu_torch." + module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ([data_dir] if module == "run_eval" else []) + argv
    assert mod.main(args) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_run_eval_cpu_diffs_against_the_goldens(capsys, data_dir,
                                                monkeypatch, tmp_path):
    """run_eval --device cpu on tests/data: the SE and PE diffs against
    the goldens' records PASS, the counters close the output; a wrong
    host SAM FAILs with exit code 1 and its output beside it."""
    from bwamem_tpu_torch import run_eval
    monkeypatch.setenv("BWAMEM_TPU_WAVE_EXT", "128")
    monkeypatch.setenv("BWAMEM_TPU_SA_SLICE", "4096")
    assert run_eval.main([data_dir, "--device", "cpu", "--n-diff", "600",
                          "--se-host",
                          os.path.join(data_dir, "golden_se.sam"),
                          "--pe-host",
                          os.path.join(data_dir, "golden_pe.sam")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["PASS", "se"],
                                                    ["PASS", "pe"]]
    assert lines[2].startswith("stats ") and len(lines) == 3
    assert json.loads(lines[2][6:])["chunks_L128"] == 2

    with open(os.path.join(data_dir, "golden_se.sam")) as f:
        recs = [ln for ln in f if not ln.startswith("@")][:20]
    host = tmp_path / "host_se.sam"
    host.write_text("".join(recs[:7] + [recs[7].replace("\t", "\tX", 1)]
                            + recs[8:]))
    assert run_eval.main([data_dir, "--device", "cpu", "--n-diff", "20",
                          "--skip-pe", "--se-host", str(host)]) == 1
    assert capsys.readouterr().out.startswith("FAIL se diff: 20 reads")
    assert (tmp_path / "host_se.sam.got").read_text() == "".join(recs)
