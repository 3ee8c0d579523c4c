"""The human-scale regime of the port on the CPU, at a small size:
``python -m bwamem_tpu_torch.run3g`` (its plain versions, ``cpu``)
against the repository's ``tools/run3g.py host`` on a 0.5 Mbp set made
by tools/make_gbp_fasta.py, the port's ``index`` and
tools/sample_reads.py, byte for byte, with and without the int64 paths
forced (BWAMEM_TPU_FORCE_I64, BWAMEM_TPU_NSA_FORCE_I64); the index files
against the JAX package's ``cli index``; the coordinate dtype and the
.sa8 cap at their edges; the tables' upload without a host copy; and the
extension-row builder at reference begins past 2^32 doubled bases."""

import json
import os
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# launch widths small enough for the plain versions (the output does not
# depend on them)
WIDTHS = {"BWAMEM_TPU_LANES": "256", "BWAMEM_TPU_SA_SLICE": "2048",
          "BWAMEM_TPU_WAVE": "256", "BWAMEM_TPU_WAVE_EXT": "512"}
FORCED = {"BWAMEM_TPU_FORCE_I64": "1", "BWAMEM_TPU_NSA_FORCE_I64": "1"}
EXTS = (".bwt", ".sa", ".sa8", ".pac", ".ann", ".amb")
N_SE, N_PAIRS = 300, 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cmd, out=subprocess.DEVNULL, env=None):
    subprocess.run([sys.executable] + cmd, check=True, cwd=ROOT, stdout=out,
                   stderr=subprocess.DEVNULL,
                   env=dict(os.environ, **(env or {})))


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """A 0.5 Mbp genome with 300 SE reads and 150 pairs, indexed three
    ways: by the port (``plain``), by the port with the int64 SA-IS and
    coordinates forced (``forced``, the reads copied beside it), and by
    the JAX package's ``cli index`` (``jax``)."""
    root = tmp_path_factory.mktemp("run3g")
    plain, forced, jax = (str(root / n) for n in ("plain", "forced", "jax"))
    _run(["tools/make_gbp_fasta.py", plain, "--mbp", "0.5"])
    _run(["tools/sample_reads.py", os.path.join(plain, "genome.fa"),
          "--n-se", str(N_SE), "--n-pe", str(N_PAIRS)])
    for d in (forced, jax):
        os.makedirs(d)
        for f in ("genome.fa", "reads_se.fq", "reads_1.fq", "reads_2.fq"):
            with open(os.path.join(plain, f), "rb") as a, \
                    open(os.path.join(d, f), "wb") as b:
                b.write(a.read())
    _run(["-m", "bwamem_tpu_torch.cli", "index",
          os.path.join(plain, "genome.fa")])
    _run(["-m", "bwamem_tpu_torch.cli", "index",
          os.path.join(forced, "genome.fa")], env=FORCED)
    _run(["-m", "bwamem_tpu.cli", "index", os.path.join(jax, "genome.fa")])
    return {"plain": plain, "forced": forced, "jax": jax}


def _host_tool(data, pe):
    """tools/run3g.py host's stdout on all the reads of data."""
    return subprocess.run(
        [sys.executable, "tools/run3g.py", "host", data, str(N_SE)]
        + (["--pe"] if pe else []), cwd=ROOT, capture_output=True,
        check=True).stdout.decode()


def _run3g(argv, capsys, monkeypatch, env=None):
    """run3g.main(argv) in this process at the test widths: (return
    code, stdout, stderr)."""
    from bwamem_tpu_torch import run3g
    for k, v in dict(WIDTHS, **(env or {})).items():
        monkeypatch.setenv(k, v)
    capsys.readouterr()
    rc = run3g.main(argv)
    got = capsys.readouterr()
    return rc, got.out, got.err


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_cpu_matches_host_tool(sets, capsys, monkeypatch, pe):
    """run3g cpu on every read: the records of tools/run3g.py host, byte
    for byte; its stderr names the coordinate dtype and the dense SA
    sample."""
    rc, out, err = _run3g(["cpu", sets["plain"], str(N_SE)]
                          + (["--pe"] if pe else []), capsys, monkeypatch)
    assert rc == 0
    assert out == _host_tool(sets["plain"], pe)
    assert out.count("\n") == N_SE
    assert "cdt=int32 sa_intv=8 " in err and "[run3g] stats diff {" in err


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
def test_forced_int64_matches_unforced(sets, capsys, monkeypatch, pe):
    """With the int64 SA-IS and coordinates forced for the index build
    and the run: the index files equal the JAX package's cli index's, and
    run3g cpu's records equal the unforced run's and tools/run3g.py host's
    on the same index."""
    for ext in EXTS:
        with open(os.path.join(sets["forced"], "genome.fa" + ext), "rb") as a, \
                open(os.path.join(sets["jax"], "genome.fa" + ext), "rb") as b:
            assert a.read() == b.read(), ext
    flag = ["--pe"] if pe else []
    _, unforced, _ = _run3g(["cpu", sets["plain"], str(N_SE)] + flag, capsys,
                            monkeypatch)
    rc, out, err = _run3g(["cpu", sets["forced"], str(N_SE)] + flag, capsys,
                          monkeypatch, FORCED)
    assert rc == 0 and "cdt=int64 " in err
    assert out == unforced == _host_tool(sets["forced"], pe)


def test_bench_prints_one_json_line(sets, capsys, monkeypatch):
    """--bench-chunks 1 adds exactly one JSON line after the records,
    with tools/run3g.py's fields, and the bench's stats line on stderr."""
    rc, out, err = _run3g(["cpu", sets["plain"], "20", "--bench-chunks", "1",
                           "--bench-rep", "1"], capsys, monkeypatch)
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 21
    assert [ln for ln in lines if ln.startswith("{")] == lines[-1:]
    line = json.loads(lines[-1])
    assert sorted(line) == ["metric", "unit", "value", "vs_baseline"]
    assert line["metric"] == "mem_align_throughput_3g"
    assert line["unit"] == "reads/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 1199.0, 4)
    assert "[run3g] stats bench {" in err


def test_host_mode_makes_no_cuda_context(sets, capsys, monkeypatch):
    """run3g host: the host oracle's records, no engine, CUDA never
    initialised."""
    rc, out, err = _run3g(["host", sets["plain"], "100"], capsys,
                          monkeypatch)
    assert rc == 0 and out.count("\n") == 100
    assert "engine up" not in err
    assert not torch.cuda.is_initialized()


def test_cuda_mode_refuses_without_a_card(sets, capsys, monkeypatch):
    """run3g cuda where there is no card exits 1 and prints nothing on
    stdout: it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run3g(["cuda", sets["plain"], "10"], capsys, monkeypatch)
    assert rc == 1 and out == "" and "no CUDA device" in err


@pytest.mark.parametrize("mode", ["host", "cpu"])
def test_profile_needs_the_card(sets, capsys, monkeypatch, mode):
    """--profile traces the card's work: refused in the host and CPU
    modes, before anything is loaded."""
    with pytest.raises(SystemExit) as e:
        _run3g([mode, sets["plain"], "10", "--profile", "x"], capsys,
               monkeypatch)
    assert e.value.code == 2
    assert "cuda mode only" in capsys.readouterr().err


def test_device_busy_is_the_union_of_device_spans():
    """The card's busy seconds: overlapping and nested device spans
    counted once, the host's events left out."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType
    from bwamem_tpu_torch.run3g import device_busy

    def ev(dev, start, end):
        return NS(device_type=dev, time_range=NS(start=start, end=end))
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [ev(cuda, 50, 60), ev(cuda, 0, 10), ev(cuda, 5, 20),
              ev(cuda, 6, 8), ev(cpu, 0, 1000), ev(cuda, 20, 25),
              ev(cuda, 100, 101)]
    busy, n = device_busy(NS(events=lambda: events))
    assert n == 6 and busy == pytest.approx((25 + 10 + 1) / 1e6)
    assert device_busy(NS(events=lambda: [ev(cpu, 0, 5)])) == (0.0, 0)


def test_stage_timer_adds_every_call():
    """bench.timed adds each call's seconds to its stage, a call that
    raises too, and returns what the function returns."""
    from bwamem_tpu_torch.bench import timed
    stages = {}

    def f(x):
        if x < 0:
            raise ValueError(x)
        return 2 * x
    g = timed(stages, "f", f)
    assert g(3) == 6 and stages["f"] > 0
    first = stages["f"]
    with pytest.raises(ValueError):
        g(-1)
    assert stages["f"] > first and list(stages) == ["f"]


@pytest.mark.parametrize("seq_len,want", [
    ((1 << 31) - 3, torch.int32), ((1 << 31) - 2, torch.int64),
    (1 << 31, torch.int64), (1 << 33, torch.int64), (1000, torch.int32)])
def test_coordinate_dtype_at_its_edge(monkeypatch, seq_len, want):
    """int32 while seq_len + 2 < 2^31 (the JAX package's rule), int64
    from there on, and int64 at any size when forced."""
    from bwamem_tpu_torch.ops.fm import coordinate_dtype
    monkeypatch.delenv("BWAMEM_TPU_FORCE_I64", raising=False)
    assert coordinate_dtype(seq_len) == want
    monkeypatch.setenv("BWAMEM_TPU_FORCE_I64", "1")
    assert coordinate_dtype(seq_len) == torch.int64


@pytest.mark.parametrize("seq_len,want", [
    (1000, 16), ((1 << 26) - 1, 16), (1 << 26, 32), (1 << 33, 32)])
def test_interval_buffer_at_its_edge(sets, monkeypatch, seq_len, want):
    """The SMEM interval buffer: 16 entries below 2^26 doubled bases, 32
    from there on; BWAMEM_TPU_SMEM_M sets it at any size."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    from bwamem_tpu_torch.ops.seeding import BatchedSeeder, interval_buffer
    assert interval_buffer(seq_len) == want
    fm, _ = load_index(os.path.join(sets["plain"], "genome.fa"))
    d = DeviceFmIndex.from_host(fm)
    d.seq_len_int = seq_len
    monkeypatch.delenv("BWAMEM_TPU_SMEM_M", raising=False)
    assert BatchedSeeder(d, fm, None, None).M == want
    monkeypatch.setenv("BWAMEM_TPU_SMEM_M", "8")
    assert BatchedSeeder(d, fm, None, None).M == 8


@pytest.mark.parametrize("cap", [None, 1 << 20, 3])
def test_dense_sa_cap_at_its_edge(monkeypatch, cap):
    """A .sa8 sample serves up to the cap (2048 MiB, the JAX package's
    default) inclusive, not one byte past it."""
    from bwamem_tpu_torch.ops import fm as tfm
    if cap is None:
        cap = 2048 << 20
        assert tfm.SA8_MAX_BYTES == cap
    else:
        monkeypatch.setattr(tfm, "SA8_MAX_BYTES", cap)
    assert tfm.dense_sa_fits(cap - 1) and tfm.dense_sa_fits(cap)
    assert not tfm.dense_sa_fits(cap + 1)


def test_from_host_takes_the_sample_by_the_cap(sets, monkeypatch):
    """from_host on the 0.5 Mbp index: the .sa8 sample (interval 8) at a
    cap of exactly its bytes, the sparse .sa (interval 32) one byte
    below; the values equal the host index's either way."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import fm as tfm
    fm, _ = load_index(os.path.join(sets["plain"], "genome.fa"))
    for cap, intv, host in ((fm.sa8.nbytes, 8, fm.sa8),
                            (fm.sa8.nbytes - 1, 32, fm.sa)):
        monkeypatch.setattr(tfm, "SA8_MAX_BYTES", cap)
        d = tfm.DeviceFmIndex.from_host(fm)
        assert d.sa_intv == intv
        assert np.array_equal(d.sa.numpy(), host)


def test_from_host_makes_no_host_copy_of_a_table(sets, monkeypatch):
    """from_host's tables equal the host index's (the occ rows as the JAX
    package repacks them, the final block zero-padded; the sample in the
    coordinate dtype), also
    when uploaded in slices of 1,000 rows, and the host memory numpy
    allocates meanwhile stays under a tenth of the occ table: the tensor
    itself is the one copy (torch's own allocations are not traced)."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import fm as tfm
    from bwamem_tpu.ops.fm import _uniform_blocks
    fm, _ = load_index(os.path.join(sets["plain"], "genome.fa"))
    want = _uniform_blocks(fm.bwt, int(fm.seq_len)).view(np.int32)
    for rows in (None, 1000):
        if rows:
            monkeypatch.setattr(tfm, "UPLOAD_ROWS", rows)
        tracemalloc.start()
        d = tfm.DeviceFmIndex.from_host(fm)
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert np.array_equal(d.blocks.numpy(), want)
        assert d.sa.dtype == torch.int32
        assert np.array_equal(d.sa.numpy(), fm.sa8)
        assert peak < d.blocks.nbytes // 10, peak


@pytest.mark.parametrize("LQ,LT", [(128, 544), (256, 800)])
def test_build_rows_at_wide_reference_begins(LQ, LT):
    """The row builder's host emulation (csrc/extbuild.cu built by g++)
    against the plain version on a 2^31 + 2^20 + 5 base reference: seeds
    on the reverse strand begin past 2^32 doubled bases, on the forward
    strand past 2^31.  The pac is allocated lazily; random bytes are
    written only where the windows read."""
    from bwamem_tpu_torch.ops import emulate
    from bwamem_tpu_torch.ops.extbuild import build_rows_plain
    l_pac, B, W = (1 << 31) + (1 << 20) + 5, 512, 256
    rng = np.random.default_rng(LQ)
    pac = np.zeros((l_pac + 3) // 4, np.uint8)
    pac[:1 << 12] = rng.integers(0, 256, 1 << 12)
    pac[-(1 << 12):] = rng.integers(0, 256, 1 << 12)
    rid = rng.integers(0, 64, B).astype(np.int32)
    slen = rng.integers(19, 60, B)
    qb0 = rng.integers(0, 60, B)
    lquery = np.minimum(qb0 + slen + rng.integers(0, 100, B), W)
    end = np.where(np.arange(B) % 2 == 0, 2 * l_pac, l_pac)
    rmax1 = end - rng.integers(0, 2000, B)
    rb0 = rmax1 - slen - rng.integers(0, LT // 2, B)
    rmax0 = rb0 - rng.integers(0, LT // 2, B)
    assert rb0.max() > 1 << 32 and (rb0[1::2] > 1 << 31).all()
    args = (torch.from_numpy(rng.integers(0, 4, (64, W)).astype(np.int8)),
            torch.from_numpy(pac), l_pac, torch.from_numpy(rid),
            torch.from_numpy(qb0.astype(np.int32)),
            torch.from_numpy(slen.astype(np.int32)), torch.from_numpy(rb0),
            torch.from_numpy(rmax0), torch.from_numpy(rmax1),
            torch.from_numpy(lquery.astype(np.int32)), LQ, LT)
    for a, b in zip(emulate.build_rows(*args), build_rows_plain(*args)):
        assert torch.equal(a, b)
