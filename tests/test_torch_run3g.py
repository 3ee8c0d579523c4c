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


@pytest.fixture(scope="module")
def bench_run(sets):
    """run3g cpu on 20 reads with a 1-chunk bench, once for the module:
    (return code, stdout, stderr)."""
    import contextlib
    import io
    from bwamem_tpu_torch import run3g
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        for k, v in WIDTHS.items():
            mp.setenv(k, v)
        rc = run3g.main(["cpu", sets["plain"], "20", "--bench-chunks", "1",
                         "--bench-rep", "1"])
    return rc, out.getvalue(), err.getvalue()


def test_bench_prints_one_json_line(bench_run):
    """--bench-chunks 1 adds exactly one JSON line after the records,
    with tools/run3g.py's fields, and the bench's stats line on stderr."""
    rc, out, err = bench_run
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


def _sa8_mib(fm, below):
    """The .sa8 sample's bytes in MiB as a BWAMEM_TPU_SA8_MAX_MB value:
    exactly, or one byte below."""
    return repr((fm.sa8.nbytes - below) / (1 << 20))


@pytest.mark.parametrize("cap", ["exact", "below", "unset"])
def test_sa8_cap_matches_jax(sets, monkeypatch, cap):
    """BWAMEM_TPU_SA8_MAX_MB (float MiB) at the .sa8's own size, one byte
    below it and unset: the port's from_host takes the sample the JAX
    package's from_host takes, and its values are the host index's."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import fm as tfm
    from bwamem_tpu.index import load_index as jax_load_index
    from bwamem_tpu.ops.fm import DeviceFmIndex as JaxDeviceFmIndex
    prefix = os.path.join(sets["plain"], "genome.fa")
    fm, _ = load_index(prefix)
    jfm, _ = jax_load_index(prefix)
    if cap == "unset":
        monkeypatch.delenv("BWAMEM_TPU_SA8_MAX_MB", raising=False)
    else:
        monkeypatch.setenv("BWAMEM_TPU_SA8_MAX_MB",
                           _sa8_mib(fm, cap == "below"))
    d = tfm.DeviceFmIndex.from_host(fm)
    jd = JaxDeviceFmIndex.from_host(jfm)
    assert d.sa_intv == jd.sa_intv == (32 if cap == "below" else 8)
    host = fm.sa8 if d.sa_intv == 8 else fm.sa
    assert np.array_equal(d.sa.numpy(), host)
    assert np.array_equal(np.asarray(jd.sa), host)
    assert tfm.dense_sa_serves(prefix) == (d.sa_intv == 8)


def test_run3g_reads_no_sa8_past_the_cap(sets, capsys, monkeypatch):
    """With the cap one byte below the .sa8, run3g cpu never reads the
    sample (FmIndex.restore_sa8 is not called), walks the sparse .sa
    (sa_intv=32) and prints the records run3g host prints; within the cap
    it reads it."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.index.fmindex import FmIndex
    fm, _ = load_index(os.path.join(sets["plain"], "genome.fa"))
    calls = []
    restore = FmIndex.restore_sa8

    def spy(self, path):
        calls.append(path)
        return restore(self, path)
    monkeypatch.setattr(FmIndex, "restore_sa8", spy)
    _, want, _ = _run3g(["host", sets["plain"], "50"], capsys, monkeypatch)
    assert calls == []
    rc, out, err = _run3g(["cpu", sets["plain"], "50"], capsys, monkeypatch,
                          {"BWAMEM_TPU_SA8_MAX_MB": _sa8_mib(fm, 1)})
    assert rc == 0 and out == want and out.count("\n") == 50
    assert "cdt=int32 sa_intv=32 " in err and calls == []
    rc, out, err = _run3g(["cpu", sets["plain"], "50"], capsys, monkeypatch,
                          {"BWAMEM_TPU_SA8_MAX_MB": _sa8_mib(fm, 0)})
    assert rc == 0 and out == want and "cdt=int32 sa_intv=8 " in err
    assert len(calls) == 1 and calls[0].endswith("genome.fa.sa8")


def test_sa8_nbytes_from_the_header(sets, tmp_path):
    """sa8_nbytes: the loaded sample's bytes from the file's header, None
    without a file or with a short one."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.index.fmindex import sa8_nbytes
    prefix = os.path.join(sets["plain"], "genome.fa")
    fm, _ = load_index(prefix)
    assert sa8_nbytes(prefix + ".sa8") == fm.sa8.nbytes
    assert sa8_nbytes(str(tmp_path / "none.sa8")) is None
    (tmp_path / "short.sa8").write_bytes(b"\0" * 12)
    assert sa8_nbytes(str(tmp_path / "short.sa8")) is None


def _wide_bntseq(mod, l_pac, anns, ambs, pac):
    """A BntSeq of the module mod (the port's or the JAX package's)."""
    return mod.BntSeq(l_pac=l_pac, seed=11, pac=pac,
                      anns=[mod.ContigAnn(off, ln, 0, 0, f"c{i}", "")
                            for i, (off, ln) in enumerate(anns)],
                      ambs=[mod.AmbHole(off, ln, "N") for off, ln in ambs])


def test_bntseq_coordinates_past_2_32():
    """The port's bntseq coordinate functions against the JAX package's
    on a 3.1 G base reference (human_g1k_v37's size: forward positions
    past 2^31, doubled ones past 2^32) of 7 contigs with ambiguity holes
    on both sides of 2^31: depos on both strands, pos2rid, cnt_ambi,
    get_seq (both strands and a window bridging them) and pac_get.  The
    pac is allocated lazily; random bytes are written only where the
    windows read."""
    from bwamem_tpu_torch.index import bntseq as tbs
    from bwamem_tpu.index import bntseq as jbs
    l_pac = 3_101_804_739
    rng = np.random.default_rng(31)
    cuts = np.sort(rng.choice(np.arange(1, l_pac >> 20), 6, replace=False))
    offs = np.concatenate([[0], cuts << 20, [l_pac]])
    anns = [(int(a), int(b - a)) for a, b in zip(offs[:-1], offs[1:])]
    holes = np.sort(np.concatenate([
        rng.integers(0, l_pac - 100, 40),
        rng.integers((1 << 31) - 5000, (1 << 31) + 5000, 8)]))
    ambs = [(int(h), int(rng.integers(1, 60))) for h in holes]
    ambs = [a for a, b in zip(ambs, ambs[1:] + [(l_pac, 0)])
            if a[0] + a[1] < b[0]]
    pac = np.zeros((l_pac + 3) // 4, np.uint8)
    port = _wide_bntseq(tbs, l_pac, anns, ambs, pac)
    jax = _wide_bntseq(jbs, l_pac, anns, ambs, pac)

    def fill(beg, end):
        """Random bytes in the pac where get_seq reads [beg, end) of the
        doubled reference (on either strand)."""
        lo, hi = sorted((beg, end))
        for a, b in ((lo, hi), (2 * l_pac - hi, 2 * l_pac - lo)):
            a, b = max(a, 0) >> 2, (min(b, l_pac) >> 2) + 1
            if a < b:
                pac[a:b] = rng.integers(0, 256, b - a)
    edges = [1 << 31, (1 << 32) - l_pac, l_pac, (1 << 32), 2 * l_pac - 200]
    pos = np.concatenate([rng.integers(0, 2 * l_pac, 200),
                          [e + d for e in edges for d in (-150, -1, 0, 1)],
                          [o + d for o, _ in anns[1:] for d in (-1, 0)],
                          [o + d for o, _ in ambs[:12] for d in (-3, 0, 2)]])
    pos = [int(p) for p in pos if 0 <= p < 2 * l_pac - 200]
    assert max(pos) > 1 << 32 and any(
        (1 << 31) < p < l_pac for p in pos)
    for p in pos:
        assert port.depos(p) == jax.depos(p)
        pf, _ = port.depos(p)
        assert port.pos2rid(pf) == jax.pos2rid(pf)
        for ln in (1, 101, 5000):
            assert port.cnt_ambi(pf, ln) == jax.cnt_ambi(pf, ln)
        for beg, end in ((p, p + 151), (p + 151, p), (p - 3, p + 3)):
            fill(beg, end)
            got = tbs.get_seq(l_pac, pac, beg, end)
            assert np.array_equal(got, jbs.get_seq(l_pac, pac, beg, end))
            assert len(got) in (0, abs(end - beg))
    keys = np.asarray([port.depos(p)[0] for p in pos])
    assert np.array_equal(tbs.pac_get(pac, keys), jbs.pac_get(pac, keys))
    assert len(tbs.get_seq(l_pac, pac, l_pac - 5, l_pac + 5)) == 0


def _chip_smoke():
    """chip_smoke.py as a module (it imports the standard library only
    at its top)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_run3g_log_reads_every_line(sets, bench_run):
    """chip_smoke.py's run3g_log on run3g cpu's stderr (a 1-chunk bench)
    and on the lines of a card's run at 3.1 Gbp: load and engine-up
    seconds, seq_len (past 2^32 there), cdt, sa_intv, the tables' bytes,
    each phase's seconds, the stats and stages lines, the busy share."""
    smoke = _chip_smoke()
    from bwamem_tpu_torch.index import load_index
    fm, _ = load_index(os.path.join(sets["plain"], "genome.fa"))
    rc, _, err = bench_run
    got = smoke.run3g_log(err)
    assert rc == 0 and got["seq_len"] == fm.seq_len
    assert got["cdt"] == "int32" and got["sa_intv"] == "8"
    assert got["table_bytes"] == (fm.seq_len + 127) // 128 * 64 \
        + fm.sa8.nbytes // 2
    assert got["load_s"] >= 0 and got["engine_up_s"] >= 0
    assert got["diff_s"] > 0 and got["bench_s"] > 0
    assert {"stats_diff", "stats_bench", "stages_bench"} <= set(got)
    card = smoke.run3g_log(
        "[run3g] index loaded in 14.07 s (seq_len=6200000000)\n"
        "[run3g] engine up in 3.91 s on cuda:0; cdt=int64 sa_intv=32 "
        "table_bytes=3100000000 occ + 1550000008 sa\n"
        "[run3g] bench device busy: 0.051000 s of 2.040000 s "
        "(9120 device events)\n")
    assert card == {"load_s": 14.07, "seq_len": 6200000000,
                    "engine_up_s": 3.91, "cdt": "int64", "sa_intv": "32",
                    "table_bytes": 4650000008, "device_busy_s": 0.051,
                    "device_events": 9120,
                    "device_busy_share": 0.051 / 2.04}


def test_run_peak_reads_the_childs_own_peak():
    """chip_smoke.py's run_peak: a child's seconds and its own peak RSS
    (its 64 MiB array counted, not the 320 MiB this process holds while
    it runs), and a failing child raises."""
    smoke = _chip_smoke()
    held = np.ones(320 << 20, np.uint8)
    dt, peak = smoke.run_peak(
        ["-c", "import time, numpy as np; a = np.ones(1 << 26, np.uint8); "
         "time.sleep(0.5)"], dict(os.environ))
    assert held.all() and dt > 0 and (1 << 26) < peak < (256 << 20)
    with pytest.raises(subprocess.CalledProcessError):
        smoke.run_peak(["-c", "raise SystemExit(3)"], dict(os.environ))
