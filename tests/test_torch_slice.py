"""The port's `mem` end to end on the CPU (bwamem_tpu_torch.cli --device
cpu, the kernels' plain versions): byte-identical to the goldens (the
-v 4/-v 5 traces included), to the JAX engine and to the host engine (a
seed-rich chunk, a set chunk size); the package imports no JAX; the
option not ported yet refuses instead of serving quietly."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops: one intra-op
    thread is faster, and keeps parallel test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_mem(module, args, stderr=None):
    """SAM lines (without @PG) and the return code of <module>.main_mem;
    `stderr`, a StringIO, takes what it writes there."""
    out = io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout = out
    if stderr is not None:
        sys.stderr = stderr
    try:
        ret = module.main_mem(args)
    finally:
        sys.stdout, sys.stderr = old
    return ret, [ln for ln in out.getvalue().split("\n")
                 if not ln.startswith("@PG")]


def device_stats(stderr_text):
    tag = "[M::main_mem] device stats: "
    return next(json.loads(ln[len(tag):]) for ln in stderr_text.splitlines()
                if ln.startswith(tag))


def load_golden(path):
    with open(path) as f:
        return [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]


@pytest.mark.parametrize("flags,reads,golden", [
    ([], ["reads_se.fq"], "golden_se.sam"),
    (["-a", "-M"], ["reads_se.fq"], "golden_se_aM.sam"),
    ([], ["reads_1.fq", "reads_2.fq"], "golden_pe.sam"),
], ids=["se", "se_aM", "pe"])
def test_mem_matches_golden(data_dir, flags, reads, golden):
    from bwamem_tpu_torch import cli
    ret, ours = run_mem(cli, ["--device", "cpu"] + flags + [
        os.path.join(data_dir, "genome.fa")]
        + [os.path.join(data_dir, r) for r in reads])
    assert ret == 0
    assert ours == load_golden(os.path.join(data_dir, golden))


def test_mem_matches_jax_engine(data_dir, tmp_path):
    """The same reads through both engines: the first 128 pairs."""
    from bwamem_tpu import cli as jax_cli
    from bwamem_tpu_torch import cli
    paths = []
    for name in ("reads_1.fq", "reads_2.fq"):
        with open(os.path.join(data_dir, name)) as f:
            head = f.readlines()[:4 * 128]
        p = tmp_path / name
        p.write_text("".join(head))
        paths.append(str(p))
    ref = os.path.join(data_dir, "genome.fa")
    ret_j, want = run_mem(jax_cli, ["--engine", "jax", ref] + paths)
    ret_t, got = run_mem(cli, ["--device", "cpu", ref] + paths)
    assert ret_j == ret_t == 0
    assert got == want
    assert len(got) > 256


def test_package_imports_no_jax():
    code = ("import sys, bwamem_tpu_torch.cli, bwamem_tpu_torch.ops.engine;"
            "assert 'jax' not in sys.modules, 'jax imported'")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    for root, _, files in os.walk(os.path.join(REPO, "bwamem_tpu_torch")):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert "import jax" not in text and "from jax" not in text, \
                    name


def test_unported_routes_refuse(data_dir):
    """The options that are not ported are refused (the CLI exits 1): the
    JAX package's --engine and devices."""
    from bwamem_tpu_torch import cli
    ref = os.path.join(data_dir, "genome.fa")
    fq = os.path.join(data_dir, "reads_se1.fq")
    for opt in (["--engine", "jax"], ["--device", "tpu"]):
        assert run_mem(cli, opt + [ref, fq])[0] == 1


@pytest.mark.parametrize("flags,reads,golden", [
    (["-v", "4"], ["reads_se.fq"], "golden_se_v4.txt"),
    (["-v", "4"], ["reads_1.fq", "reads_2.fq"], "golden_pe_v4.txt"),
    (["-v", "5"], ["reads_se1.fq"], "golden_se1_v5.txt"),
], ids=["se_v4", "pe_v4", "se1_v5"])
def test_mem_trace_matches_golden(data_dir, flags, reads, golden):
    """The per-read traces of the reference binary (tests/test_trace.py
    holds the JAX engine to the same files): the whole stdout stream,
    trace lines and SAM, through the generator wave path."""
    from bwamem_tpu_torch import cli
    err = io.StringIO()
    ret, ours = run_mem(cli, ["--device", "cpu"] + flags + [
        os.path.join(data_dir, "genome.fa")]
        + [os.path.join(data_dir, r) for r in reads], stderr=err)
    assert ret == 0
    assert ours == load_golden(os.path.join(data_dir, golden))
    assert device_stats(err.getvalue())["wave_rounds"] > 0


def test_chunk_bp_matches_host_engine(data_dir, monkeypatch):
    """BWAMEM_TPU_CHUNK_BP sets the chunk size as in bwamem_tpu.cli: the
    PE insert-size statistics are taken per chunk, so the SAM of the
    bundled pairs in 20 kbp chunks differs from the default and must
    equal the host engine's under the same setting."""
    from bwamem_tpu import cli as jax_cli
    from bwamem_tpu_torch import cli
    args = [os.path.join(data_dir, n)
            for n in ("genome.fa", "reads_1.fq", "reads_2.fq")]
    monkeypatch.setenv("BWAMEM_TPU_CHUNK_BP", "20000")
    err = io.StringIO()
    ret_t, got = run_mem(cli, ["--device", "cpu"] + args, stderr=err)
    ret_h, want = run_mem(jax_cli, ["--engine", "host"] + args)
    assert ret_t == ret_h == 0
    assert got == want
    assert err.getvalue().count("[M::main_mem] read ") > 1
    assert got != load_golden(os.path.join(data_dir, "golden_pe.sam"))


def _repeat_genome(tmp_path):
    """A 1 kbp unit in 24 copies at 0.5% divergence between random
    flanks, indexed, and 128 101 bp reads from the copies (1% error),
    all made from one seed."""
    from bwamem_tpu import cli as jax_cli
    rng = np.random.default_rng(2024)
    unit = rng.integers(0, 4, 1000)
    parts = [rng.integers(0, 4, 3000)]
    for _ in range(24):
        c = unit.copy()
        mut = rng.random(1000) < 0.005
        c[mut] = rng.integers(0, 4, int(mut.sum()))
        parts += [c, rng.integers(0, 4, int(rng.integers(200, 600)))]
    parts.append(rng.integers(0, 4, 3000))
    genome = np.concatenate(parts)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    fa = tmp_path / "rep.fa"
    seq = acgt[genome].tobytes().decode()
    fa.write_text(">rep\n" + "\n".join(seq[i:i + 70]
                                       for i in range(0, len(seq), 70))
                  + "\n")
    assert jax_cli.main(["index", str(fa)]) == 0
    starts = np.cumsum([len(p) for p in parts])
    comp = np.frombuffer(b"TGCA", np.uint8)
    lines = []
    for k in range(128):
        c = int(rng.integers(0, 24))
        lo = int(starts[2 * c]) + int(rng.integers(0, 900))
        r = genome[lo:lo + 101].copy()
        err = rng.random(101) < 0.01
        r[err] = rng.integers(0, 4, int(err.sum()))
        s_ = acgt[r]
        if k % 2:
            s_ = comp[r[::-1]]
        lines.append(f"@r{k}\n{s_.tobytes().decode()}\n+\n{'I' * 101}\n")
    fq = tmp_path / "rep.fq"
    fq.write_text("".join(lines))
    return str(fa), str(fq)


def test_seed_rich_chunk_matches_host_engine(tmp_path):
    """Reads from a repeat have more than 16 seeds each: the chunk takes
    the generator wave path with extend_lr waves, and its SAM equals the
    host engine's."""
    from bwamem_tpu import cli as jax_cli
    from bwamem_tpu_torch import cli
    fa, fq = _repeat_genome(tmp_path)
    err = io.StringIO()
    ret_t, got = run_mem(cli, ["--device", "cpu", fa, fq], stderr=err)
    ret_h, want = run_mem(jax_cli, ["--engine", "host", fa, fq])
    assert ret_t == ret_h == 0
    assert got == want
    st = device_stats(err.getvalue())
    assert st["seed_rich_chunks"] == 1 and st["wave_rounds"] > 0
    assert st["n_extend_lr"] > 0


def test_cuda_device_required(data_dir):
    """--device cuda without a GPU fails; it does not run on the CPU."""
    from bwamem_tpu_torch import cli
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    ref = os.path.join(data_dir, "genome.fa")
    fq = os.path.join(data_dir, "reads_se1.fq")
    assert run_mem(cli, ["--device", "cuda", ref, fq])[0] == 1


def _genome(data_dir):
    """The bundled genome's contigs as ACGTN byte strings."""
    contigs, cur = [], []
    with open(os.path.join(data_dir, "genome.fa"), "rb") as f:
        for ln in f:
            if ln.startswith(b">"):
                if cur:
                    contigs.append(b"".join(cur))
                cur = []
            else:
                cur.append(ln.strip())
    contigs.append(b"".join(cur))
    return contigs


def _long_read_files(tmp_path, data_dir):
    """Long reads from the bundled genome, made from one numpy seed: 1%
    substitutions, an N in a third of them, half on the reverse strand.
    Returns {name: [fastq paths]}: ``se_150_250`` (24 reads of 150 bp and
    24 of 250 bp: the L=256 bucket), ``se_300_600`` (reads of 300-512 bp,
    two exact 512 bp copies, and one 600 bp read past the L=512 bucket)
    and ``pe_2x150`` (40 pairs of 2x150 bp, inserts ~400 bp)."""
    rng = np.random.default_rng(150)
    contigs = _genome(data_dir)
    comp = bytes.maketrans(b"ACGTN", b"TGCAN")

    def frag(n):
        c = contigs[int(rng.integers(0, len(contigs)))]
        pos = int(rng.integers(0, len(c) - n))
        return bytearray(c[pos:pos + n])

    def noisy(s, exact=False):
        if not exact:
            for j in np.nonzero(rng.random(len(s)) < 0.01)[0]:
                s[j] = b"ACGT"[int(rng.integers(0, 4))]
            if rng.random() < 0.33:
                s[int(rng.integers(0, len(s)))] = ord("N")
        return bytes(s) if rng.random() < 0.5 else bytes(s).translate(
            comp)[::-1]

    def write(name, seqs):
        p = tmp_path / name
        p.write_text("".join(f"@r{k}\n{s.decode()}\n+\n{'I' * len(s)}\n"
                             for k, s in enumerate(seqs)))
        return str(p)
    se = [noisy(frag(n)) for n in [150] * 24 + [250] * 24]
    xl = ([noisy(frag(n)) for n in (300, 350, 400, 450, 500, 512)]
          + [noisy(frag(512), exact=True) for _ in range(2)]
          + [noisy(frag(600))])
    r1, r2 = [], []
    for _ in range(40):
        f = frag(int(rng.integers(350, 450)))
        r1.append(noisy(f[:150]))
        r2.append(noisy(bytearray(bytes(f[-150:]).translate(comp)[::-1])))
    return {"se_150_250": [write("long_se.fq", se)],
            "se_300_600": [write("long_xl.fq", xl)],
            "pe_2x150": [write("long_1.fq", r1), write("long_2.fq", r2)]}


# what each long-read input must show in the stats: its seeding bucket
# and its reads past 512 bp
_LONG_STATS = {"se_150_250": ("chunks_L256", 0),
               "se_300_600": ("chunks_L512", 1),
               "pe_2x150": ("chunks_L256", 0)}


@pytest.fixture(scope="module")
def long_reads(tmp_path_factory, data_dir):
    """The long-read inputs and the host engine's SAM of each."""
    from bwamem_tpu import cli as jax_cli
    tmp = tmp_path_factory.mktemp("long")
    files = _long_read_files(tmp, data_dir)
    ref = os.path.join(data_dir, "genome.fa")
    host = {}
    for name, paths in files.items():
        ret, host[name] = run_mem(jax_cli, ["--engine", "host", ref]
                                  + paths)
        assert ret == 0
    return ref, files, host


@pytest.mark.parametrize("name", sorted(_LONG_STATS))
def test_long_reads_match_host_engine(long_reads, name):
    """150-600 bp reads through --device cpu: the chunk seeds in its
    length bucket (L=256, L=512), extends at LQ=256/512, and only reads
    past 512 bp take the host oracle; the SAM equals the host engine's."""
    from bwamem_tpu_torch import cli
    ref, files, host = long_reads
    err = io.StringIO()
    ret, got = run_mem(cli, ["--device", "cpu", ref] + files[name],
                       stderr=err)
    assert ret == 0
    assert got == host[name]
    st = device_stats(err.getvalue())
    bucket, n_host = _LONG_STATS[name]
    assert st[bucket] == 1
    assert st.get("host_routed_reads", 0) == n_host
    assert st.get("ext_host_lanes", 0) == 0


@pytest.mark.parametrize("route", ["BWAMEM_TPU_SUPERSTEP=0",
                                   "BWAMEM_TPU_ONCHIP_EXT=1"],
                         ids=["superstep0", "onchip_ext"])
@pytest.mark.parametrize("name", ["golden_se", "golden_pe"]
                         + sorted(_LONG_STATS))
def test_routes_match_default(long_reads, data_dir, monkeypatch, route,
                              name):
    """The round-per-launch seeding route and the on-device extension
    rows give the default route's SAM: the goldens and the long-read
    inputs (whose default SAM equals the host engine's)."""
    from bwamem_tpu_torch import cli
    ref, files, host = long_reads
    if name.startswith("golden"):
        reads = (["reads_se.fq"] if name == "golden_se"
                 else ["reads_1.fq", "reads_2.fq"])
        paths = [os.path.join(data_dir, r) for r in reads]
        want = load_golden(os.path.join(data_dir, name + ".sam"))
    else:
        paths, want = files[name], host[name]
    key, val = route.split("=")
    monkeypatch.setenv(key, val)
    # rounds with as few as 4 live reads take the iterator-step launch
    # (the inputs are a few dozen reads)
    monkeypatch.setenv("BWAMEM_TPU_MIN_SEED_WAVE", "4")
    err = io.StringIO()
    ret, got = run_mem(cli, ["--device", "cpu", ref] + paths, stderr=err)
    assert ret == 0
    assert got == want
    if key == "BWAMEM_TPU_SUPERSTEP":
        st = device_stats(err.getvalue())
        assert st["n_smem"] > 0 and st["n_sa"] > 0
