"""The port's ``mem --distributed`` (bwamem_tpu_torch/parallel/
multihost.py) across two real processes on the CPU, the counterpart of
tests/test_distributed.py: a gloo rendezvous, each process on its own
stripe of chunks, its records equal to its ``--shard i/2`` twin, the two
together the golden read names; the insert-size histograms reduced over
the processes, equal to the JAX package's; a rendezvous that cannot
complete exits non-zero.  And ``mem --profile`` (torch.profiler): the
same SAM, and a trace in the directory.  The outputs are integers and
SAM text: the tolerance is equality.  Every subprocess runs under a
timeout."""

import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
TIMEOUT = 300

_WORKER = r"""
import json, sys
import numpy as np
from bwamem_tpu_torch.parallel import multihost
multihost.initialize(sys.argv[1], 2, int(sys.argv[2]))
isize = np.load(sys.argv[3])
orient = np.load(sys.argv[4])
counts, hist = multihost.pestat_histograms(isize, orient)
nz = np.nonzero(hist.numpy())
print(json.dumps({"counts": counts.tolist(),
                  "hist": [nz[0].tolist(), nz[1].tolist(),
                           hist.numpy()[nz].tolist()]}))
multihost.shutdown()
"""


def _free_addr() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = "127.0.0.1:%d" % s.getsockname()[1]
    s.close()
    return addr


def _env(**extra):
    """The environment of a subprocess: one intra-op thread each, so the
    processes that run at once do not contend for the cores."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.update(extra)
    return env


def _cli(extra, files=("genome.fa", "reads_se.fq")):
    return [sys.executable, "-m", "bwamem_tpu_torch.cli", "mem", "--device",
            "cpu"] + extra + [os.path.join(DATA, f) for f in files]


def _communicate(procs):
    """(rc, stdout, stderr) of each process, all killed on a timeout."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out")
    return outs


def _records(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@")]


def test_two_process_mem_matches_shard_twins():
    """Two ``--distributed`` processes, chunks of 20,000 bp: each one's
    records equal its ``--shard i/2`` run's, and together they hold
    exactly the golden read names (a stripe renumbers its reads, so a
    hash tie may resolve to the other equal position: names, not
    records, are compared with the golden, as tests/test_distributed.py
    does)."""
    env = _env(BWAMEM_TPU_CHUNK_BP="20000")
    addr = _free_addr()
    procs = [subprocess.Popen(
        _cli(["--distributed", "%s,2,%d" % (addr, i)]),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env,
        text=True) for i in range(2)]
    twins = [subprocess.Popen(
        _cli(["--shard", "%d/2" % i]), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=REPO, env=env, text=True)
        for i in range(2)]
    outs = _communicate(procs + twins)
    body = []
    for i in range(2):
        rc, out, err = outs[i]
        assert rc == 0, err[-2000:]
        assert "distributed: process %d of 2 on cpu" % i in err
        trc, tout, terr = outs[2 + i]
        assert trc == 0, terr[-2000:]
        recs = _records(out)
        assert recs and recs == _records(tout), \
            "process %d drifted from its --shard twin" % i
        body += recs
    with open(os.path.join(DATA, "golden_se.sam")) as f:
        golden = _records(f.read())

    def names(lines):
        return sorted(ln.split("\t")[0] for ln in lines)
    assert names(body) == names(golden)


def jax_pestat(isize, orient):
    """JAX pestat_histograms on the 8-device CPU mesh, as numpy."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-virtual-device CPU mesh")
    from bwamem_tpu.parallel.mesh import make_mesh, pestat_histograms
    counts, hist = pestat_histograms(make_mesh(8))(
        jax.numpy.asarray(isize), jax.numpy.asarray(orient))
    return np.asarray(counts), np.asarray(hist)


def test_two_process_pestat_all_reduce(tmp_path):
    """Each process's own insert-size observations, reduced over the two
    processes with gloo: both see the same counts and histogram, equal
    to JAX pestat_histograms over all the observations."""
    rng = np.random.default_rng(7)
    isize = rng.integers(-100, 70000, 64).astype(np.int64)
    isize[::5] = rng.integers(0, 600, len(isize[::5]))
    orient = rng.integers(-1, 4, 64).astype(np.int32)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    args = []
    for i, (lo, hi) in enumerate(((0, 40), (40, 64))):
        pi, po = tmp_path / f"isize{i}.npy", tmp_path / f"orient{i}.npy"
        np.save(pi, isize[lo:hi])
        np.save(po, orient[lo:hi])
        args.append((str(pi), str(po)))
    addr = _free_addr()
    env = _env(PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(script), addr, str(i), *args[i]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env,
        text=True) for i in range(2)]
    outs = _communicate(procs)
    want_c, want_h = jax_pestat(isize, orient)
    nz = np.nonzero(want_h)
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got["counts"] == want_c.tolist()
        assert got["hist"] == [nz[0].tolist(), nz[1].tolist(),
                               want_h[nz].tolist()]


def test_rendezvous_that_cannot_complete_exits_nonzero():
    """Process 0 of 2 alone: the rendezvous times out
    (BWAMEM_TPU_DIST_TIMEOUT) and mem exits non-zero with no SAM."""
    p = subprocess.run(
        _cli(["--distributed", "%s,2,0" % _free_addr()]),
        capture_output=True, cwd=REPO, text=True, timeout=TIMEOUT,
        env=_env(BWAMEM_TPU_DIST_TIMEOUT="3"))
    assert p.returncode != 0
    assert not _records(p.stdout)


def test_profile_writes_a_trace_and_the_same_sam(tmp_path):
    """``mem --profile DIR`` on the SE golden: the SAM is byte-identical
    and torch.profiler's trace (Chrome trace JSON, the CPU ops of the
    run) is in DIR."""
    from bwamem_tpu_torch import cli
    out = io.StringIO()
    old = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, io.StringIO()
    trace_dir = tmp_path / "trace"
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ret = cli.main_mem(["--device", "cpu", "--profile", str(trace_dir),
                            os.path.join(DATA, "genome.fa"),
                            os.path.join(DATA, "reads_se.fq")])
    finally:
        sys.stdout, sys.stderr = old
        torch.set_num_threads(n_threads)
    assert ret == 0
    with open(os.path.join(DATA, "golden_se.sam")) as f:
        want = [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]
    assert [ln for ln in out.getvalue().split("\n")
            if not ln.startswith("@PG")] == want
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        head = f.read(1 << 20)
    assert '"traceEvents"' in head and '"cat": "cpu_op"' in head
