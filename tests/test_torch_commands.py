"""Every bwa command of the port's CLI but the device ``mem``
(bwamem_tpu_torch.cli.main), on the CPU: byte-identical to the reference
goldens in tests/data (fastmap, aln, samse, sampe, bwasw, the index
artifacts), and to the JAX package's CLI where there is no golden
(pemerge, aln -b).  ``mem --engine host`` writes the goldens without
ever initialising CUDA."""

import gzip
import io
import os
import struct
import sys

import numpy as np
import pytest
import torch

from bwamem_tpu import cli as jax_cli
from bwamem_tpu.core import pemerge as jax_pemerge
from bwamem_tpu.io.fastq import Read as JaxRead
from bwamem_tpu_torch import cli
from bwamem_tpu_torch.core import pemerge
from bwamem_tpu_torch.io.fastq import Read

INDEX_EXTS = (".bwt", ".pac", ".ann", ".amb", ".sa")


class _BinaryStdout:
    """A stand-in for sys.stdout whose .buffer collects the bytes `aln`
    writes (the .sai is binary)."""

    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, text):
        raise AssertionError("aln wrote text to stdout")

    def flush(self):
        pass


def run(module, args, binary=False):
    """stdout of module.main(args), as bytes with `binary`; the command
    must return 0."""
    out = _BinaryStdout() if binary else io.StringIO()
    old = sys.stdout
    sys.stdout = out
    try:
        ret = module.main(args)
    finally:
        sys.stdout = old
    assert ret == 0, args
    return out.buffer.getvalue() if binary else out.getvalue()


def without_pg(text):
    return [ln for ln in text.split("\n") if not ln.startswith("@PG")]


def read_file(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def data(data_dir, *names):
    return [os.path.join(data_dir, n) for n in names]


@pytest.mark.parametrize("args,golden", [
    (["fastmap", "genome.fa", "reads_se.fq"], "golden_fastmap.txt"),
    (["samse", "genome.fa", "golden_se.sai", "reads_se.fq"],
     "golden_samse.sam"),
    (["sampe", "genome.fa", "golden_r1.sai", "golden_r2.sai", "reads_1.fq",
      "reads_2.fq"], "golden_sampe.sam"),
    (["bwasw", "genome.fa", "reads_se.fq"], "golden_bwasw.sam"),
], ids=["fastmap", "samse", "sampe", "bwasw"])
def test_text_commands_match_goldens(data_dir, args, golden):
    """fastmap byte for byte (its trailing "//" without a newline
    included); the SAM commands without @PG, whose CL differs."""
    got = run(cli, args[:1] + data(data_dir, *args[1:]))
    want = read_file(os.path.join(data_dir, golden))
    if golden.endswith(".txt"):
        assert got == want
    else:
        assert without_pg(got) == without_pg(want)


@pytest.mark.parametrize("reads,golden", [
    ("reads_se.fq", "golden_se.sai"), ("reads_1.fq", "golden_r1.sai"),
    ("reads_2.fq", "golden_r2.sai")], ids=["se", "r1", "r2"])
def test_aln_matches_golden_sai(data_dir, reads, golden):
    sai = run(cli, ["aln"] + data(data_dir, "genome.fa", reads), binary=True)
    assert sai == read_file(os.path.join(data_dir, golden), "rb")


def test_aln_to_samse_pipeline(data_dir, tmp_path):
    """The port's own .sai through the port's samse gives the golden."""
    sai = tmp_path / "se.sai"
    sai.write_bytes(run(cli, ["aln"] + data(data_dir, "genome.fa",
                                             "reads_se.fq"), binary=True))
    ref, fq = data(data_dir, "genome.fa", "reads_se.fq")
    got = run(cli, ["samse", ref, str(sai), fq])
    want = read_file(os.path.join(data_dir, "golden_samse.sam"))
    assert without_pg(got) == without_pg(want)


def _write_bam(data_dir, path, n):
    """The first n bundled SE reads as a BAM, every third one on the
    reverse strand (aln -b flips it back); returns their FASTQ lines."""
    nt16 = {"A": 1, "C": 2, "G": 4, "T": 8, "N": 15}
    comp = str.maketrans("ACGTN", "TGCAN")
    lines = read_file(os.path.join(data_dir, "reads_se.fq")).split("\n")
    with gzip.open(path, "wb") as out:
        out.write(b"BAM\x01")
        text = b"@HD\tVN:1.0\n"
        out.write(struct.pack("<i", len(text)) + text + struct.pack("<i", 1))
        name = b"ctg1\x00"
        out.write(struct.pack("<i", len(name)) + name
                  + struct.pack("<i", 70000))
        for j in range(n):
            qname = lines[4 * j][1:].split()[0].encode() + b"\x00"
            seq, qual = lines[4 * j + 1], lines[4 * j + 3]
            flag = 0x10 if j % 3 == 2 else 0
            if flag:
                seq, qual = seq.translate(comp)[::-1], qual[::-1]
            packed = bytearray()
            for i in range(0, len(seq), 2):
                lo = nt16[seq[i + 1]] if i + 1 < len(seq) else 0
                packed.append(nt16[seq[i]] << 4 | lo)
            rec = struct.pack("<iiIIiiii", -1, -1, (4680 << 16) | len(qname),
                              flag << 16, len(seq), -1, -1, 0)
            rec += qname + bytes(packed) + bytes(ord(c) - 33 for c in qual)
            out.write(struct.pack("<i", len(rec)) + rec)
    return lines[:4 * n]


def test_aln_bam_input(data_dir, tmp_path):
    """aln -b on a BAM: the JAX CLI's .sai byte for byte, and the same
    per-read records as the FASTQ of the same reads (the headers differ
    in the mode bits)."""
    bam, fq = str(tmp_path / "t.bam"), str(tmp_path / "t.fq")
    with open(fq, "w") as f:
        f.write("\n".join(_write_bam(data_dir, bam, 30)) + "\n")
    ref = os.path.join(data_dir, "genome.fa")
    sai_bam = run(cli, ["aln", "-b", ref, bam], binary=True)
    assert sai_bam == run(jax_cli, ["aln", "-b", ref, bam], binary=True)
    assert sai_bam[68:] == run(cli, ["aln", ref, fq], binary=True)[68:]


@pytest.mark.parametrize("pac2bwt", ["pac2bwt", "pac2bwtgen"])
def test_staged_index_commands(data_dir, tmp_path, pac2bwt):
    """fa2pac -> pac2bwt (or pac2bwtgen) -> bwtupdate -> bwt2sa give the
    bundled index's .bwt and .sa; fa2pac -f its .pac, .ann and .amb."""
    fa = str(tmp_path / "genome.fa")
    with open(fa, "w") as f:
        f.write(read_file(os.path.join(data_dir, "genome.fa")))
    pre = str(tmp_path / "staged")
    for args in (["fa2pac", fa, pre], [pac2bwt, pre + ".pac", pre + ".bwt"],
                 ["bwtupdate", pre + ".bwt"],
                 ["bwt2sa", "-i", "32", pre + ".bwt", pre + ".sa"],
                 ["fa2pac", "-f", fa, pre + "_fwd"]):
        assert cli.main(args) == 0, args
    ref = os.path.join(data_dir, "genome.fa")
    for got, ext in ((pre, ".bwt"), (pre, ".sa"), (pre + "_fwd", ".pac"),
                     (pre + "_fwd", ".ann"), (pre + "_fwd", ".amb")):
        assert read_file(got + ext, "rb") == read_file(ref + ext, "rb"), ext


def test_index_command(data_dir, tmp_path):
    """index -p: every artifact byte-identical to the bundled index."""
    pre = str(tmp_path / "idx")
    assert cli.main(["index", "-p", pre,
                     os.path.join(data_dir, "genome.fa")]) == 0
    ref = os.path.join(data_dir, "genome.fa")
    for ext in INDEX_EXTS:
        assert read_file(pre + ext, "rb") == read_file(ref + ext, "rb"), ext


def _random_pairs(n, seed):
    """Read pairs from a numpy seed: overlapping fragments with a few
    substitutions, and every seventh pair unrelated."""
    rng = np.random.default_rng(seed)
    pairs = []
    for t in range(n):
        tl = int(rng.integers(60, 160))
        tpl = rng.integers(0, 4, tl)
        l1 = int(rng.integers(40, min(101, tl)))
        l2 = int(rng.integers(40, min(101, tl)))
        r1, frag2 = tpl[:l1].copy(), tpl[tl - l2:].copy()
        for arr in (r1, frag2):
            nm = rng.integers(0, 4)
            arr[rng.integers(0, len(arr), nm)] = rng.integers(0, 4, nm)
        if t % 7 == 0:
            r1 = rng.integers(0, 4, l1)
        pairs.append(("".join("ACGT"[c] for c in r1),
                      "".join(chr(33 + int(v))
                              for v in rng.integers(20, 41, l1)),
                      "".join("TGCA"[c] for c in frag2[::-1]),
                      "".join(chr(33 + int(v))
                              for v in rng.integers(20, 41, l2))))
    return pairs


def test_pemerge_pair_matches_jax():
    """pemerge_pair against the JAX package's on 200 seeded pairs: the
    return code, and the merged sequence and qualities, equal (tolerance
    zero)."""
    merged = 0
    for t, (s1, q1, s2, q2) in enumerate(_random_pairs(200, 11)):
        x0, x1 = Read("r", None, s1, q1), Read("r", None, s2, q2)
        y0, y1 = JaxRead("r", None, s1, q1), JaxRead("r", None, s2, q2)
        ret = pemerge.pemerge_pair(pemerge.PemOptions(), x0, x1)
        assert ret == jax_pemerge.pemerge_pair(jax_pemerge.PemOptions(),
                                               y0, y1), t
        assert (x0.seq, x0.qual, x1.seq, x1.qual) == \
            (y0.seq, y0.qual, y1.seq, y1.qual), t
        merged += ret == 0
    assert merged > 50      # the pairs exercise the merge itself


@pytest.mark.parametrize("flags", [[], ["-m"], ["-u"]],
                         ids=["all", "merged", "unmerged"])
def test_pemerge_cli_matches_jax(data_dir, flags):
    args = ["pemerge"] + flags + data(data_dir, "reads_1.fq", "reads_2.fq")
    assert run(cli, args) == run(jax_cli, args)


@pytest.mark.parametrize("reads,golden", [
    (["reads_se.fq"], "golden_se.sam"),
    (["reads_1.fq", "reads_2.fq"], "golden_pe.sam")], ids=["se", "pe"])
def test_mem_engine_host(data_dir, monkeypatch, reads, golden):
    """mem --engine host: the goldens, and CUDA never initialised (any
    attempt raises here, where a card would be set up)."""
    def no_cuda(*a, **kw):
        raise AssertionError("mem --engine host touched CUDA")
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    got = run(cli, ["mem", "--engine", "host"]
              + data(data_dir, "genome.fa", *reads))
    assert without_pg(got) == without_pg(
        read_file(os.path.join(data_dir, golden)))
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("engine", ["auto", "tpu", "jax"])
def test_mem_refuses_jax_engines(data_dir, engine):
    """--engine auto|tpu|jax are the JAX package's (auto falls back to the
    host when the device fails): refused."""
    args = ["mem", "--engine", engine] + data(data_dir, "genome.fa",
                                              "reads_se1.fq")
    assert cli.main(args) == 1


def test_usage_lists_every_command(capsys):
    """No command prints the usage, which names every command of the JAX
    CLI's table; an unknown command is refused."""
    assert cli.main([]) == 1
    listed = {ln.replace("Command:", "").split()[0]
              for ln in capsys.readouterr().err.splitlines()
              if ln.startswith(("Command:", "         ")) and ln.strip()}
    assert {"index", "mem", "fastmap", "pemerge", "aln", "samse", "sampe",
            "bwasw", "fa2pac", "pac2bwt", "bwtupdate", "bwt2sa"} <= listed
    assert cli.main(["nosuch"]) == 1
