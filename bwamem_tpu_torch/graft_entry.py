"""The port's compile check and sharded dry run (the counterpart of the
repository's ``__graft_entry__.py``):

    python -m bwamem_tpu_torch.graft_entry [--device cuda|cpu] [--shards N]

entry(device)              -> (fn, example_args): one SMEM iterator step
                              (ops/smem.py smem_iter_step; on a card the
                              csrc/smem.cu bm_smem_iter_step kernel, the
                              port of smem1_pallas) at L=64 on a tiny
                              deterministic problem.
dryrun_multichip(n, device) -> an n-shard reads mesh: the sharded
                              iterator step, SA walk and insert-size
                              histograms (parallel/mesh.py), the mesh
                              engine's align_batch on a tiny chunk, the
                              same with the tables split over the
                              shards, and a paired chunk with mutated
                              mates, byte-identical to the host path.

The mesh is every card when there are n of them, otherwise n shards on
card 0, or n CPU shards under ``--device cpu`` (the plain versions).
``--shards`` defaults to the number of cards, and to 2 where there is
one card and on the CPU.  The run prints one JSON line with ``"ok":
true`` and the kernels' launch counts; any mismatch raises, and the
command exits non-zero.  Without a card it fails unless ``--device cpu``
is given.
"""

import argparse
import contextlib
import copy
import json
import os
import sys

import numpy as np

L = 64             # the query bucket of the tiny problem
M, M_OUT = 16, 12  # the seeder's interval buffer and fetch widths
SPLIT_WIDTH = 10   # MemOptions().split_width
SPLIT_LEN = 28     # int(min_seed_len 19 * split_factor 1.5 + .499)


def _tiny_problem(n_reads: int, L: int, device: str = "cpu"):
    """A 512-base genome and n_reads exact L-base substrings of it, from
    the seed of ``__graft_entry__._tiny_problem`` (the same genome and
    reads): the host index, the index on device, and the iterator step's
    lane arrays (packed queries, lengths, start 0, min_intv 1, all
    active, the re-seeding thresholds) on device."""
    import torch
    from bwamem_tpu_torch.index.fmindex import FmIndex
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex

    rng = np.random.default_rng(7)
    fwd = rng.integers(0, 4, 512).astype(np.uint8)
    doubled = np.concatenate([fwd, 3 - fwd[::-1]])  # fwd + revcomp
    fm = FmIndex.build(doubled)
    dfm = DeviceFmIndex.from_host(fm, device)
    q = np.full((n_reads, L), 4, dtype=np.int8)
    for i in range(n_reads):
        off = int(rng.integers(0, 512 - L))
        q[i] = fwd[off:off + L]
    q_pk = q[:, 0::2] | (q[:, 1::2] << np.int8(4))
    lanes = (q_pk, np.full(n_reads, L, np.int32),
             np.zeros(n_reads, np.int32), np.ones(n_reads, np.int64),
             np.ones(n_reads, bool), np.full(n_reads, SPLIT_LEN, np.int32),
             np.full(n_reads, SPLIT_WIDTH, np.int32))
    return fm, dfm, tuple(torch.from_numpy(a).to(device) for a in lanes)


def entry(device: str = "cuda"):
    """Single-device compile check: one iterator step of 32 reads."""
    from bwamem_tpu_torch.ops.smem import smem_iter_step

    _, dfm, args = _tiny_problem(32, L, device)

    def fn(dfm, q_pk, qlen, x, min_intv, active, split_len, split_width):
        return smem_iter_step(dfm, q_pk, qlen, x, min_intv, active,
                              split_len, split_width, L=L, M=M, M_OUT=M_OUT)
    return fn, (dfm,) + args


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError("dryrun_multichip: " + what)


def make_dry_mesh(n: int, device: str):
    """n CPU shards, the first n cards, or n shards on card 0 where there
    are fewer cards."""
    import torch
    from bwamem_tpu_torch.parallel.mesh import make_mesh
    if torch.device(device).type == "cpu":
        return make_mesh(n, "cpu")
    if torch.cuda.device_count() >= n:
        return make_mesh(n)
    return (torch.device("cuda", 0),) * n


@contextlib.contextmanager
def _lane_widths(n: int):
    """Lane widths a tiny chunk fills and n shards divide (unless set),
    restored afterwards."""
    keys = ("BWAMEM_TPU_LANES", "BWAMEM_TPU_WAVE")
    old = {k: os.environ.get(k) for k in keys}
    for k in keys:
        os.environ.setdefault(k, str(8 * n))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Read:
    """A read as the engine and core.pipeline take it."""

    def __init__(self, name: str, seq: np.ndarray):
        self.name = name
        self.comment = None
        self.qual = None
        self.seq_nt4 = seq.astype(np.uint8).copy()
        self.l_seq = len(seq)


def _tiny_reference(rng):
    """A 4,096-base one-contig reference: (forward bases, host FmIndex,
    BntSeq, 2-bit pac)."""
    from bwamem_tpu_torch.index.bntseq import BntSeq, ContigAnn
    from bwamem_tpu_torch.index.fmindex import FmIndex
    fwd = rng.integers(0, 4, 4096).astype(np.uint8)
    fm = FmIndex.build(np.concatenate([fwd, 3 - fwd[::-1]]))
    pac = np.zeros((len(fwd) + 3) // 4, dtype=np.uint8)
    for i, b in enumerate(fwd):
        pac[i >> 2] |= b << ((~i & 3) << 1)
    bns = BntSeq(l_pac=len(fwd), seed=11,
                 anns=[ContigAnn(offset=0, length=len(fwd), n_ambs=0, gi=0,
                                 name="tiny", anno="")], ambs=[], pac=pac)
    return fwd, fm, bns, pac


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """The sharded calls and the mesh engine over an n-shard mesh (see
    the module docstring).  Returns the run's numbers; raises on any
    mismatch."""
    import torch
    from bwamem_tpu_torch.config import MEM_F_PE, MemOptions
    from bwamem_tpu_torch.core.pipeline import process_seqs
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    from bwamem_tpu_torch.ops.smem import smem_iter_step
    from bwamem_tpu_torch.parallel.mesh import (
        pestat_histograms, sharded_sa_lookup, sharded_smem1)

    mesh = make_dry_mesh(n_devices, device)
    n_reads = 4 * n_devices
    fm_host, dfm, lanes = _tiny_problem(n_reads, L)   # lanes on the host

    # one iterator step over the mesh equals the one-device step
    outs = [o.cpu() for o in sharded_smem1(mesh, dfm, L=L, M=M,
                                           M_OUT=M_OUT)(*lanes)]
    one = smem_iter_step(dfm.replica(mesh[0]),
                         *(a.to(mesh[0]) for a in lanes), L=L, M=M,
                         M_OUT=M_OUT)
    _check(all(torch.equal(a, b.cpu()) for a, b in zip(outs, one)),
           "the sharded iterator step differs from the one-device step")
    n_mem = int(outs[1].sum())
    _check(n_mem > 0, "sharded seeding produced no SMEMs")

    # the SA walk over the mesh, each value the host index's
    keys = outs[2][:, 0].clamp(0, dfm.seq_len_int - 1)
    vals, over = (o.cpu() for o in sharded_sa_lookup(mesh, dfm)(keys))
    _check(not over.any() and all(
        int(v) == fm_host.sa_lookup(int(k)) for k, v in zip(keys, vals)),
        "the sharded SA walk differs from the host index")

    # insert-size histograms, summed over the shards
    isize = vals.abs().to(torch.int64)
    orient = (torch.arange(n_reads) % 4).to(torch.int32)
    counts, _ = pestat_histograms(mesh)(isize, orient)
    _check(int(counts.sum()) == n_reads, "pestat counts lost observations")

    rng = np.random.default_rng(3)
    fwd, fm2, bns2, pac2 = _tiny_reference(rng)
    reads = []
    for i in range(4 * n_devices):
        off = int(rng.integers(0, len(fwd) - 80))
        reads.append(_Read(f"r{i}", fwd[off:off + 80]))

    def fields(regs):
        return [[(p.rb, p.re, p.qb, p.qe, p.score) for p in g] for g in regs]

    with _lane_widths(n_devices):
        # the mesh engine on a tiny chunk, then with the occ table and
        # sampled SA split over the shards: the same regions
        eng = TorchSeedingEngine(fm2, mesh[0], mesh=mesh)
        regs = eng.align_batch(MemOptions(), fm2, bns2, pac2, reads)
        n_regs = sum(len(g) for g in regs)
        _check(n_regs >= len(reads), "mesh engine produced too few regions")
        eng_st = TorchSeedingEngine(fm2, mesh[0], mesh=mesh,
                                    shard_tables=True)
        _check(eng_st.shard_tables == (n_devices > 1),
               "the tables were not split over the mesh")
        regs_st = eng_st.align_batch(MemOptions(), fm2, bns2, pac2,
                                     [copy.copy(r) for r in reads])
        _check(fields(regs_st) == fields(regs),
               "split-table engine diverged from the whole-table engine")

        # a paired chunk: FR inserts of 180-299 bases with a spread for
        # the insert-size statistics (at least 16 pairs: mem_pestat skips
        # an orientation with fewer than 10), and mates with every ninth
        # base changed, which leave no exact 19-mer, so only mate rescue
        # (mem_matesw) can place them
        pe_reads = []
        n_resc = max(2, n_devices // 2)
        for i in range(max(16, 2 * n_devices)):
            ins = 180 + int(rng.integers(0, 120))
            off = int(rng.integers(0, len(fwd) - (ins + 80)))
            s1 = fwd[off:off + 80]
            s2 = (3 - fwd[off + ins:off + ins + 80])[::-1].copy()
            name = f"p{i}"
            if i < n_resc:
                name = f"resc{i}"
                s2[::9] = (s2[::9] + 1) % 4
            pe_reads += [_Read(name, s1), _Read(name, s2)]

        def run_pe(engine):
            opt = MemOptions()
            opt.flag |= MEM_F_PE
            chunk = [copy.copy(r) for r in pe_reads]
            process_seqs(opt, fm2, bns2, pac2, 0, chunk, engine=engine,
                         verbose=0)
            return [r.sam for r in chunk]

        sam_mesh = run_pe(eng)
        _check(sam_mesh == run_pe(None),
               "mesh-engine PE SAM diverged from the host path")
    rescued = sorted({f[0] for f in (s.split("\t") for s in sam_mesh)
                      if f[0].startswith("resc") and not int(f[1]) & 0x4
                      and int(f[1]) & 0x2 and int(f[1]) & 0x80})
    _check(bool(rescued), "no mate was rescued: mate rescue never ran")
    return {"shards": [str(d) for d in mesh], "smems": n_mem,
            "pestat_counts": counts.tolist(), "regions": n_regs,
            "reads": len(reads), "pairs": len(pe_reads) // 2,
            "proper_pair_lines": sum("\t99\t" in s or "\t83\t" in s
                                     for s in sam_mesh),
            "rescued": rescued}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bwamem_tpu_torch.graft_entry")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shards", type=int, default=0,
                    help="shards of the dry run's mesh (default: the "
                    "cards, at least 2)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("graft_entry: --device cuda: no CUDA device\n")
        return 1
    from bwamem_tpu_torch.ops import _kernels
    _kernels.reset_counts()
    fn, example = entry(args.device)
    out = fn(*example)
    n_mem = int(out[1].sum())        # waits for the device
    if n_mem <= 0:
        raise RuntimeError("entry: the iterator step found no SMEM")
    shards = args.shards or (max(2, torch.cuda.device_count())
                             if args.device == "cuda" else 2)
    dry = dryrun_multichip(shards, args.device)
    print(json.dumps({"ok": True, "device": args.device,
                      "entry": {"reads": int(out[1].shape[0]),
                                "smems": n_mem},
                      "dryrun": dry,
                      "launches": {k.name: k.launches
                                   for k in _kernels.KERNELS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
