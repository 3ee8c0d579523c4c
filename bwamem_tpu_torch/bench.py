"""Benchmark of the port: end-to-end ``mem`` throughput (reads/s) on one
dataset, against the reference's CPU baseline (the counterpart of the
repository's ``bench.py``, same workload and JSON line):

    python -m bwamem_tpu_torch.bench [--device cuda|cpu]

Baseline: stock bwa ran 512 reads in 0.427 real s with 4 CPU threads,
~1,199 reads/s (software/bwares/stderr.log:8, SURVEY.md §6).

The dataset is BWAMEM_TPU_BENCH_DATA (a directory with genome.fa and its
index, reads_se.fq, and reads_1.fq/reads_2.fq), tests/data by default.
Its reads are replicated rep times into a chunk, and n_chunks chunks,
each in a distinct read order (pairs kept together), are driven through
core.pipeline.process_chunk_stream; the reported value is the median of
the passes.  The knobs, as in bench.py:

    BWAMEM_TPU_BENCH_PE=1       pairs with -M -a (mate rescue, pairing)
    BWAMEM_TPU_BENCH_POOL=N     a spawn WorkerPool of N host workers
    BWAMEM_TPU_BENCH_REP=N      copies of the reads a chunk (default:
                                BWAMEM_TPU_LANES // reads, at least 1)
    BWAMEM_TPU_BENCH_CHUNKS=N   chunks a pass (32)
    BWAMEM_TPU_BENCH_PASSES=N   passes (3); per-pass numbers on stderr
    BWAMEM_TPU_BENCH_STAGES=1   the time per stage and the engine's
                                kernel_time_by_tag on stderr
    BWAMEM_TPU_BENCH_PROFILE=1  a cProfile of the passes on stderr
    BWAMEM_TPU_BENCH_LEGACY=1   every chunk in the same read order

Prints one JSON line:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N}

It runs on the card (the kernels) unless ``--device cpu`` is given (the
plain versions); without a card it exits non-zero.
"""

import argparse
import copy
import json
import os
import random
import sys
import time

BASELINE_READS_PER_S = 1199.0  # 512 reads / 0.427 s, 4 CPU threads
# the launch widths of bench.py: one seeding lane group and one
# extension wave a chunk
WIDTHS = {"BWAMEM_TPU_LANES": "8192", "BWAMEM_TPU_WAVE": "2048",
          "BWAMEM_TPU_SA_SLICE": "32768", "BWAMEM_TPU_WAVE_EXT": "16384"}
DEFAULT_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "data")


def shuffled_chunks(reads, rep: int, n_chunks: int, pe: bool, seed,
                    legacy: bool = False):
    """n_chunks chunks of rep copies of reads, each shuffled by
    random.Random(seed(ci)) (pairs kept together) unless legacy."""
    out = []
    for ci in range(n_chunks):
        c = [copy.copy(r) for r in reads * rep]
        if not legacy:
            if pe:
                pairs = [c[i:i + 2] for i in range(0, len(c), 2)]
                random.Random(seed(ci)).shuffle(pairs)
                c = [r for p in pairs for r in p]
            else:
                random.Random(seed(ci)).shuffle(c)
        out.append(c)
    return out


def timed(stages: dict, name: str, fn):
    """fn, adding its seconds to stages[name] at every call."""
    def wrap(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
    return wrap


def rounded(stats: dict) -> dict:
    return {k: round(v, 3) if isinstance(v, float) else v
            for k, v in stats.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bwamem_tpu_torch.bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("[bench] --device cuda: no CUDA device\n")
        return 1
    for k, v in WIDTHS.items():
        os.environ.setdefault(k, v)
    env = os.environ.get
    data = env("BWAMEM_TPU_BENCH_DATA") or DEFAULT_DATA
    from bwamem_tpu_torch.config import (MEM_F_ALL, MEM_F_NO_MULTI, MEM_F_PE,
                                         MemOptions)
    from bwamem_tpu_torch.core.pipeline import (process_chunk_stream,
                                                process_seqs)
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import ChunkReader
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine

    fm, bns = load_index(os.path.join(data, "genome.fa"))
    pac = bns.pac
    opt = MemOptions()
    # the reference's canonical workload shape: paired reads with -M -a
    # (software/run.sh:1)
    pe = bool(env("BWAMEM_TPU_BENCH_PE"))
    if pe:
        opt.flag |= MEM_F_PE | MEM_F_ALL | MEM_F_NO_MULTI
    sys.stderr.write("[bench] index loaded\n")

    pool = None
    n_pool = int(env("BWAMEM_TPU_BENCH_POOL", "0"))
    if n_pool > 1:
        from bwamem_tpu_torch.core.mt import WorkerPool
        pool = WorkerPool(fm, bns, pac, n_pool, method="spawn",
                          index_prefix=os.path.join(data, "genome.fa"))
    try:
        engine = TorchSeedingEngine(fm, args.device)
        files = (["reads_1.fq", "reads_2.fq"] if pe else ["reads_se.fq"])
        reads = ChunkReader(*(os.path.join(data, f) for f in files)) \
            .read_chunk(1 << 34)
        # a chunk just past LANES pays a second near-empty seeding launch
        rep = int(env("BWAMEM_TPU_BENCH_REP", "0"))
        if rep <= 0:
            rep = max(1, int(env("BWAMEM_TPU_LANES")) // max(len(reads), 1))
        n_chunks = int(env("BWAMEM_TPU_BENCH_CHUNKS", "32"))
        legacy = bool(env("BWAMEM_TPU_BENCH_LEGACY"))
        n_work = n_chunks * len(reads) * rep
        sys.stderr.write(
            "[bench] workload: rep=%d chunk=%d reads, n_chunks=%d, "
            "total=%d reads%s on %s\n" % (
                rep, len(reads) * rep, n_chunks, n_work,
                " (PE)" if pe else "", engine.device))

        # warm-up: every fixed launch shape, then a small chunk
        engine.warm_shapes(opt)
        process_seqs(opt, fm, bns, pac, 0, [copy.copy(r)
                                            for r in reads[:64]],
                     None, "", engine, verbose=0, pool=pool)
        sys.stderr.write("[bench] warmup done\n")

        stages = {}
        if env("BWAMEM_TPU_BENCH_STAGES"):
            engine.chain_batch = timed(stages, "seed+sa",
                                       engine.chain_batch)
            engine.drive_waves = timed(stages, "sw_waves",
                                       engine.drive_waves)
            engine.kernel_time = 0.0
            engine.n_dispatches = 0
            engine.kernel_time_by_tag = {}

        prof = None
        if env("BWAMEM_TPU_BENCH_PROFILE"):
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
        n_pass = max(1, int(env("BWAMEM_TPU_BENCH_PASSES", "3")))
        pass_rps = []
        for pi in range(n_pass):
            chunks = shuffled_chunks(reads, rep, n_chunks, pe,
                                     lambda ci: 1000 + 100 * pi + ci, legacy)
            t0 = time.perf_counter()
            process_chunk_stream(opt, fm, bns, pac, iter(chunks), None, "",
                                 engine, verbose=0, pool=pool)
            dt = time.perf_counter() - t0
            pass_rps.append(n_work / dt)
            sys.stderr.write("[bench] pass %d/%d: %.1f reads/s (%.2f s)\n"
                             % (pi + 1, n_pass, pass_rps[-1], dt))
        if prof is not None:
            prof.disable()
            import pstats
            pstats.Stats(prof, stream=sys.stderr).sort_stats(
                "tottime").print_stats(45)
    finally:
        if pool is not None:
            pool.close()
    rps = sorted(pass_rps)[len(pass_rps) // 2]
    if stages:
        stages["total"] = sum(n_work / r for r in pass_rps)
        stages["kernel_time"] = engine.kernel_time
        stages["n_dispatches"] = engine.n_dispatches
        stages.update(engine.kernel_time_by_tag)
        sys.stderr.write("[bench] stages: %s\n" % json.dumps(rounded(stages)))
    print(json.dumps({
        "metric": "mem_align_throughput" + ("_pe" if pe else ""),
        "value": round(rps, 2),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_S, 4),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
