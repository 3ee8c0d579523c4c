"""The human-scale regime in one process (the counterpart of the
repository's ``tools/run3g.py``): the index loaded and its tables put on
the card once, the first reads aligned and written as SAM records, then
a bench of whole chunks.

    python -m bwamem_tpu_torch.run3g host|cuda|cpu DATA N_DIFF \\
        [--bench-chunks K] [--bench-rep R] [--pe] [--profile DIR]

DATA holds genome.fa with its index (``python -m bwamem_tpu_torch.cli
index``; past 2^31 doubled bases with BWAMEM_TPU_STREAM_INDEX=0 for the
in-memory build), reads_se.fq and, for --pe, reads_1.fq/reads_2.fq
(tools/make_gbp_fasta.py and tools/sample_reads.py make them from a
seed).  The first N_DIFF reads of the file (of the interleaved pairs with
--pe) are aligned as one chunk and their records written to stdout, no
header.  With --bench-chunks K, K chunks of R copies of the reads (R:
BWAMEM_TPU_LANES // reads by default), each in its own order (pairs kept
together), go through core.pipeline.process_chunk_stream, and one JSON
line follows the records:

    {"metric": "mem_align_throughput_3g", "value": N, "unit": "reads/s",
     "vs_baseline": N}

The dense SA sample (.sa8) is read only in the cuda and cpu modes, and
there only where it serves (ops/fm.py dense_sa_fits:
BWAMEM_TPU_SA8_MAX_MB, 2048 MiB by default); past the cap the SA walk
takes the sparse .sa.

stderr has the index load seconds and seq_len, the engine-up seconds,
the coordinate dtype, the SA sample's interval and the tables' bytes on
the device, each phase's reads/s and, after each phase, the engine's
``kernel_time_by_tag`` (device time per tag and the host-route counters:
``ovf_*``, ``host_routed_reads``, ``smem_host_tail`` where they arose)
as a JSON line, and the bench's seconds in each engine stage
(``stages bench``).  With --profile DIR, torch.profiler traces the
card's work in the bench into DIR and stderr has the seconds in which
the card ran anything, the union of the trace's device events, beside
the bench's.

Modes: ``cuda`` the kernels on the card (exits 1 where there is none;
it never carries on on the CPU); ``cpu`` the plain versions on the CPU;
``host`` no engine, the host oracle (no CUDA context is made).
"""

import argparse
import copy
import json
import os
import sys
import time

from bwamem_tpu_torch.bench import (BASELINE_READS_PER_S, WIDTHS, rounded,
                                    shuffled_chunks, timed)


def log(msg: str) -> None:
    sys.stderr.write(f"[run3g] {msg}\n")
    sys.stderr.flush()


# the engine's stages, timed on the host clock in the bench: seeding
# (superstep, SA walk, chaining), the extension's packing and launches,
# its fetch and the regions, and the wave path; the rest of a chunk is
# the host's (the reads' copies, the finalize, SAM)
STAGES = (("chain_batch", "seed+sa+chain"), ("_pack_and_dispatch", "extend"),
          ("_collect_and_regions", "fetch+regions"),
          ("drive_waves", "waves"))


def profiler(trace_dir):
    """torch.profiler's CUDA activity (the kernels and copies; the host's
    ops are left out, which would cost the bench more than they show),
    its trace written into trace_dir; a null context without one."""
    import contextlib
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    return profile(activities=[ProfilerActivity.CUDA],
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def device_busy(prof):
    """(seconds, events): the union of the device events' intervals (the
    kernels and copies) in a torch.profiler session: how long the card
    ran anything."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
        elif b > end:
            busy += b - end
        end = b if end is None else max(end, b)
    return busy / 1e6, len(spans)


def stats(engine, phase: str) -> None:
    """The engine's device time per tag and host-route counters."""
    if engine is not None:
        log(f"stats {phase} " + json.dumps(
            rounded(engine.kernel_time_by_tag), sort_keys=True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bwamem_tpu_torch.run3g")
    ap.add_argument("mode", choices=("host", "cuda", "cpu"))
    ap.add_argument("data")
    ap.add_argument("n_diff", type=int)
    ap.add_argument("--bench-chunks", type=int, default=0)
    ap.add_argument("--bench-rep", type=int, default=0)
    ap.add_argument("--pe", action="store_true")
    ap.add_argument("--profile", metavar="DIR")
    args = ap.parse_args(argv)
    if args.profile and args.mode != "cuda":
        ap.error("--profile traces the card: cuda mode only")
    if args.mode == "cuda":
        import torch
        if not torch.cuda.is_available():
            log("cuda: no CUDA device")
            return 1
    for k, v in WIDTHS.items():
        os.environ.setdefault(k, v)
    from bwamem_tpu_torch.config import MEM_F_PE, MemOptions
    from bwamem_tpu_torch.core.pipeline import (process_chunk_stream,
                                                process_seqs)
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import ChunkReader

    t0 = time.perf_counter()
    prefix = os.path.join(args.data, "genome.fa")
    # the dense SA sample serves only the device's SA walk, and there
    # only within BWAMEM_TPU_SA8_MAX_MB: past it, it is not read at all
    load_sa8 = False
    if args.mode != "host":
        from bwamem_tpu_torch.ops.fm import dense_sa_serves
        load_sa8 = dense_sa_serves(prefix)
    fm, bns = load_index(prefix, load_sa8=load_sa8)
    pac = bns.pac
    log(f"index loaded in {time.perf_counter() - t0:.2f} s "
        f"(seq_len={int(fm.seq_len)})")
    engine = None
    if args.mode != "host":
        from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
        t0 = time.perf_counter()
        engine = TorchSeedingEngine(fm, args.mode)
        if args.mode == "cuda":
            import torch
            torch.cuda.synchronize()
        d = engine.dfm
        log(f"engine up in {time.perf_counter() - t0:.2f} s on "
            f"{engine.device}; cdt={str(d.cdt).replace('torch.', '')} "
            f"sa_intv={d.sa_intv} table_bytes={d.blocks.nbytes} occ + "
            f"{d.sa.nbytes} sa")

    opt = MemOptions()
    files = ["reads_se.fq"]
    if args.pe:
        opt.flag |= MEM_F_PE
        files = ["reads_1.fq", "reads_2.fq"]
    reads = ChunkReader(*(os.path.join(args.data, f) for f in files)) \
        .read_chunk(1 << 34)

    # the diff phase: the first reads as one chunk, their records out
    chunk = [copy.copy(r) for r in reads[:args.n_diff]]
    t0 = time.perf_counter()
    process_seqs(opt, fm, bns, pac, 0, chunk, None, "", engine, verbose=0)
    dt = time.perf_counter() - t0
    log(f"diff phase: {len(chunk)} reads in {dt:.2f} s "
        f"({len(chunk) / dt:.1f} reads/s, first launches included)")
    out = sys.stdout
    out.write("".join(r.sam for r in chunk))
    out.flush()
    stats(engine, "diff")

    # the bench phase: steady-state reads/s
    if args.bench_chunks:
        lanes = int(os.environ["BWAMEM_TPU_LANES"])
        rep = args.bench_rep or max(1, lanes // max(len(reads), 1))
        chunks = shuffled_chunks(reads, rep, args.bench_chunks, args.pe,
                                 lambda ci: 1000 + ci)
        n_work = sum(len(c) for c in chunks)
        process_seqs(opt, fm, bns, pac, 0,
                     [copy.copy(r) for r in reads[:64]], None, "", engine,
                     verbose=0)
        stages = {}
        if engine is not None:
            engine.kernel_time_by_tag = {}
            for attr, name in STAGES:
                setattr(engine, attr, timed(stages, name,
                                            getattr(engine, attr)))
        # the profiler's start and its trace's export stay outside the
        # bench's seconds
        with profiler(args.profile) as prof:
            t0 = time.perf_counter()
            process_chunk_stream(opt, fm, bns, pac, iter(chunks), None, "",
                                 engine, verbose=0, emit=lambda rs: None)
            dt = time.perf_counter() - t0
        out.write(json.dumps({
            "metric": "mem_align_throughput_3g",
            "value": round(n_work / dt, 2), "unit": "reads/s",
            "vs_baseline": round(n_work / dt / BASELINE_READS_PER_S, 4)})
            + "\n")
        out.flush()
        log(f"bench: {n_work} reads in {dt:.2f} s ({args.bench_chunks} "
            f"chunks of {rep} x {len(reads)} reads)")
        if engine is not None:
            log("stages bench " + json.dumps(rounded(stages)))
        if prof is not None:
            busy, n = device_busy(prof)
            log(f"bench device busy: {busy:.6f} s of {dt:.6f} s "
                f"({n} device events)")
        stats(engine, "bench")
    return 0


if __name__ == "__main__":
    sys.exit(main())
