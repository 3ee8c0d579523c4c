"""One-process evaluation of the port on a dataset directory (the
counterpart of the repository's ``tools/run_eval.py``): the index
uploaded once, then the SE diff against a host SAM, the SE bench, the PE
diff and the PE bench.

    python -m bwamem_tpu_torch.run_eval DATA [--device cuda|cpu] \\
        [--n-diff 2000] [--se-host SE.sam] [--pe-host PE.sam] \\
        [--bench-chunks N] [--bench-passes 1] [--skip-se] [--skip-pe]

DATA holds genome.fa with its index, reads_se.fq and (for the PE steps)
reads_1.fq/reads_2.fq.  A diff aligns the first --n-diff reads of the
file (of the interleaved pairs: --n-diff / 2 pairs) as one chunk and
compares the records with the host SAM's (its header lines skipped),
byte for byte; a diff without a host SAM only runs.  A bench replicates
the reads to BWAMEM_TPU_LANES a chunk and drives --bench-chunks chunks,
each in its own order, through core.pipeline.process_chunk_stream.

Prints one ``PASS``/``FAIL`` line per diff, one JSON line per bench
(``eval_se``/``eval_pe`` reads/s) and, last, the engine's counters
(``kernel_time_by_tag``: device time per tag and the host-route
counters) as a JSON line.  A mismatching SAM is written beside the host
SAM as ``<host>.got`` and the command exits 1.  It runs on the card
unless ``--device cpu`` is given; without a card it exits non-zero.
"""

import argparse
import copy
import json
import os
import sys
import time

from bwamem_tpu_torch.bench import (BASELINE_READS_PER_S, WIDTHS, rounded,
                                    shuffled_chunks)


def records(path: str) -> str:
    """A SAM file's lines without its header."""
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("@"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bwamem_tpu_torch.run_eval")
    ap.add_argument("data")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n-diff", type=int, default=2000)
    ap.add_argument("--se-host")
    ap.add_argument("--pe-host")
    ap.add_argument("--bench-chunks", type=int, default=0)
    ap.add_argument("--bench-passes", type=int, default=1)
    ap.add_argument("--skip-pe", action="store_true")
    ap.add_argument("--skip-se", action="store_true",
                    help="PE only (e.g. a rerun after a timeout)")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("[eval] --device cuda: no CUDA device\n")
        return 1
    for k, v in WIDTHS.items():
        os.environ.setdefault(k, v)
    from bwamem_tpu_torch.config import MEM_F_PE, MemOptions
    from bwamem_tpu_torch.core.pipeline import (process_chunk_stream,
                                                process_seqs)
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import ChunkReader
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine

    t0 = time.perf_counter()
    fm, bns = load_index(os.path.join(args.data, "genome.fa"))
    pac = bns.pac
    sys.stderr.write("[eval] index loaded %.1fs seq_len=%d\n"
                     % (time.perf_counter() - t0, int(fm.seq_len)))
    t0 = time.perf_counter()
    engine = TorchSeedingEngine(fm, args.device)
    sys.stderr.write("[eval] engine up %.1fs on %s\n"
                     % (time.perf_counter() - t0, engine.device))

    def diff(reads, host_path, opt, tag) -> bool:
        chunk = [copy.copy(r) for r in reads]
        t = time.perf_counter()
        process_seqs(opt, fm, bns, pac, 0, chunk, None, "", engine,
                     verbose=0)
        dt = time.perf_counter() - t
        got = "".join(r.sam for r in chunk)
        ok = host_path is None or got == records(host_path)
        print(f"{'PASS' if ok else 'FAIL'} {tag} diff: {len(chunk)} reads in "
              f"{dt:.2f} s against {host_path or 'no host SAM'}", flush=True)
        if not ok:
            with open(host_path + ".got", "w") as f:
                f.write(got)
        return ok

    def bench(reads, opt, tag, pe) -> None:
        rep = max(1, int(os.environ["BWAMEM_TPU_LANES"])
                  // max(len(reads), 1))
        vals = []
        for p in range(args.bench_passes):
            chunks = shuffled_chunks(reads, rep, args.bench_chunks, pe,
                                     lambda ci: 1000 + ci + 71 * p)
            n_work = sum(len(c) for c in chunks)
            process_seqs(opt, fm, bns, pac, 0,
                         [copy.copy(r) for r in reads[:64]], None, "",
                         engine, verbose=0)
            engine.kernel_time_by_tag = {}
            t = time.perf_counter()
            process_chunk_stream(opt, fm, bns, pac, iter(chunks), None, "",
                                 engine, verbose=0)
            dt = time.perf_counter() - t
            vals.append(n_work / dt)
            sys.stderr.write("[eval] %s pass %d: %.1f reads/s (%.1fs)\n"
                             % (tag, p + 1, n_work / dt, dt))
            sys.stderr.write("[eval] %s stages: %s\n" % (tag, json.dumps(
                rounded(engine.kernel_time_by_tag))))
        med = sorted(vals)[len(vals) // 2]
        print(json.dumps({"metric": f"eval_{tag}", "value": round(med, 1),
                          "unit": "reads/s",
                          "vs_baseline": round(med / BASELINE_READS_PER_S,
                                               4)}), flush=True)

    ok = True
    if not args.skip_se:
        se = ChunkReader(os.path.join(args.data, "reads_se.fq")) \
            .read_chunk(1 << 34)
        opt = MemOptions()
        ok &= diff(se[:args.n_diff], args.se_host, opt, "se")
        if args.bench_chunks:
            bench(se, opt, "se", pe=False)
    if not args.skip_pe and \
            os.path.exists(os.path.join(args.data, "reads_1.fq")):
        pairs = ChunkReader(os.path.join(args.data, "reads_1.fq"),
                            os.path.join(args.data, "reads_2.fq")) \
            .read_chunk(1 << 34)
        opt = MemOptions()
        opt.flag |= MEM_F_PE
        ok &= diff(pairs[:args.n_diff], args.pe_host, opt, "pe")
        if args.bench_chunks:
            bench(pairs, opt, "pe", pe=True)
    print("stats " + json.dumps(rounded(engine.kernel_time_by_tag),
                                sort_keys=True))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
