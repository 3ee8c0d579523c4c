"""``mem`` on PyTorch/CUDA: the port's command-line entry point.

    python -m bwamem_tpu_torch.cli mem [options] <idxbase> <in1.fq> [in2.fq]

The options are those of ``bwamem_tpu.cli mem`` (the bwa mem option
table, ``-v 4``/``-v 5`` tracing included), with ``--device cuda|cpu`` in
place of ``--engine``.  ``cuda`` runs the seeding, SA-walk, extension,
global-alignment and local-SW kernels on the GPU and fails when there is
none; ``cpu`` runs their plain PyTorch versions.  BWAMEM_TPU_CHUNK_BP
sets the chunk size in bases, as in ``bwamem_tpu.cli``.  The mesh,
table-sharding, multi-host and profiler options are not ported yet and
are refused.  Every other bwa command runs without JAX in
``bwamem_tpu.cli`` already.
"""

import json
import math
import os
import sys

from bwamem_tpu.cli import PACKAGE_VERSION, set_rg

_REFUSED = ("mesh", "shard-tables", "distributed", "profile")


def main_mem(argv):
    import getopt as _getopt
    from bwamem_tpu.config import (MemOptions, fill_scmat, MEM_F_PE,
                                   MEM_F_NOPAIRING, MEM_F_ALL,
                                   MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
                                   MEM_F_NO_EXACT)
    from bwamem_tpu.index import load_index
    from bwamem_tpu.io.native import make_chunk_reader
    from bwamem_tpu.core import pair as pe
    from bwamem_tpu.core.sam import sam_header

    opt = MemOptions()
    copy_comment = False
    rg_line = rg_id = None
    pes0 = None
    verbose = 3
    device = "cuda"
    shard_spec = None
    try:
        opts, args = _getopt.getopt(
            argv, "epaMCSPHk:c:v:s:r:t:b:R:A:B:O:E:U:w:L:d:T:Q:D:m:I:",
            ["device=", "shard=", "engine=", "profile=", "mesh=",
             "distributed=", "shard-tables"])
    except _getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n")
        return 1
    for c, val in opts:
        c = c.lstrip("-")
        if c == "k":
            opt.min_seed_len = int(val)
        elif c == "w":
            opt.w = int(val)
        elif c == "A":
            opt.a = int(val)
            opt._explicit.add("a")
        elif c == "B":
            opt.b = int(val)
            opt._explicit.add("b")
        elif c == "T":
            opt.T = int(val)
            opt._explicit.add("T")
        elif c == "U":
            opt.pen_unpaired = int(val)
            opt._explicit.add("pen_unpaired")
        elif c == "t":
            opt.n_threads = max(int(val), 1)
        elif c == "b":
            opt.batch_size = max(int(val), 1)
        elif c == "P":
            opt.flag |= MEM_F_NOPAIRING
        elif c == "a":
            opt.flag |= MEM_F_ALL
        elif c == "p":
            opt.flag |= MEM_F_PE
        elif c == "M":
            opt.flag |= MEM_F_NO_MULTI
        elif c == "S":
            opt.flag |= MEM_F_NO_RESCUE
        elif c == "e":
            opt.flag |= MEM_F_NO_EXACT
        elif c == "c":
            opt.max_occ = int(val)
        elif c == "d":
            opt.zdrop = int(val)
            opt._explicit.add("zdrop")
        elif c == "v":
            verbose = int(val)
        elif c == "r":
            opt.split_factor = float(val)
        elif c == "D":
            opt.chain_drop_ratio = float(val)
        elif c == "m":
            opt.max_matesw = int(val)
        elif c == "s":
            opt.split_width = int(val)
        elif c == "C":
            copy_comment = True
        elif c == "Q":
            opt.mapQ_coef_len = int(val)
            opt.mapQ_coef_fac = (math.log(opt.mapQ_coef_len)
                                 if opt.mapQ_coef_len > 0 else 0)
        elif c == "O":
            opt._explicit.update(("o_del", "o_ins"))
            parts = val.replace(",", " ").split()
            opt.o_del = opt.o_ins = int(parts[0])
            if len(parts) > 1:
                opt.o_ins = int(parts[1])
        elif c == "E":
            opt._explicit.update(("e_del", "e_ins"))
            parts = val.replace(",", " ").split()
            opt.e_del = opt.e_ins = int(parts[0])
            if len(parts) > 1:
                opt.e_ins = int(parts[1])
        elif c == "L":
            opt._explicit.update(("pen_clip5", "pen_clip3"))
            parts = val.replace(",", " ").split()
            opt.pen_clip5 = opt.pen_clip3 = int(parts[0])
            if len(parts) > 1:
                opt.pen_clip3 = int(parts[1])
        elif c == "R":
            rg_line, rg_id = set_rg(val)
            if rg_line is None:
                return 1
        elif c == "I":
            parts = val.replace(",", " ").split()
            p1 = pe.PeStat(failed=0)
            p1.avg = float(parts[0])
            p1.std = p1.avg * .1 if len(parts) < 2 else float(parts[1])
            p1.high = int(p1.avg + 4.0 * p1.std + .499)
            p1.low = max(1, int(p1.avg - 4.0 * p1.std + .499))
            if len(parts) > 2:
                p1.high = int(float(parts[2]) + .499)
            if len(parts) > 3:
                p1.low = int(float(parts[3]) + .499)
            pes0 = [pe.PeStat(failed=1), p1, pe.PeStat(failed=1),
                    pe.PeStat(failed=1)]
            if verbose >= 3:
                sys.stderr.write(
                    "[M::main_mem] mean insert size: %.3f, stddev: %.3f, "
                    "max: %d, min: %d\n" % (p1.avg, p1.std, p1.high, p1.low))
        elif c == "device":
            device = val
        elif c == "engine":
            sys.stderr.write("[E::main_mem] --engine is --device cuda|cpu "
                             "here\n")
            return 1
        elif c == "shard":  # i/n: process chunks i, i+n, ... of the input
            parts = val.split("/")
            shard_spec = (int(parts[0]), int(parts[1]))
        elif c in _REFUSED:
            sys.stderr.write(f"[E::main_mem] --{c} is not ported to the "
                             f"PyTorch package yet (see ROADMAP.md)\n")
            return 1
        elif c == "H":
            pass
        else:
            return 1

    if len(args) < 2 or len(args) > 3:
        sys.stderr.write("Usage: bwa mem [options] <idxbase> <in1.fq>"
                         " [in2.fq]\n")
        return 1
    if device not in ("cuda", "cpu"):
        sys.stderr.write(f"[E::main_mem] unknown --device '{device}' "
                         f"(expected cuda|cpu)\n")
        return 1
    opt.rescale_for_a()
    opt.mat = fill_scmat(opt.a, opt.b)

    fm, bns = load_index(args[0])
    pac = bns.pac

    # fork the -t worker pool before CUDA is initialised: a fork after
    # CUDA init breaks the children (they never touch the device).  At
    # -v >= 4 process_seqs bypasses the pool to keep the traces
    # in-process, so none is made
    pool = None
    if opt.n_threads > 1 and verbose < 4:
        from bwamem_tpu.core.mt import WorkerPool
        pool = WorkerPool(fm, bns, pac, opt.n_threads,
                          index_prefix=args[0])

    try:
        import torch
        from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
        if device == "cuda" and not torch.cuda.is_available():
            sys.stderr.write("[E::main_mem] --device cuda: no CUDA device\n")
            return 1
        engine = TorchSeedingEngine(fm, device)

        reader = make_chunk_reader(args[1],
                                   args[2] if len(args) > 2 else None)
        if len(args) > 2 and not (opt.flag & MEM_F_PE):
            opt.flag |= MEM_F_PE

        out = sys.stdout
        out.write(sam_header(bns, rg_line,
                             "@PG\tID:bwa\tPN:bwa\tVN:%s\tCL:%s" % (
                                 PACKAGE_VERSION,
                                 " ".join(["bwa", "mem"] + argv))))

        def chunk_iter():
            # --shard i/n: this process owns chunks i, i+n, i+2n, ... of
            # the input stream
            chunk_bp = (int(os.environ.get("BWAMEM_TPU_CHUNK_BP", "0"))
                        or opt.chunk_size * opt.n_threads)
            chunk_no = -1
            while True:
                reads = reader.read_chunk(chunk_bp)
                if not reads:
                    return
                chunk_no += 1
                if shard_spec is not None \
                        and chunk_no % shard_spec[1] != shard_spec[0]:
                    continue
                if (opt.flag & MEM_F_PE) and len(reads) % 2 == 1:
                    if verbose >= 2:
                        sys.stderr.write("[W::main_mem] odd number of reads"
                                         " in the PE mode; last read"
                                         " dropped\n")
                    reads = reads[:-1]
                    if not reads:
                        return
                if not copy_comment:
                    for r in reads:
                        r.comment = None
                yield reads

        def on_start(reads):
            if verbose >= 3:
                sys.stderr.write(
                    "[M::main_mem] read %d sequences (%d bp)...\n"
                    % (len(reads), sum(r.l_seq for r in reads)))

        def emit(reads):
            for r in reads:
                out.write(r.sam)

        from bwamem_tpu.core.pipeline import process_chunk_stream
        process_chunk_stream(opt, fm, bns, pac, chunk_iter(), pes0,
                             rg_id or "", engine, verbose, pool=pool,
                             on_start=on_start, emit=emit)
    finally:
        if pool is not None:
            pool.close()
    if verbose >= 3:
        # the reference manager's shutdown line (software/fastmap.c:427)
        sys.stderr.write("[M::main_mem] total device kernel time %fs over"
                         " %d dispatches\n" % (engine.kernel_time,
                                               engine.n_dispatches))
        # per-tag fetch-inclusive device time, dispatch counts and the
        # host-route counters, one JSON object
        sys.stderr.write("[M::main_mem] device stats: %s\n"
                         % json.dumps(engine.kernel_time_by_tag,
                                      sort_keys=True))
    return 0


def main(argv=None):
    import time
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "mem":
        sys.stderr.write("Usage: python -m bwamem_tpu_torch.cli mem [options]"
                         " <idxbase> <in1.fq> [in2.fq]\n"
                         "(the other bwa commands: python -m bwamem_tpu.cli)"
                         "\n")
        return 1
    t_real = time.perf_counter()
    ret = main_mem(argv[1:])
    sys.stdout.flush()
    if ret == 0:
        sys.stderr.write("[main] Version: %s\n" % PACKAGE_VERSION)
        sys.stderr.write("[main] CMD: bwa %s\n" % " ".join(argv))
        sys.stderr.write("[main] Real time: %.3f sec\n"
                         % (time.perf_counter() - t_real))
    return ret


if __name__ == "__main__":
    sys.exit(main())
