"""``mem`` on PyTorch/CUDA: the port's command-line entry point.

    python -m bwamem_tpu_torch.cli mem [options] <idxbase> <in1.fq> [in2.fq]

The options are those of ``bwamem_tpu.cli mem`` (the bwa mem option
table, ``-v 4``/``-v 5`` tracing included), with ``--device cuda|cpu`` in
place of ``--engine``.  ``cuda`` runs the seeding, SA-walk, extension,
global-alignment and local-SW kernels on the GPU and fails when there is
none; ``cpu`` runs their plain PyTorch versions.  BWAMEM_TPU_CHUNK_BP
sets the chunk size in bases, as in ``bwamem_tpu.cli``.

    --mesh N|auto          shard every launch's lanes over the first N
                           cards (auto: all), the index on each
                           (parallel/mesh.py); under --device cpu, N CPU
                           shards
    --distributed C,N,I    process I of N, rendezvous at C (host:port):
                           --shard I/N by default, the engine on card
                           I mod the cards there are (parallel/multihost.py)
    --profile DIR          a torch.profiler trace of the run into DIR

Only ``--shard-tables`` (the tables row-sharded over the mesh) is not
ported yet and is refused.  Every other bwa command runs without JAX in
``bwamem_tpu.cli`` already.  The port imports nothing of that package:
the host modules it needs are its own copies.
"""

import json
import math
import os
import sys

PACKAGE_VERSION = "0.7.8-r455"  # output-compat version (top.c:10)
_REFUSED = ("shard-tables",)


def set_rg(s: str):
    """bwa_set_rg (software/bwa.c:375-402): unescape and extract ID."""
    rg_line = (s.replace("\\t", "\t").replace("\\n", "\n")
               .replace("\\r", "\r").replace("\\\\", "\\"))
    if not rg_line.startswith("@RG"):
        sys.stderr.write("[E::bwa_set_rg] the read group line is not started"
                         " with @RG\n")
        return None, None
    idx = rg_line.find("\tID:")
    if idx < 0:
        sys.stderr.write("[E::bwa_set_rg] no ID at the read group line\n")
        return None, None
    p = idx + 4
    q = p
    while q < len(rg_line) and rg_line[q] not in "\t\n":
        q += 1
    return rg_line, rg_line[p:q]


def _profiler(trace_dir, device):
    """torch.profiler around the run (the CPU activity, and the CUDA one
    on a card), its trace written into trace_dir by
    tensorboard_trace_handler (the counterpart of jax.profiler.trace,
    JAX cli.py:271); a null context without a directory."""
    import contextlib
    if not trace_dir:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(trace_dir))


def main_mem(argv):
    import getopt as _getopt
    from bwamem_tpu_torch.config import (MemOptions, fill_scmat, MEM_F_PE,
                                   MEM_F_NOPAIRING, MEM_F_ALL,
                                   MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
                                   MEM_F_NO_EXACT)
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.native import make_chunk_reader
    from bwamem_tpu_torch.core import pair as pe
    from bwamem_tpu_torch.core.sam import sam_header

    opt = MemOptions()
    copy_comment = False
    rg_line = rg_id = None
    pes0 = None
    verbose = 3
    device = "cuda"
    shard_spec = None
    mesh_spec = dist_spec = profile_dir = None
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
        elif c == "mesh":
            mesh_spec = val
        elif c == "distributed":  # coord_addr,num_processes,process_id
            parts = val.split(",")
            dist_spec = (parts[0], int(parts[1]), int(parts[2]))
        elif c == "profile":
            profile_dir = val
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
        from bwamem_tpu_torch.core.mt import WorkerPool
        pool = WorkerPool(fm, bns, pac, opt.n_threads,
                          index_prefix=args[0])

    multihost = None
    try:
        import torch
        from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
        if device == "cuda" and not torch.cuda.is_available():
            sys.stderr.write("[E::main_mem] --device cuda: no CUDA device\n")
            return 1
        if dist_spec is not None:
            # the rendezvous after the pool's fork; --shard defaults to
            # this process's stripe (JAX cli.py:221-233)
            from bwamem_tpu_torch.parallel import multihost
            multihost.initialize(*dist_spec)
            if shard_spec is None:
                shard_spec = (dist_spec[2], dist_spec[1])
            device = multihost.local_device(device)
            if device.type == "cuda":
                torch.cuda.set_device(device)
            sys.stderr.write("[M::main_mem] distributed: process %d of %d"
                             " on %s\n" % (dist_spec[2], dist_spec[1],
                                           device))
        mesh = None
        if mesh_spec:   # --mesh N|auto: the lanes over several devices
            from bwamem_tpu_torch.parallel.mesh import make_mesh
            mesh = make_mesh(None if mesh_spec == "auto" else int(mesh_spec),
                             device)
            if len(mesh) > 1:
                sys.stderr.write("[M::main_mem] reads mesh over %d devices\n"
                                 % len(mesh))
            else:
                mesh = None
        engine = TorchSeedingEngine(fm, device, mesh=mesh)

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

        from bwamem_tpu_torch.core.pipeline import process_chunk_stream
        with _profiler(profile_dir, engine.device):
            process_chunk_stream(opt, fm, bns, pac, chunk_iter(), pes0,
                                 rg_id or "", engine, verbose, pool=pool,
                                 on_start=on_start, emit=emit)
    finally:
        if pool is not None:
            pool.close()
        if multihost is not None:
            multihost.shutdown()
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
