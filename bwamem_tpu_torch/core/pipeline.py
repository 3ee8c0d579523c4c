"""The BWA-MEM pipeline driver.

mem_align1_core -> regions, mem_reg2sam_se, and mem_process_seqs
(reference: software/bwamem.c:1359-1639, software/fastmap.c:35-252).

The seeding stage runs through a pluggable engine: the default host
oracle walks the SMEM iterator per read; the TPU engine
(bwamem_tpu.ops.engine) produces identical chains from batched device
kernels.  Everything downstream (chain filter, extension, dedup, SAM) is
shared and bit-exact with the reference.
"""

import sys
from typing import List, Optional

import numpy as np

from ..config import MemOptions, MEM_F_PE, MEM_F_ALL, MEM_F_NO_MULTI, \
    MEM_F_NO_EXACT
from ..index.bntseq import NT4_TABLE
from .chain import mem_chain, mem_chain_flt
from .region import (AlnReg, chain2aln, chain2aln_short, sort_and_dedup,
                     test_and_remove_exact, mark_primary)
from .align import reg2aln
from .sam import aln2sam
from . import pair as pe


def encode_read(read) -> None:
    """Attach the nt4-encoded query to a Read (in-place nt4 conversion,
    software/bwamem.c:1444-1446)."""
    if getattr(read, "seq_nt4", None) is None:
        read.seq_nt4 = NT4_TABLE[
            np.frombuffer(read.seq.encode("latin1"), dtype=np.uint8)].copy()


def align1_core(opt: MemOptions, fm, bns, pac, read,
                chains=None, trace=None, trace_seeds=False) -> List[AlnReg]:
    """mem_align1_core: one read -> deduplicated alignment regions.
    `chains` may be precomputed (e.g. by the batched TPU seeder)."""
    from .region import drive_extension_gen
    gen = align1_core_gen(opt, fm, bns, pac, read, chains, trace,
                          trace_seeds)
    return drive_extension_gen(gen, opt)


def align1_core_gen(opt: MemOptions, fm, bns, pac, read, chains=None,
                    trace=None, trace_seeds=False):
    """Generator form of mem_align1_core: yields banded-extension
    requests (see region.chain2aln_gen) and returns the deduplicated
    region list via StopIteration.value.  `trace` collects the
    bwa_verbose>=4 lines (chain dump software/bwamem.c:1450, per-chain
    header :1456, extension traces); `trace_seeds` adds the >=5 seed
    dump."""
    from .region import chain2aln_gen
    encode_read(read)
    query = read.seq_nt4
    if chains is None:
        chains = mem_chain(opt, fm, bns.l_pac, query,
                           trace if trace_seeds else None)
    chains = mem_chain_flt(opt, chains)
    if trace is not None:
        from .trace import print_chain
        print_chain(bns, chains, trace)
    regs: List[AlnReg] = []
    for i, c in enumerate(chains):
        if trace is not None:  # err_printf → stdout (bwamem.c:1456)
            trace.err("* ---> Processing chain(%d) <---\n" % i)
        ret = chain2aln_short(opt, bns.l_pac, pac, query, c, trace)
        if isinstance(ret, AlnReg):
            regs.append(ret)
        elif ret > 0:
            yield from chain2aln_gen(opt, bns.l_pac, pac, query, c, regs,
                                     trace)
    regs = sort_and_dedup(regs, opt.mask_level_redun)
    if opt.flag & MEM_F_NO_EXACT:
        regs = test_and_remove_exact(opt, regs, read.l_seq)
    return regs


def reg2sam_se(opt, bns, pac, read, regs: List[AlnReg], extra_flag: int,
               m, rg_id: str) -> None:
    """mem_reg2sam_se driven by the host-oracle SW."""
    from .align import drive_cigar_gen
    drive_cigar_gen(
        reg2sam_se_gen(opt, bns, pac, read, regs, extra_flag, m, rg_id),
        opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)


def reg2sam_se_gen(opt, bns, pac, read, regs: List[AlnReg],
                   extra_flag: int, m, rg_id: str, trace=None):
    """mem_reg2sam_se (software/bwamem.c:1359-1393) as a generator
    yielding the banded-global-SW requests of its reg2aln calls."""
    from .align import reg2aln_gen
    aa = []
    for k, p in enumerate(regs):
        if p.score < opt.T:
            continue
        if p.secondary >= 0 and not (opt.flag & MEM_F_ALL):
            continue
        if p.secondary >= 0 and p.score < regs[p.secondary].score * .5:
            continue
        q = yield from reg2aln_gen(opt, bns, pac, read.l_seq,
                                   read.seq_nt4, p, trace)
        q.flag |= extra_flag
        if p.secondary >= 0:
            q.sub = -1  # don't output sub-optimal score
        if k and p.secondary < 0:  # supplementary
            q.flag |= 0x10000 if (opt.flag & MEM_F_NO_MULTI) else 0x800
        if k and q.mapq > aa[0].mapq:
            q.mapq = aa[0].mapq
        aa.append(q)
    out: List[str] = []
    if not aa:  # unaligned record
        t = yield from reg2aln_gen(opt, bns, pac, read.l_seq,
                                   read.seq_nt4, None, trace)
        t.flag |= extra_flag
        aln2sam(bns, read, 1, [t], 0, m, rg_id, out)
    else:
        for k in range(len(aa)):
            aln2sam(bns, read, len(aa), aa, k, m, rg_id, out)
    read.sam = "".join(out)


def _try_native_finalize_se(opt, bns, reads, regs, n_processed: int,
                            rg_id: str) -> bool:
    """Whole-chunk SE finalize in C++ (native/finalize.cpp) when the
    library is available; byte-identical to the Python path below."""
    try:
        from .nfinalize import finalize_se_native
        return finalize_se_native(opt, bns, reads, regs, n_processed,
                                  rg_id)
    except Exception:
        return False


def _try_native_finalize_pe(opt, bns, pes, reads, regs, n_processed: int,
                            rg_id: str) -> bool:
    """Whole-chunk PE finalize in C++ (native/finalize.cpp): mate
    rescue, pairing and SAM; byte-identical to the Python path."""
    try:
        from .nfinalize import finalize_pe_native
        return finalize_pe_native(opt, bns, pes, reads, regs, n_processed,
                                  rg_id)
    except Exception:
        return False


def process_seqs(opt: MemOptions, fm, bns, pac, n_processed: int,
                 reads: List, pes0=None, rg_id: str = "",
                 engine=None, verbose: int = 3, pool=None,
                 chains=None) -> None:
    """mem_process_seqs: seed+extend every read, then finalize
    (single-end or paired) writing read.sam.

    `pool` (core.mt.WorkerPool) parallelizes the host-side per-read
    stages across -t worker processes, matching the reference's kt_for
    thread split within one chunk (software/bwamem.c:1569-1639) —
    output is byte-identical for every -t."""
    import time
    ctime = time.process_time()
    rtime = time.perf_counter()
    n = len(reads)
    for r in reads:
        encode_read(r)

    # -v>=4 per-read tracing (SURVEY.md §5): collect per read, replay
    # in the reference's -t1 order (see core.trace).  The worker pool is
    # bypassed so trace collection stays in-process.
    traces1 = None
    if verbose >= 4:
        from .trace import TraceLog, emit
        traces1 = [TraceLog() for _ in reads]
        pool = None

    if engine is not None:
        regs = engine.align_batch(opt, fm, bns, pac, reads, traces=traces1,
                                  trace_seeds=verbose >= 5, chains=chains)
    elif pool is not None:
        regs = pool.align_regs(opt, reads)
    else:
        regs = [align1_core(opt, fm, bns, pac, reads[i],
                            trace=traces1[i] if traces1 is not None else None,
                            trace_seeds=verbose >= 5)
                for i in range(n)]

    if traces1 is not None:
        # worker1_batched prints the batch headers AFTER each batch of
        # `-b` reads completes (software/bwamem.c:1589-1594)
        b = max(opt.batch_size, 1)
        for start in range(0, n, b):
            emit(traces1[start:start + b])
            for r in reads[start:start + b]:
                sys.stdout.write("=====> Processing read '%s' <=====\n"
                                 % r.name)
        sys.stdout.flush()

    if opt.flag & MEM_F_PE:
        if pes0 is not None:
            pes = pes0
        else:
            pes = pe.pestat(opt, bns.l_pac, regs, verbose)
        if pool is not None:
            pool.finalize_pe(opt, pes, reads, regs, n_processed, rg_id)
        elif traces1 is None and _try_native_finalize_pe(
                opt, bns, pes, reads, regs, n_processed, rg_id):
            pass  # read.sam set by the native finalize
        else:
            traces2 = ([TraceLog() for _ in range(n >> 1)]
                       if traces1 is not None else [None] * (n >> 1))
            gens = [pe.sam_pe_gen(opt, bns, pac, pes,
                                  (n_processed >> 1) + i,
                                  (reads[i << 1], reads[i << 1 | 1]),
                                  (regs[i << 1], regs[i << 1 | 1]), rg_id,
                                  traces2[i])
                    for i in range(n >> 1)]
            if engine is not None:
                engine.drive_waves(opt, gens)
            else:
                from .swdrive import drive_host
                for g in gens:
                    drive_host(g, opt)
            if traces1 is not None:
                for i in range(n >> 1):  # worker2 header (bwamem.c:1608)
                    sys.stdout.write("=====> Finalizing read pair '%s' "
                                     "<=====\n" % reads[i << 1].name)
                    emit(traces2[i:i + 1])
    else:
        if pool is not None:
            pool.finalize_se(opt, reads, regs,
                             [n_processed + i for i in range(n)], rg_id)
        elif traces1 is None and _try_native_finalize_se(
                opt, bns, reads, regs, n_processed, rg_id):
            pass  # read.sam set by the native finalize
        else:
            for i in range(n):
                mark_primary(opt, regs[i], n_processed + i)
            traces2 = ([TraceLog() for _ in range(n)]
                       if traces1 is not None else [None] * n)
            gens = [reg2sam_se_gen(opt, bns, pac, reads[i], regs[i], 0,
                                   None, rg_id, traces2[i])
                    for i in range(n)]
            if engine is not None:
                engine.drive_waves(opt, gens)
            else:
                from .swdrive import drive_host
                for g in gens:
                    drive_host(g, opt)
            if traces1 is not None:
                for i in range(n):  # worker2 header (bwamem.c:1603)
                    sys.stdout.write("=====> Finalizing read '%s' <=====\n"
                                     % reads[i].name)
                    emit(traces2[i:i + 1])
    if verbose >= 3:
        print("[M::mem_process_seqs] Processed %d reads in %.3f CPU sec, "
              "%.3f real sec" % (n, time.process_time() - ctime,
                                 time.perf_counter() - rtime),
              file=sys.stderr)


def process_chunk_stream(opt: MemOptions, fm, bns, pac, chunks, pes0=None,
                         rg_id: str = "", engine=None, verbose: int = 3,
                         pool=None, n_processed: int = 0, on_start=None,
                         emit=None) -> int:
    """Drive a stream of read chunks through process_seqs with one-deep
    chunk pipelining; returns the total number of reads processed.

    `chunks` is an iterator of read lists.  When the device engine is
    active (and -v<4 tracing is off), chunk k+1's seeding + chaining
    (engine.chain_batch — the device-heavy stage) runs on a helper
    thread while chunk k's extension waves and finalization (the
    host-heavy stages) run on the main thread, so the device stays busy
    through the host-side phases — the TPU analog of the reference's
    manager thread running ahead of the worker threads
    (software/fastmap.c:320-429).  Output stays byte-identical: chunks
    are finalized and emitted strictly in input order, and `n_processed`
    numbering (the mem_mark_primary_se tie-break key, SURVEY.md §3.5)
    is assigned before any reordering can occur.

    `on_start(reads)` fires when a chunk begins processing (in chunk
    order — the CLI's "read N sequences" message), `emit(reads)` after
    its SAM strings are ready."""
    it = iter(chunks)

    def _next():
        try:
            return next(it)
        except StopIteration:
            return None

    pipelined = engine is not None and verbose < 4
    ex = None
    fut = None
    if pipelined:
        from concurrent.futures import ThreadPoolExecutor
        ex = ThreadPoolExecutor(max_workers=1)
    try:
        reads = _next()
        while reads is not None:
            if on_start is not None:
                on_start(reads)
            chains = None
            nxt = None
            if pipelined:
                # Pipelining the speculative extension waves
                # (engine.prefetch_batch) used to measure ~20% WORSE:
                # the prefetch thread's Python packing fought the main
                # thread's finalize for the GIL.  With the native C++
                # pack (GIL released) it is the default whenever the
                # native library is available; BWAMEM_TPU_PREFETCH_SPEC
                # still forces it on (=1) or off (=0).
                import os as _o
                _ps = _o.environ.get("BWAMEM_TPU_PREFETCH_SPEC")
                if _ps is None:
                    use_prefetch = getattr(engine, "_native_ok",
                                           lambda: False)()
                else:
                    use_prefetch = _ps != "0"
                stage = engine.prefetch_batch if use_prefetch else None
                if stage is not None:
                    chains = (fut.result() if fut is not None
                              else stage(opt, bns, pac, reads))
                    nxt = _next()
                    fut = (ex.submit(stage, opt, bns, pac, nxt)
                           if nxt is not None else None)
                else:
                    chains = (fut.result() if fut is not None
                              else engine.chain_batch(opt, reads))
                    nxt = _next()
                    fut = (ex.submit(engine.chain_batch, opt, nxt)
                           if nxt is not None else None)
            process_seqs(opt, fm, bns, pac, n_processed, reads, pes0,
                         rg_id, engine, verbose, pool=pool, chains=chains)
            n_processed += len(reads)
            if emit is not None:
                emit(reads)
            reads = nxt if pipelined else _next()
    finally:
        if ex is not None:
            ex.shutdown(wait=True)
    return n_processed
