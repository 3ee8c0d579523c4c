#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one GPU.

    python3 chip_smoke.py           # all phases, one GPU
    python3 chip_smoke.py --quick   # phases 1-3 and 5-8 on the bundled
                                    # genome
    python3 chip_smoke.py --kernels [--root DIR]   # phases 1-2 only
                                    # (--root: the package of another tree,
                                    # e.g. a git archive of the parent)
    python3 chip_smoke.py --real N [--root DIR]    # phase 1 and phase
                                    # 4's timed 100k SE and 20k PE runs,
                                    # N times (an A/B of the main path)
    python3 chip_smoke.py --human MBP [--repeats] [--bench-chunks K]
                          [--sa8-mb MB]
                                    # phases 1 and 9 on a genome of MBP
                                    # Mbp (~45% repeats), a K-chunk bench
                                    # (--sa8-mb: the SE run and the
                                    # kernels again at that .sa8 cap)

Phases, each printing one line with its own numbers and seconds:

1. probe: the card, its capability (must be 9.0), its power limit, nvcc,
   and the build of the CUDA kernels from csrc/ (one nvcc per source,
   all started together), with each kernel's ptxas registers, stack and
   spills;
2. kernels: each kernel against its plain PyTorch version on the same
   CUDA inputs at the main path's widths (LANES=8192, KEY_CAP=65536,
   WAVE_EXT=16384; WAVE=512 for extend2 and align2, WAVE_GLO=1024 for
   global2), on the bundled genome and on a 4,641,652 bp genome (the
   length of E. coli K-12 MG1655) generated by tools/make_biggenome.py.
   The extend2 lanes are the extension rows of the genome's seeds; the
   global2 and align2 lanes are its reads against mutated reference
   windows at their seeds.  The long buckets and the two routes' kernels
   too: the SMEM iterator step (smem1_step) at L=128/256/512, the
   superstep at L=256/512, extend_lr at LQ=256 (LT=800) and LQ=512
   (LT=1056) over the seeds of reads cut from the genome, and the row
   builder (build_rows) at LQ=128/LT=544 and LQ=256/LT=800, also against
   the host packer's rows; the long buckets' superstep and extension
   are held against their plain versions on their first 1,024 lanes
   (PLAIN_LANES), the plain versions being slow at full width.  Integer
   outputs: the tolerance is zero;
   Every record carries its bound: bytes over 3.35 TB/s or 32-bit lane
   operations over 33.5 T/s, whichever is longer (see bound()), at every
   bucket; the extensions' records also the cells the DP visits (each
   row's narrowed band), counted by the kernel's host emulation
   (ops/emulate.py), whose outputs must equal the kernel's; align2's, at
   both passes, also the bound over the cells it ran (the virtual query
   by the rows computed, from its own outputs); global2's and align2's
   the device memory their wrappers hold beyond the outputs (scratch).
   Every record carries the kernel's own device time by torch.profiler
   (profiler_ms; where the profiler recorded no launch of it, device_ms:
   the wrapper's calls captured in a CUDA graph and replayed) beside the
   CUDA-event ms around its wrapper, and the difference, the host cost
   per call (host_ms); the SA walk's also its
   chain floor (the longest walk among the launch's live keys, in steps,
   times one dependent occ-row step of the chain kernel on the same
   table); and gather_rows at 16,384 and 262,144 ids of the index's occ
   table against index_select, its library call, by CUDA events and
   device time, with microbench.launch_cost's step-by-step host cost of
   the call at 16,384.  Split tables (`mem --shard-tables`): the
   superstep and the iterator step at L=128, the SA walk and occ4 (262,144 keys, the part
   boundaries among them) over the index cut into 2 and 4 parts on this
   card, held against their plain versions over the same parts and
   against the whole-table kernel, tolerance zero, each timed right
   after the whole-table kernel (the difference is the part lookup's
   cost; the `split_kernels` line);
3. goldens: ``mem`` SE, SE -a -M and PE on tests/data through
   ``bwamem_tpu_torch.cli --device cuda``, byte-identical to the goldens
   (without @PG), then the -v 4 SE, -v 4 PE and -v 5 traces of the
   reference binary through the generator wave path;
4. real size: 100,000 SE reads and 20,000 pairs on the bacterial-size
   genome, timed (reads/s, device time per tag, host-route counters),
   then again with BWAMEM_TPU_VERIFY=1 (every extension checked against
   the native scalar twin, same output), then the first 4,000 reads and
   2,000 pairs diffed against ``bwamem_tpu.cli mem --engine host``.
   Long reads from tools/sample_reads.py --read-len on the same genome:
   50,000 SE reads of 150 bp, 20,000 pairs of 2x150 bp, 20,000 SE reads
   of 250 bp and 5,000 of 400 bp, each timed, served on the device
   (host_routed_reads 0, the L=256 or L=512 seeding bucket), its first
   2,000 reads (1,000 pairs) diffed against ``--engine host``.  The two
   routes of the flat path chosen by environment, BWAMEM_TPU_SUPERSTEP=0
   (round-per-launch seeding) and BWAMEM_TPU_ONCHIP_EXT=1 (extension
   rows built on the device): the SE and PE goldens, then the 100k SE
   and the 2x150 bp runs, timed, each equal to the default route's SAM.
   Then -v 4 on 5,000 pairs, whose SAM records equal a -v 3 run of the
   same files, and on their first 500 pairs the whole -v 4 output equal
   to ``bwamem_tpu.cli mem --engine host -v 4``; then seed-rich chunks:
   2,000 reads and 1,000 pairs of a 16 Mbp repeat genome
   (tools/make_gbp_fasta.py --repeats, ~45% repeat bases; cut from a
   human-scale genome for the time limit), byte-identical to
   ``--engine host``.  The routes their switches select, each counted on
   its own (the engine's NATIVE_REGIONS and SPECULATE module constants
   set with their variables): BWAMEM_TPU_NATIVE_FINALIZE=0 (no native
   library: the Python chain route, the speculative extension cache,
   the generators' regions, the Python finalize) on the SE, SE -a -M and
   PE goldens and the -v 4 SE trace, then on the first 10,000 SE reads
   and 2,000 pairs of the 4.64 Mbp set, timed, equal to the default
   route on the same files (the SE cut also to phase 4's SAM of those
   reads); BWAMEM_TPU_NATIVE_REGIONS=0, BWAMEM_TPU_SPECULATE=0,
   BWAMEM_TPU_GCAP_PER_LANE=0 and BWAMEM_TPU_FUSE_SA=0 (the unfused
   seeding route: the superstep alone, the SA walk a launch of its own)
   on the SE golden, and GCAP_PER_LANE=0 on the 100k SE set, timed, equal
   to phase 4's SAM.

5. ``python -m bwamem_tpu_torch.microbench all`` in this process, with
   the genome's occ table: the gather variants and occ4 at 2 x LANES
   and 2 x LANES x M ids, the chain sweep (4 MiB / 64 MiB / 4 GiB random
   tables of 16- and 128-word rows and the genome's table; dep at K = 1,
   2, 4, 8, every other mode at K = 1; 8,192 lanes x 256 steps), the
   loop and the TPU probe's gathers; every line printed and kept in
   .smoke_data/microbench.jsonl.  Each kernel call the sweep makes is
   held against its plain version on the same inputs at full width,
   tolerance zero (SweepCheck), with its bound; the sweep's own
   ``device_ms`` (calls captured in a CUDA graph and replayed, without
   the host's launch cost that CUDA events around small calls include)
   and for gather_rows the time of index_select, its library call.

6. multi-card: the engine over a reads mesh (parallel/mesh.py; every
   card when there are two or more, else two shards on card 0, and the
   line says which ran) through core.pipeline.process_chunk_stream: the
   SE, SE -a -M and PE goldens and the -v 4 SE trace byte-identical, the
   100k SE and 20k PE sets equal to phase 4's single-card SAM, timed,
   with each sharded kernel's launches per card as Kernel.launch counts
   them (every card of the mesh must show some); ``mem --mesh auto`` on
   the SE golden; pairs of ``mem --distributed`` processes (rank i on
   card i mod the cards) on the goldens and on the 100k SE set, each
   rank's records equal to its ``--shard i/2`` twin and the pair's read
   names the single run's, the pair's wall time beside a single
   process's; ``mem --profile`` on the SE golden in a fresh process,
   byte-identical, its trace naming the superstep, SA-walk and extension
   kernels.  ``--quick`` keeps the goldens.

7. split tables: the engine over the same mesh with its occ table and
   sampled SA split by rows over the shards (two parts on card 0 when
   there is one card): the SE, SE -a -M and PE goldens, the -v 4 SE trace
   and BWAMEM_TPU_SUPERSTEP=0 on the SE golden byte-identical; the 100k
   SE and 20k PE sets equal to phase 4's single-card SAM, their reads/s
   beside phase 4's and phase 6's; each kernel's launches per card; the
   device memory the engine added on each card (with two or more cards,
   at most its share of the tables); occ4 on the 4 GiB random table of
   the microbench split in 4 parts of 1 GiB against the whole table, both
   timed.  ``--quick`` keeps the goldens and the 4 GiB occ4.

8. commands: the port's other commands and entry points, each in a
   process of its own, as a user starts them (without this script's
   launch widths): ``python -m bwamem_tpu_torch.cli index`` on a copy of
   the 4.64 Mbp genome, every artifact byte-identical to
   tools/make_biggenome.py's; then all at once on the host: the staged
   fa2pac, pac2bwt, bwtupdate, bwt2sa on the bundled genome
   (tests/data/genome.fa.*), fastmap, aln (SE, r1, r2), samse, sampe and
   bwasw against the goldens, pemerge against ``bwamem_tpu.cli``'s, and
   aln + samse on 1,000 reads of phase 4's SE set against
   ``bwamem_tpu.cli``'s; ``mem --engine host`` on the SE golden with no
   CUDA context at exit; ``python -m bwamem_tpu_torch.graft_entry`` (two
   shards on card 0 with one card; its own launch counts, the superstep,
   SA walk, iterator step and extend_lr each above 0); ``python -m
   bwamem_tpu_torch.bench`` SE and PE on phase 4's dataset with
   BWAMEM_TPU_BENCH_CHUNKS=2 (its JSON lines and stage lines repeated);
   ``python -m bwamem_tpu_torch.run_eval`` on that dataset against phase
   4's host SAMs, PASS on both.  The line has each step's seconds.
   ``--quick`` keeps the bundled-genome steps, ``mem --engine host`` and
   the dry run.

9. human scale: ``python -m bwamem_tpu_torch.run3g`` on a 128 Mbp
   genome (tools/make_gbp_fasta.py, the port's ``cli index``, 2,000 SE
   reads and 1,000 pairs from tools/sample_reads.py; each step's seconds
   and peak RSS printed, and seq_len, held to twice the genome's bases):
   the host references first, all at once
   (``bwamem_tpu.cli mem --engine host`` and ``run3g host``), then
   ``run3g cuda`` in this process on the SE reads and the pairs, each
   counted on its own, its records byte-identical to both, then a
   2-chunk bench; again with BWAMEM_TPU_FORCE_I64=1 (the int64 path over
   tables past the L2); the SE run once more in its own process with its
   bench traced by torch.profiler (``run3g --profile``: the card's busy
   share); the SE diff once more with BWAMEM_TPU_ONCHIP_EXT=1 (the
   extension rows built on the card: build_rows launched, the same
   records); then the superstep, the SA walk and extend_lr against their
   plain versions at full width on this index (tolerance zero), on
   32,768 distinct SE reads of their own, each beside its phase 2 record
   at 4.64 Mbp.  With --sa8-mb MB, the SE run and the three kernels once
   more with BWAMEM_TPU_SA8_MAX_MB=MB (at human scale the dense .sa8 on
   the card beside the sparse .sa).  The line has each run's load and
   engine-up seconds, cdt, sa_intv, table bytes, host-route counters,
   bench stages and busy share, and the phase's seconds.

Launch counts are zeroed just before each path and read just after: the
default flat route (goldens, real size, long reads: superstep, SA walk
and extend_lr launched, at L=256, L=512, LQ=256 and LQ=512 too), the
SUPERSTEP=0 route (smem1_step, SA walk, extend_lr), the ONCHIP_EXT=1
route (superstep, SA walk, build_rows, extend_lr), each switch's route
(superstep, SA walk, extend_lr) and the generator wave path (extend2,
global2, align2), the microbench sweep (gather_rows,
occ4, row_chain, affine_loop), the reads mesh of phase 6 (superstep,
SA walk, extend_lr, extend2, global2) and the split tables of phase 7
(the same and smem1_step) and each run3g run of phase 9 (superstep, SA
walk, extend_lr; build_rows on the ONCHIP_EXT=1 diff).  The last three
lines are nvidia-smi's name and power limit, the kernels' JSON record
(launches, times, bounds, per-bucket launches and times) and the result
JSON; any failure exits non-zero without them.
"""

import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
EMULATE = True   # count visited DP cells by the kernels' host emulation
SPLIT = True     # check the split-table kernels (another tree may lack them)
REAL_RPS = {}    # phase 4's timed reads/s by set ("se", "pe")
SPLIT_PARTS = (2, 4)   # the split kernels' parts on one card
WIDTHS = {"BWAMEM_TPU_LANES": "8192", "BWAMEM_TPU_SA_SLICE": "32768",
          "BWAMEM_TPU_WAVE_EXT": "16384"}
DATA = os.path.join(HERE, "tests", "data")
BIG = os.path.join(HERE, ".smoke_data", "ecoli_k12_len")
BIG_ARGS = ["--mbp", "4.641652", "--n-se", "100000", "--n-pe", "20000"]
N_DIFF_SE, N_DIFF_PE = 4000, 2000
N_TRACE_PE, N_TRACE_HOST_PE = 5000, 500
REP = os.path.join(HERE, ".smoke_data", "repeat_16mbp")
REP_READS = ["--n-se", "2000", "--n-pe", "1000"]
DEVICE = "cuda"     # the port's --device for every run_mem
GOLDENS = (
    ("se", [os.path.join(DATA, "genome.fa"),
            os.path.join(DATA, "reads_se.fq")], "golden_se.sam"),
    ("se_aM", ["-a", "-M", os.path.join(DATA, "genome.fa"),
               os.path.join(DATA, "reads_se.fq")], "golden_se_aM.sam"),
    ("pe", [os.path.join(DATA, "genome.fa"), os.path.join(DATA, "reads_1.fq"),
            os.path.join(DATA, "reads_2.fq")], "golden_pe.sam"))
# long-read sets on the bacterial-size genome (tools/sample_reads.py):
# directory, SE reads, pairs, read length
LONG_SETS = (("long150", 50000, 20000, 150), ("long250", 20000, 0, 250),
             ("long400", 5000, 0, 400))
# the runs of those sets: tag, directory, files, reads, seeding bucket
LONG_RUNS = (("se150", "long150", ["reads_se.fq"], 50000, "chunks_L256"),
             ("pe150", "long150", ["reads_1.fq", "reads_2.fq"], 40000,
              "chunks_L256"),
             ("se250", "long250", ["reads_se.fq"], 20000, "chunks_L256"),
             ("se400", "long400", ["reads_se.fq"], 5000, "chunks_L512"))
N_DIFF_LONG = 2000   # reads of each long-read run diffed (pairs: half)


def say(phase, **kv):
    print(json.dumps(dict(phase=phase, **kv)), flush=True)


@contextlib.contextmanager
def environ(env):
    """env set over os.environ for the block, os.environ as it was
    afterwards."""
    saved = dict(os.environ)
    os.environ.update(env or {})
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


def run_entry(main, argv, out_path, env=None):
    """An entry point's main(argv) in this process: stdout to out_path,
    stderr captured, env set over os.environ for the call.  Returns
    (return code, stderr text, seconds)."""
    err = io.StringIO()
    so, se = sys.stdout, sys.stderr
    t0 = time.perf_counter()
    try:
        with environ(env), open(out_path, "w") as f:
            sys.stdout, sys.stderr = f, err
            rc = main(argv)
    finally:
        sys.stdout, sys.stderr = so, se
    return rc, err.getvalue(), time.perf_counter() - t0


def run_mem(args, out_path, env=None):
    """`mem` in this process through the port's CLI: stdout to out_path,
    stderr captured.  Returns (stderr text, seconds)."""
    from bwamem_tpu_torch import cli
    rc, err, dt = run_entry(cli.main_mem, ["--device", DEVICE] + args,
                            out_path, env)
    if rc != 0:
        raise RuntimeError(f"mem {args} exited {rc}:\n{err}")
    return err, dt


def sam_body(path):
    with open(path) as f:
        return [ln for ln in f.read().split("\n") if not ln.startswith("@PG")]


def device_stats(stderr_text):
    tag = "[M::main_mem] device stats: "
    for ln in stderr_text.splitlines():
        if ln.startswith(tag):
            return json.loads(ln[len(tag):])
    raise RuntimeError("no device stats line from mem")


def cuda_ms(fn, reps, warm=True):
    """Mean milliseconds of fn over reps runs, by CUDA events."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def profiler_ms(fn, name, reps=3, tries=4):
    """The device time per launch of the CUDA kernels whose name holds
    `name` (every kernel when None), by torch.profiler: the kernel alone,
    without its wrapper's host work, which CUDA events around the call
    include.  Divided by the launches the profiler recorded, which can be
    fewer than were made; a session that recorded none is run again, up
    to `tries` times.  None where none recorded such a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if (name is None or name in e.key)
                and getattr(e, "self_device_time_total", 0) > 0]
        n = sum(e.count for e in seen)
        if n:
            return sum(e.self_device_time_total for e in seen) / n / 1e3
    return None


def own_ms(fn, name):
    """(ms, key): the device time per call of fn's kernel, keyed by how
    it was read: torch.profiler's (profiler_ms), or, where its sessions
    recorded no launch of the kernel (a long process drops them), fn's
    calls captured in one CUDA graph and replayed between CUDA events
    (device_ms: the wrapper's device work without its host work).  No
    wrapper reads the device on the host, so each can be captured."""
    p = profiler_ms(fn, name)
    if p is not None:
        return p, "profiler_ms"
    from bwamem_tpu_torch.microbench import device_ms
    return device_ms(fn, 20), "device_ms"


def device_time(fn, name, ms):
    """The kernel's own time (own_ms), and the host cost per call: the
    CUDA-event ms around the wrapper less it."""
    t, key = own_ms(fn, name)
    return {key: t, "host_ms": ms - t}


def walk_steps(d, keys, max_steps):
    """The inverse-Psi steps each key's SA walk takes (the plain walk's
    loop, ops/fm.py sa_lookup_batched, counting)."""
    import torch
    from bwamem_tpu_torch.ops import fm as tfm
    mask = d.sa_intv - 1
    k = keys.to(torch.int64)
    steps = torch.zeros_like(k)
    for _ in range(max_steps):
        act = (k & mask) != 0
        if not bool(act.any()):
            break
        k = torch.where(act, tfm.inv_psi(d.blocks, d.primary_int, d.L2,
                                         d.seq_len_int, k), k)
        steps += act.to(torch.int64)
    return steps


CHAIN_LANES, CHAIN_STEPS = 8192, 256   # the chain sweep's dep, K = 1
# the time keys of a record that --kernels prints
TIME_KEYS = ("ms", "profiler_ms", "device_ms", "host_ms", "library_ms",
             "rounds_ms",
             "chain_floor", "launch_cost", "bound_ms")


def chain_ns_per_step(d):
    """One dependent occ-row step on the index's own table: the chain
    sweep's dep run (one chain of CHAIN_STEPS fetches on each of
    CHAIN_LANES lanes), its kernel's device time per step."""
    import torch
    from bwamem_tpu_torch.ops import occ as toc
    g = torch.Generator(device=d.device)
    g.manual_seed(3)
    idx0 = torch.randint(0, d.n_blocks, (1, CHAIN_LANES), generator=g,
                         device=d.device, dtype=torch.int32)
    ms, _ = own_ms(lambda: toc.row_chain_cuda(d.blocks, idx0, CHAIN_STEPS,
                                              "dep"), "row_chain_kernel")
    return ms * 1e6 / CHAIN_STEPS


GATHER_IDS = 2 * 8192   # the seeding's rows a step (2 x LANES)
GATHER_IDS_BIG = 2 * 8192 * 16   # and of a step's M = 16 intervals
GATHER_ROUNDS = 5       # alternating rounds of gather_rows and index_select


def check_gather_launch(label, d, rec):
    """gather_rows at GATHER_IDS and GATHER_IDS_BIG rows of the index's
    occ table against index_select (its library call) by CUDA events,
    beside both device times, held against the plain version; and, at
    GATHER_IDS, microbench.launch_cost's step-by-step host cost of the
    call."""
    import torch
    from bwamem_tpu_torch import microbench
    from bwamem_tpu_torch.ops import occ as toc
    g = torch.Generator(device=d.device)
    g.manual_seed(5)
    for n in (GATHER_IDS, GATHER_IDS_BIG):
        ids = torch.randint(0, d.n_blocks, (n,), generator=g,
                            device=d.device, dtype=torch.int64)
        args = (d.blocks, ids, False)
        # host-bound calls: the two alternate over GATHER_ROUNDS rounds of
        # 100 calls, so a slower spell of the host falls on both; medians
        rounds = [(cuda_ms(lambda: toc.gather_rows_cuda(*args), 100),
                   cuda_ms(lambda: torch.index_select(d.blocks, 0, ids),
                           100)) for _ in range(GATHER_ROUNDS)]
        (k_ms, ko), (lib_ms, lo) = (
            sorted((r[j] for r in rounds), key=lambda t: t[0])[
                GATHER_ROUNDS // 2]
            for j in (0, 1))
        p_ms, po = cuda_ms(lambda: toc.gather_rows_plain(*args), 1, False)
        err = max(max_err([(ko, po)]), max_err([(ko, lo)]))
        if err:
            raise RuntimeError(f"{label}: gather_rows differs ({err})")
        r = dict(index=label, bucket=f"ids{n}", ms=k_ms,
                 plain_ms=p_ms, max_abs_err=err, library_ms=lib_ms,
                 rounds_ms=[[a[0], b[0]] for a, b in rounds],
                 library_profiler_ms=profiler_ms(
                     lambda: torch.index_select(d.blocks, 0, ids), None),
                 **device_time(lambda: toc.gather_rows_cuda(*args),
                               "gather_", k_ms),
                 **bound(nbytes((ids, ko)) + OCC_ROW_BYTES * int(
                     torch.unique(ids).numel()), 0))
        if n == GATHER_IDS:
            r["launch_cost"] = microbench.launch_cost(d.blocks, n)
        rec["gather_rows"].append(r)


def scratch_bytes(fn):
    """Device memory that a call holds at its peak beyond what it returns:
    the scratch its wrapper allocates."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base - nbytes(out)


def max_err(pairs):
    """Largest |kernel - plain| over the compared arrays (0 = equal)."""
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise RuntimeError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# A kernel's bound: the least time the card could take for its work, the
# larger of its bytes over the HBM rate and its 32-bit lane operations
# over the lane rate (the H100 SXM data sheet's peaks: 3.35 TB/s, and
# 67 TFLOP/s float32 with an FMA counted as two).  Bytes
# are each input and output once and 64 per distinct occ row that the
# plain version gathered.  Operations are 96 per occ-row decode (8 BWT
# words: mask, shifts, three ANDs, three popcounts, three adds), counted
# once per distinct row for the FM walks (the plain versions run their
# lanes in lock-step, so their gather counts include finished lanes) and
# once per key for occ4; 10 per DP cell (H, E, F, their maxima) over the
# lanes' bands as their lengths and band widths give them, before z-drop
# exits and band narrowing, which only the data decide.
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 33.5e12
OCC_ROW_BYTES = 64
OPS_PER_OCC_ROW = 96
OPS_PER_CELL = 10


def bound(n_bytes, ops):
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = ops / LANE_OPS_PER_S * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations",
                bound_bytes=int(n_bytes), bound_ops=int(ops))


def nbytes(items):
    """Bytes of the tensors and arrays among items (others count 0)."""
    total = 0
    for t in items:
        if hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
        elif hasattr(t, "nbytes"):
            total += int(t.nbytes)
    return total


def band_cells(qlen, tlen, w):
    """DP cells of lanes' bands: row i < qlen covers the columns
    [max(0, i - w), min(tlen, i + w + 1))."""
    import numpy as np
    shape = np.shape(qlen)
    qlen, tlen, w = (np.broadcast_to(np.asarray(a, np.int64), shape)
                     .reshape(-1, 1) for a in (qlen, tlen, w))
    if not qlen.size:
        return 0
    i = np.arange(int(qlen.max()))[None]
    span = np.minimum(tlen, i + w + 1) - np.maximum(0, i - w)
    return int((np.clip(span, 0, None) * (i < qlen)).sum())


def ext_lane_args(pk, g, LQ, LT, opt, mat, dev):
    """extend_lr's arguments for the packed seeds g of pk, on dev."""
    import numpy as np
    import torch
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    rows = lambda k, w: T(pk[k][g][:, :w // 2])  # noqa: E731
    return (rows("lq_pk", LQ), rows("lt_pk", LT), T(pk["llq"][g]),
            T(pk["llt"][g]), rows("rq_pk", LQ), rows("rt_pk", LT),
            T(pk["rlq"][g]), T(pk["rlt"][g]), mat.to(dev), opt.o_del,
            opt.e_del, opt.o_ins, opt.e_ins, opt.w, opt.pen_clip5,
            opt.pen_clip3, opt.zdrop, T(pk["scs"][g]), T(pk["sqb"][g]),
            T(pk["srb"][g]), T(pk["rmax0"][g]), T(pk["lqv"][g]),
            T(pk["slv"][g]), LQ, LT)


def ext_bound(pk, grp, args, outs, opt, LQ, LT):
    """extend_lr's bound over the lanes grp of pk: its tensors' bytes, and
    OPS_PER_CELL a cell of the bands (both sides at w, again at 2w where
    a side retried, aw0/aw1 == 2w in the kernel's outputs); beside it, the
    tighter count of the cells the DP visits (each row's narrowed [beg,
    end) before its breaks), which the host emulation of the kernel
    (ops/emulate.py) counts over the distinct lanes, its outputs held
    equal to the kernel's (host_emulation_err)."""
    import numpy as np
    import torch
    w = opt.w
    aw0, aw1 = (outs[i].cpu().numpy() for i in (6, 7))
    q, t = {}, {}
    for s in "lr":
        q[s], t[s] = pk[f"{s}lq"][grp], pk[f"{s}lt"][grp]
    cells = sum(band_cells(q[s], t[s], w)
                + band_cells(q[s][aw == 2 * w], t[s][aw == 2 * w], 2 * w)
                for s, aw in (("l", aw0), ("r", aw1)))
    n_bytes = nbytes(args) + nbytes(outs)
    res = dict(cells=cells, **bound(n_bytes, OPS_PER_CELL * cells))
    if EMULATE:
        from bwamem_tpu_torch.ops import emulate
        u, first, inv = np.unique(grp, return_index=True, return_inverse=True)
        emu, visited = emulate.extend_lr(
            *ext_lane_args(pk, u, LQ, LT, opt, args[8], "cpu"),
            threads=os.cpu_count() or 1)
        first = torch.from_numpy(first).to(outs[0].device)
        res.update(cells_visited=int(visited[inv].sum()),
                   host_emulation_err=max_err(
                       [(a[first].cpu(), b) for a, b in zip(outs, emu)]))
        res["bound_visited_ms"] = bound(
            n_bytes, OPS_PER_CELL * res["cells_visited"])["bound_ms"]
        if res["host_emulation_err"]:
            raise RuntimeError(f"extend_lr LQ={LQ}: the host emulation "
                               f"differs from the kernel")
    return res


class RowLog:
    """The table rows a plain version fetched: which (``seen``) and how
    many fetches (``fetched``)."""

    def __init__(self, n_rows, device):
        import torch
        self.seen = torch.zeros(n_rows, dtype=torch.bool, device=device)
        self.fetched = 0

    def distinct(self):
        return int(self.seen.sum())


@contextlib.contextmanager
def rows_fetched(n_rows, device):
    """While open, every row that the plain versions fetch through
    ops/fm.py's _rows (the FM walks, occ4, the row chains) is recorded in
    the yielded RowLog."""
    from bwamem_tpu_torch.ops import fm as tfm
    log, fetch = RowLog(n_rows, device), tfm._rows

    def spy(table, ids):
        log.seen[ids.reshape(-1)] = True
        log.fetched += ids.numel()
        return fetch(table, ids)
    tfm._rows = spy
    try:
        yield log
    finally:
        tfm._rows = fetch


def fm_bound(d, plain, args, outs):
    """The bound of an FM-walk kernel: its tensors in and out, and the
    occ rows its plain version gathers on the same inputs."""
    with rows_fetched(d.n_blocks, d.device) as log:
        plain(*args)
    rows = log.distinct()
    return bound(nbytes(args) + nbytes(outs) + OCC_ROW_BYTES * rows,
                 OPS_PER_OCC_ROW * rows)


def head_fastq(src, dst, n):
    """The first n records of a FASTQ file."""
    with open(src) as f, open(dst, "w") as g:
        for i, ln in enumerate(f):
            if i >= 4 * n:
                break
            g.write(ln)
    return dst


def host_mem(args, out_path):
    """``bwamem_tpu.cli mem --engine host`` in a subprocess."""
    with open(out_path, "w") as f:
        subprocess.run([sys.executable, "-m", "bwamem_tpu.cli", "mem",
                        "--engine", "host"] + args, stdout=f,
                       stderr=subprocess.DEVNULL, check=True, cwd=HERE)


def read_fastq_seqs(path, n):
    from bwamem_tpu_torch.index.bntseq import NT4_TABLE
    import numpy as np
    seqs = []
    with open(path) as f:
        for i, ln in enumerate(f):
            if i % 4 == 1:
                seqs.append(NT4_TABLE[np.frombuffer(ln.strip().encode(),
                                                    np.uint8)].copy())
                if len(seqs) == n:
                    break
    return seqs


def check_kernels(label, idx_prefix, fq, rec, main_only=False):
    """Phase 2 on one index: each kernel against its plain version
    (main_only: the superstep, the SA walk and extend_lr, phase 9's)."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.config import MemOptions, fill_scmat
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.core import nfinalize
    from bwamem_tpu_torch.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops import fm as tfm, smem as tsm, ksw as tks
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    # the .sa8 read only where it serves
    fm_host, bns = load_index(idx_prefix,
                              load_sa8=tfm.dense_sa_serves(idx_prefix))
    eng = TorchSeedingEngine(fm_host, dev)
    d = eng.dfm
    sdr = eng.seeder
    B, L, M, OC = sdr.lanes, sdr.L, sdr.M, sdr.out_cap
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)

    # SMEM superstep: B reads (the file's reads, repeated to fill)
    seqs = read_fastq_seqs(fq, B)
    distinct = len(seqs)
    seqs = [seqs[i % len(seqs)] for i in range(B)]
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        q[i, :len(s)] = s
        qlen[i] = len(s)
    sl = int(opt.min_seed_len * opt.split_factor + .499)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = (d, T(q[:, 0::2] | (q[:, 1::2] << np.int8(4))), T(qlen),
            T(np.ones(B, np.int64)), T(np.ones(B, np.uint8)),
            T(np.minimum(sl, qlen).astype(np.int32)),
            T(np.full(B, opt.split_width, np.int32)), L, M, OC)
    k_ms, ko = cuda_ms(lambda: tsm.superstep_cuda(*args), 3)
    p_ms, po = cuda_ms(lambda: tsm.superstep_plain(*args), 1, False)
    err = superstep_err(ko, po, OC)
    if err:
        raise RuntimeError(f"{label}: superstep differs ({err})")
    rec["smem_superstep"].append(dict(
        index=label, ms=k_ms, plain_ms=p_ms, max_abs_err=err, lanes=B,
        distinct_reads=distinct, over=int(po[5].sum()), bucket="L128",
        **device_time(lambda: tsm.superstep_cuda(*args), "superstep_kernel",
                      k_ms),
        **fm_bound(d, tsm.superstep_plain, args, ko)))

    # SA walk: the main path's KEY_CAP occurrence keys of those reads
    c0, cs, cqb, cqe, n, _ = tsm.compact_streams(*ko[:4], ko[4], ko[5],
                                                 sdr.gcap_per * B)
    total = n.long().sum()
    keep = ((torch.arange(len(c0), device=dev) < total)
            & (cqe.long() - cqb.long() >= opt.min_seed_len)
            & (cs <= opt.max_occ))
    keys, n_keys = tsm.ragged_expand(c0, torch.where(keep, cs, 0),
                                     sdr.key_cap)
    k_ms, kv = cuda_ms(lambda: tfm.sa_walk_cuda(d, keys, sdr.sa_max_steps),
                       3)
    p_ms, pv = cuda_ms(lambda: tfm.sa_lookup_batched(d, keys,
                                                     sdr.sa_max_steps),
                       1, False)
    nk = min(int(n_keys), sdr.key_cap)
    err = max_err([(kv[0][:nk], pv[0][:nk]), (kv[1][:nk], pv[1][:nk])])
    if err or not torch.equal(kv[1], pv[1]):
        raise RuntimeError(f"{label}: SA walk differs ({err})")
    sa_b = bound(nk * d.sa.element_size(), 0)["bound_bytes"]
    fb = fm_bound(d, lambda *a: tfm.sa_lookup_batched(d, *a),
                  (keys, sdr.sa_max_steps), kv)
    fb.update(bound(fb["bound_bytes"] + sa_b, fb["bound_ops"]))
    # its chain floor: the longest walk among the live keys, each step a
    # dependent occ-row fetch at this table size
    longest = int(walk_steps(d, keys[:nk], sdr.sa_max_steps).max()) \
        if nk else 0
    ns = chain_ns_per_step(d)
    rec["sa_walk"].append(dict(
        index=label, ms=k_ms, plain_ms=p_ms, max_abs_err=err,
        keys=len(keys), live_keys=nk, longest_walk=longest,
        chain_ns_per_step=ns, chain_floor_ms=longest * ns / 1e6,
        sa_intv=d.sa_intv, sa_bytes=d.sa.nbytes,
        **device_time(lambda: tfm.sa_walk_cuda(d, keys, sdr.sa_max_steps),
                      "sa_walk_kernel", k_ms), **fb))
    if not main_only:
        check_gather_launch(label, d, rec)

    # extension: one WAVE_EXT group of this genome's seeds, size-sorted
    reads = []
    for r in parse_fastx(fq):
        reads.append(r)
        if len(reads) == 4 * B:
            break
    cb = eng.chain_batch(opt, reads)
    pk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, reads,
                                     cb.flat, eng._ext_lq, eng._ext_lt)
    lanes = np.nonzero(pk["served"] == 0)[0]
    lanes = lanes[np.argsort(pk["lt_need"][lanes], kind="stable")]
    W = eng.wave_ext
    grp = np.resize(lanes, W)           # repeat lanes to fill the wave
    LQ = eng._ext_lq
    LT = next(b for b in eng.lt_buckets
              if b >= int(pk["lt_need"][grp].max()))
    ext_args = ext_lane_args(pk, grp, LQ, LT, opt, eng._mat_dev(opt), dev)
    k_ms, ke = cuda_ms(lambda: tks.extend_lr_cuda(*ext_args), 3)
    p_ms, pe_ = cuda_ms(lambda: tks.extend_lr_plain(*ext_args), 1, False)
    err = max_err(list(zip(ke, pe_)))
    if err:
        raise RuntimeError(f"{label}: extension differs ({err})")
    rec["extend_lr"].append(dict(
        index=label, ms=k_ms, plain_ms=p_ms, max_abs_err=err, lanes=W,
        LT=LT, distinct_seeds=len(lanes), bucket="LQ128",
        **device_time(lambda: tks.extend_lr_cuda(*ext_args),
                      "extend_lr_kernel", k_ms),
        **ext_bound(pk, grp, ext_args, ke, opt, LQ, LT)))
    if not main_only:
        check_sw_kernels(label, eng, bns, opt, reads, cb.flat, pk, rec)
        check_long_kernels(label, eng, bns, opt, (q, qlen), reads, cb.flat,
                           pk, rec)
        if SPLIT:
            check_split_kernels(label, fm_host, args, keys, n_keys, eng,
                                (q, qlen), rec)
    del eng
    torch.cuda.empty_cache()
    say("kernels", index=label, blocks=int(d.n_blocks),
        cdt=str(d.cdt).replace("torch.", ""),
        seconds=time.perf_counter() - t0,
        results={k: [r for r in v if r["index"] == label]
                 for k, v in rec.items()})


def check_sw_kernels(label, eng, bns, opt, reads, flat, pk, rec):
    """Phase 2, the wave-path kernels: extend2 over the seeds' extension
    rows, global2 and align2 over reads against mutated reference
    windows at their first seed, each at its wave width."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.index.bntseq import get_seq
    from bwamem_tpu_torch.ops import ksw as tks, ksw_align as tka
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(7)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    mat = eng._mat_dev(opt)
    gap = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
    pk4 = lambda a: a[:, 0::2] | (a[:, 1::2] << np.int8(4))  # noqa: E731

    # extend2: both sides of every seed with an extension, WAVE lanes
    LQ, LT = eng._ext_lq, eng._ext_lt
    sides = [(pk["lq_pk"], pk["lt_pk"], pk["llq"], pk["llt"],
              opt.pen_clip5), (pk["rq_pk"], pk["rt_pk"], pk["rlq"],
                               pk["rlt"], opt.pen_clip3)]
    cols = [[], [], [], [], [], []]
    for q, t, ql, tl, bonus in sides:
        ok = np.nonzero((pk["served"] == 0) & (ql > 0))[0]
        for c, a in zip(cols, (q[ok], t[ok], ql[ok], tl[ok],
                               np.full(len(ok), bonus, np.int32),
                               pk["scs"][ok])):
            c.append(a)
    sel = np.resize(np.arange(sum(len(c) for c in cols[0])), eng.wave)
    q, t, ql, tl, eb, h0 = (np.concatenate(c)[sel] for c in cols)
    args = (T(q), T(t[:, :LT // 2]), T(ql), T(tl), mat, *gap,
            T(np.full(eng.wave, opt.w, np.int32)), T(eb), opt.zdrop, T(h0),
            LQ, LT)
    k_ms, ko = cuda_ms(lambda: tks.extend2_cuda(*args), 3)
    p_ms, po = cuda_ms(lambda: tks.extend2_plain(*args), 1, False)
    err = max_err(list(zip(ko, po)))
    if err:
        raise RuntimeError(f"{label}: extend2 differs ({err})")
    cells = band_cells(ql, tl, opt.w)
    r2 = dict(index=label, ms=k_ms, plain_ms=p_ms, max_abs_err=err,
              lanes=eng.wave, LT=LT, cells=cells,
              **device_time(lambda: tks.extend2_cuda(*args),
                            "extend2_kernel", k_ms),
              **bound(nbytes(args) + nbytes(ko), OPS_PER_CELL * cells))
    if EMULATE:   # the cells visited, by the kernel's host emulation
        from bwamem_tpu_torch.ops import emulate
        emu, visited = emulate.extend2(*args)
        r2.update(cells_visited=int(visited.sum()),
                  host_emulation_err=max_err(
                      [(a.cpu(), b) for a, b in zip(ko, emu)]))
        r2["bound_visited_ms"] = bound(
            nbytes(args) + nbytes(ko),
            OPS_PER_CELL * r2["cells_visited"])["bound_ms"]
        if r2["host_emulation_err"]:
            raise RuntimeError(f"{label}: extend2's host emulation differs "
                               f"from the kernel")
    rec["extend2"].append(r2)

    # reads and the reference start of their first seed
    chain_off, seed_off, s_rb, s_qb, _ = flat
    l_pac = bns.l_pac
    places = []
    for i, r in enumerate(reads):
        if chain_off[i + 1] > chain_off[i]:
            s = seed_off[chain_off[i]]
            places.append((r.seq_nt4, int(s_rb[s]) - int(s_qb[s])))

    def window(beg, end):
        """The reference on [beg, end) with 2% substitutions and, on half
        the calls, one short indel."""
        ref = get_seq(l_pac, bns.pac, beg, end).astype(np.int8)
        mut = rng.random(len(ref)) < 0.02
        ref[mut] = rng.integers(0, 4, int(mut.sum()))
        if len(ref) > 20 and rng.random() < 0.5:
            at, k = int(rng.integers(5, len(ref) - 5)), int(rng.integers(1, 4))
            ref = (np.concatenate([ref[:at], rng.integers(0, 4, k), ref[at:]])
                   if rng.random() < 0.5 else np.delete(ref, range(at, at + k)))
        return ref.astype(np.int8)

    # global2: the read against its window, WAVE_GLO lanes
    GLQ, GLT, W = eng._glo_lq, eng._glo_lt, eng.wave_glo
    qb = np.full((W, GLQ), 4, np.int8)
    tb = np.full((W, GLT), 4, np.int8)
    sc = np.zeros((3, W), np.int32)
    for b in range(W):
        q, st = places[b % len(places)]
        t = window(st, st + len(q) + int(rng.integers(-8, 17)))[:GLT]
        if not len(t):
            t = np.zeros(1, np.int8)
        qb[b, :len(q)], tb[b, :len(t)] = q, t
        sc[:, b] = (len(q), len(t),
                    abs(len(t) - len(q)) + int(rng.integers(3, 40)))
    args = (T(pk4(qb)), T(pk4(tb)), T(sc[0]), T(sc[1]), mat, *gap, T(sc[2]),
            GLQ, GLT)
    k_ms, ko = cuda_ms(lambda: tks.global_cuda(*args), 3)
    p_ms, po = cuda_ms(lambda: tks.global_plain(*args), 1, False)
    err = max_err(list(zip(ko, po)))
    if err:
        raise RuntimeError(f"{label}: global2 differs ({err})")
    cells = band_cells(sc[0], sc[1], sc[2])
    rec["global2"].append(dict(
        index=label, ms=k_ms, plain_ms=p_ms, max_abs_err=err, lanes=W,
        LQ=GLQ, LT=GLT, cells=cells,
        **device_time(lambda: tks.global_cuda(*args), "global_kernel",
                      k_ms),
        device_scratch_bytes=scratch_bytes(lambda: tks.global_cuda(*args)),
        **bound(nbytes(args) + nbytes(ko), OPS_PER_CELL * cells)))

    # align2: the read against a ~500 bp window around it, WAVE lanes,
    # u8 and i16 passes, a third of the lanes with an endsc stop
    LQV, ALT, W = 128, eng._ext_lt, eng.wave
    qb = np.full((W, LQV), 4, np.int8)
    tb = np.full((W, ALT), 4, np.int8)
    sc = np.zeros((2, W), np.int32)
    for b in range(W):
        q, st = places[b % len(places)]
        t = window(st - 200, st + len(q) + 200)[:ALT]
        qb[b, :len(q)], tb[b, :len(t)] = q, t
        sc[:, b] = (len(q), len(t))
    endsc = np.where(rng.random(W) < 0.33, rng.integers(20, 80, W),
                     0x10000).astype(np.int32)
    res = dict(index=label, lanes=W, LT=ALT, max_abs_err=0)
    cells = int((sc[0].astype(np.int64) * sc[1]).sum())
    for size in (1, 2):
        shift = -int(mat.min()) if size == 1 else 0
        args = (T(qb), T(tb), T(sc[0]), T(sc[1]), mat, *gap, T(endsc),
                shift, size, LQV, ALT)
        k_ms, ko = cuda_ms(lambda: tka.align_cuda(*args), 3)
        p_ms, po = cuda_ms(lambda: tka.align_plain(*args), 1, False)
        err = max_err(list(zip(ko, po)))
        if err:
            raise RuntimeError(f"{label}: align2 size {size} differs ({err})")
        tag = "u8" if size == 1 else "i16"
        # the cells run: vlen (the virtual query) by the rows the kernel
        # computed (last + 1), from its own outputs
        p = 16 if size == 1 else 8
        run = int(((sc[0].astype(np.int64) + p - 1) // p * p
                   * (ko[5].cpu().numpy().astype(np.int64) + 1)).sum())
        bd = bound(nbytes(args) + nbytes(ko), OPS_PER_CELL * cells)
        dt = device_time(lambda: tka.align_cuda(*args),
                         f"align_kernel<{size}", k_ms)
        res.update({f"ms_{tag}": k_ms, f"plain_ms_{tag}": p_ms,
                    f"profiler_ms_{tag}": dt.get("profiler_ms"),
                    f"device_ms_{tag}": dt.get("device_ms"),
                    f"host_ms_{tag}": dt["host_ms"],
                    f"bound_ms_{tag}": bd["bound_ms"],
                    f"bound_by_{tag}": bd["bound_by"],
                    f"cells_run_{tag}": run,
                    f"bound_run_ms_{tag}": bound(nbytes(args) + nbytes(ko),
                                                 OPS_PER_CELL * run)
                    ["bound_ms"]})
        if size == 1:
            res.update(cells=cells, device_scratch_bytes=scratch_bytes(
                lambda: tka.align_cuda(*args)), **bd)
    # the kernels line reports the u8 pass: bwa's mate rescue of reads
    # shorter than 250 bp takes it (KSW_XBYTE when l_ms * a < 250)
    res.update(ms=res["ms_u8"], plain_ms=res["plain_ms_u8"],
               profiler_ms=res["profiler_ms_u8"],
               device_ms=res["device_ms_u8"], host_ms=res["host_ms_u8"])
    rec["align2"].append(res)


def cut_reads(bns, n, L, seed):
    """n reads of L/2+1..L bp cut from the index's reference (both
    strands): the first four exact full-length copies, the rest with 1%
    substitutions and, in a third of them, an N."""
    import numpy as np
    from bwamem_tpu_torch.core.pipeline import encode_read
    from bwamem_tpu_torch.index.bntseq import get_seq
    from bwamem_tpu_torch.io.fastq import Read
    rng = np.random.default_rng(seed)
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    reads = []
    for i in range(n):
        ln = L if i < 4 else int(rng.integers(L // 2 + 1, L + 1))
        beg = int(rng.integers(0, 2 * bns.l_pac - ln))
        if beg < bns.l_pac < beg + ln:
            beg = bns.l_pac
        s = get_seq(bns.l_pac, bns.pac, beg, beg + ln).astype(np.int64)
        if i >= 4:
            mut = rng.random(ln) < 0.01
            s[mut] = rng.integers(0, 4, int(mut.sum()))
            if rng.random() < 0.33:
                s[int(rng.integers(0, ln))] = 4
        r = Read(f"cut{i}", None, acgtn[s].tobytes().decode(), "I" * ln)
        encode_read(r)
        reads.append(r)
    return reads


def lane_queries(seqs, B, L):
    """B lanes of nt4 queries (the reads repeated to fill), packed two
    bases a byte, and their lengths."""
    import numpy as np
    q = np.full((B, L), 4, np.int8)
    qlen = np.zeros(B, np.int32)
    for i in range(B):
        s = seqs[i % len(seqs)]
        q[i, :len(s)] = s
        qlen[i] = len(s)
    return q[:, 0::2] | (q[:, 1::2] << np.int8(4)), qlen


PLAIN_LANES = 1024   # lanes held against a plain version that is slow


def check_long_kernels(label, eng, bns, opt, q128, reads, flat, pk, rec):
    """Phase 2, the long buckets and the two routes' kernels: the SMEM
    iterator step at L=128/256/512, the superstep at L=256/512, the
    fused extension at LQ=256 (LT=800) and LQ=512 (LT=1056), and the row
    builder at LQ=128/LT=544 and LQ=256/LT=800 against its plain version
    and the host packer's rows.  Where the plain version is slow at full
    width (the superstep and the extension of the long buckets), the
    kernel runs at full width and the first PLAIN_LANES lanes are held
    against the plain version run on those lanes alone (lanes are
    independent)."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.core import nfinalize
    from bwamem_tpu_torch.ops import extbuild as teb, ksw as tks, smem as tsm
    dev = torch.device(DEVICE)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    d, sdr = eng.dfm, eng.seeder
    B, M = sdr.lanes, sdr.M
    sl = int(opt.min_seed_len * opt.split_factor + .499)
    cut = {L: cut_reads(bns, 2048, L, L) for L in (256, 512)}

    def smem_args(qp, qlen, n, x=None):
        base = (d, T(qp[:n]), T(qlen[:n]))
        if x is not None:
            base += (T(x[:n]),)
        return base + (T(np.ones(n, np.int64)), T(np.ones(n, np.uint8)),
                       T(np.minimum(sl, qlen[:n]).astype(np.int32)),
                       T(np.full(n, opt.split_width, np.int32)))

    # the iterator step (BWAMEM_TPU_SUPERSTEP=0): pass 1 from a random
    # position of each read, the re-seeding test, pass 2
    for L in (128, 256, 512):
        if L == 128:
            q, qlen = q128
            qp = q[:, 0::2] | (q[:, 1::2] << np.int8(4))
        else:
            qp, qlen = lane_queries([r.seq_nt4 for r in cut[L]], B, L)
        x = (np.random.default_rng(L).random(B) * qlen).astype(np.int32)
        args = smem_args(qp, qlen, B, x) + (L, M, sdr.m_out)
        k_ms, ko = cuda_ms(lambda: tsm.smem_iter_step_cuda(*args), 3)
        p_ms, po = cuda_ms(lambda: tsm.smem_iter_step_plain(*args), 1, False)
        err = max_err(list(zip(ko, po)))
        if err:
            raise RuntimeError(f"{label}: smem1_step L={L} differs ({err})")
        rec["smem1_step"].append(dict(
            index=label, bucket=f"L{L}", ms=k_ms, plain_ms=p_ms,
            max_abs_err=err, lanes=B, need2=int(ko[8].sum()),
            over=int(ko[7].sum()),
            **device_time(lambda: tsm.smem_iter_step_cuda(*args),
                          "iter_step_kernel", k_ms),
            **fm_bound(d, tsm.smem_iter_step_plain, args, ko)))

    # the superstep at the long buckets, with their stream caps; the
    # plain version runs on the distinct reads (the other lanes repeat
    # them) with the table rows it fetches logged for the bound
    for L in (256, 512):
        s_L = eng._seeder_for(L)
        qp, qlen = lane_queries([r.seq_nt4 for r in cut[L]], B, L)
        tail = (L, M, s_L.out_cap)
        k_args = smem_args(qp, qlen, B) + tail
        k_ms, ko = cuda_ms(lambda: tsm.superstep_cuda(*k_args), 3)
        n = min(len(cut[L]), B)
        with rows_fetched(d.n_blocks, d.device) as log:
            p_ms, po = cuda_ms(
                lambda: tsm.superstep_plain(*smem_args(qp, qlen, n), *tail),
                1, False)
        rows = log.distinct()
        fb = bound(nbytes(k_args) + nbytes(ko) + OCC_ROW_BYTES * rows,
                   OPS_PER_OCC_ROW * rows)
        ko = [a[:n] for a in ko]
        err = superstep_err(ko, po, s_L.out_cap)
        if err:
            raise RuntimeError(f"{label}: superstep L={L} differs ({err})")
        over = po[5]
        slot = (torch.arange(s_L.out_cap, device=dev).unsqueeze(0)
                < po[4].unsqueeze(1)) & ~over.unsqueeze(1)
        full = int((ko[3][slot] == L).sum())
        rec["smem_superstep"].append(dict(
            index=label, bucket=f"L{L}", ms=k_ms, plain_ms=p_ms,
            max_abs_err=err, lanes=B, plain_lanes=n, over=int(over.sum()),
            full_length_matches=full,
            **device_time(lambda: tsm.superstep_cuda(*k_args),
                          "superstep_kernel", k_ms), **fb))

    # the fused extension at the long query buckets: seeds of the cut
    # reads at the bucket's widest target
    W = eng.wave_ext
    mat = eng._mat_dev(opt)
    long_pk = {}
    for L, LT in ((256, 800), (512, 1056)):
        rl = cut[L]
        fl = eng.chain_batch(opt, rl).flat
        lpk = nfinalize.pack_extlr_native(opt, bns.l_pac, bns.pac, rl, fl,
                                          L, LT)
        long_pk[L] = (rl, fl, lpk)
        lanes = np.nonzero(lpk["served"] == 0)[0]
        grp = np.resize(lanes, W)
        full_args = ext_lane_args(lpk, grp, L, LT, opt, mat, dev)
        k_ms, ke = cuda_ms(lambda: tks.extend_lr_cuda(*full_args), 3)
        n = PLAIN_LANES
        p_args = ext_lane_args(lpk, grp[:n], L, LT, opt, mat, dev)
        p_ms, pe_ = cuda_ms(lambda: tks.extend_lr_plain(*p_args), 1, False)
        err = max_err([(a[:n], b) for a, b in zip(ke, pe_)])
        if err:
            raise RuntimeError(f"{label}: extension LQ={L} differs ({err})")
        rec["extend_lr"].append(dict(
            index=label, bucket=f"LQ{L}", ms=k_ms, plain_ms=p_ms,
            max_abs_err=err, lanes=W, plain_lanes=n, LT=LT,
            distinct_seeds=len(lanes),
            longest_side=int(max(lpk["llq"][lanes].max(),
                                 lpk["rlq"][lanes].max())),
            **device_time(lambda: tks.extend_lr_cuda(*full_args),
                          "extend_lr_kernel", k_ms),
            **ext_bound(lpk, grp, full_args, ke, opt, L, LT)))

    # the row builder (BWAMEM_TPU_ONCHIP_EXT=1) over WAVE_EXT seeds
    pac_d = teb.pac_tensor(bns.pac).to(dev)
    for LQ, LT, rds, fl, bpk in ((128, 544, reads, flat, pk),
                                 (256, 800) + long_pk[256]):
        lanes = np.nonzero(bpk["served"] == 0)[0]
        g = np.resize(lanes, W)
        rid = nfinalize.seed_read_ids(fl, len(rds))
        args = (T(teb.reads_matrix([r.seq_nt4 for r in rds],
                                   max(len(r.seq_nt4) for r in rds))),
                pac_d, bns.l_pac, T(rid[g]), T(bpk["sqb"][g]),
                T(bpk["slv"][g]), T(bpk["srb"][g]), T(bpk["rmax0"][g]),
                T((bpk["srb"] + bpk["slv"] + bpk["rlt"])[g]),
                T(bpk["lqv"][g]), LQ, LT)
        k_ms, ko = cuda_ms(lambda: teb.build_rows_cuda(*args), 3)
        p_ms, po = cuda_ms(lambda: teb.build_rows_plain(*args), 1, False)
        err = max_err(list(zip(ko, po)))
        host_err = max_err([(a, T(bpk[k][g][:, :a.shape[1]])) for a, k in
                            zip(ko, ("lq_pk", "lt_pk", "rq_pk", "rt_pk"))])
        if err or host_err:
            raise RuntimeError(f"{label}: build_rows LQ={LQ} LT={LT} differs "
                               f"(plain {err}, host rows {host_err})")
        out_b = nbytes(ko)
        rec["build_rows"].append(dict(
            index=label, bucket=f"LQ{LQ}", ms=k_ms, plain_ms=p_ms,
            max_abs_err=err, host_rows_err=host_err, lanes=W, LT=LT,
            distinct_seeds=len(lanes),
            **device_time(lambda: teb.build_rows_cuda(*args),
                          "build_rows_kernel", k_ms),
            **bound(nbytes(args[:1] + args[3:]) + out_b // 2 + out_b, 0)))


OCC4_KEYS = 2 * 8192 * 16   # the sweep's occ4 keys (2 x LANES x M)
OCC4_TABLE_BYTES = 4 << 30  # the microbench's largest random table


def superstep_err(ko, po, out_cap):
    """The superstep's outputs compared on the slots the consumer reads
    (its over flags, n_out and slots [0, n_out) of the lanes that did
    not overflow); 0 where they are equal."""
    import torch
    if not torch.equal(ko[5], po[5]):
        return 1
    ok = ~po[5]
    slot = (torch.arange(out_cap, device=po[4].device).unsqueeze(0)
            < po[4].unsqueeze(1)) & ok.unsqueeze(1)
    return max_err([(ko[i][slot], po[i][slot]) for i in range(4)]
                   + [(ko[4][ok], po[4][ok])])


def occ4_keys(n_rows, primary, seq_len, n, seed, device):
    """n occ4 keys: -1, 0, primary and its neighbours, seq_len - 1, the
    keys of the first and last row of every part of SPLIT_PARTS splits,
    then keys drawn from [-1, seq_len]."""
    import torch
    from bwamem_tpu_torch.ops.fm import SplitTable
    edge = [-1, 0, primary - 1, primary, primary + 1, seq_len - 1]
    for parts in SPLIT_PARTS:
        rows = SplitTable.part_rows(n_rows, parts)
        for i in range(1, parts):
            for kk in (i * rows * 128 - 1, i * rows * 128):
                if 0 <= kk < seq_len:
                    edge.append(kk + (kk >= primary))
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    k = torch.randint(-1, seq_len + 1, (n,), generator=g, device=device)
    k[:len(edge)] = torch.tensor(edge, device=device)
    return k


def check_split_kernels(label, fm_host, sargs, keys, n_keys, eng, q128,
                        rec):
    """Phase 2, the split tables (`mem --shard-tables`): the superstep
    (the main path's lanes at L=128), the iterator step (L=128, from the
    positions check_long_kernels draws), the SA walk (KEY_CAP keys) and
    occ4 (OCC4_KEYS keys) over the index split into 2 and 4 parts on
    this card, each held at full width against its plain version over
    the same parts and against the whole-table kernel (tolerance zero).
    The whole-table kernel is timed right before each split one, both
    by CUDA events and by their own device time: the difference is what
    the part lookup costs.  The bound is the whole-table kernel's: the
    work is the same."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import fm as tfm, occ as toc, smem as tsm
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    t0 = time.perf_counter()
    d, sdr = eng.dfm, eng.seeder
    dev = d.device
    B = sdr.lanes
    q, qlen = q128
    x = torch.from_numpy((np.random.default_rng(128).random(B) * qlen)
                         .astype(np.int32)).to(dev)
    okeys = occ4_keys(d.n_blocks, d.primary_int, d.seq_len_int, OCC4_KEYS,
                      9, dev)
    tail = sargs[7:]
    cases = (   # kernel record, wrapper, plain, args of an index, compare
        ("smem_superstep", "L128", tsm.superstep_cuda, tsm.superstep_plain,
         lambda f: (f,) + sargs[1:], lambda a, b: superstep_err(a, b,
                                                               tail[2])),
        ("smem1_step", "L128", tsm.smem_iter_step_cuda,
         tsm.smem_iter_step_plain,
         lambda f: (f, sargs[1], sargs[2], x) + sargs[3:7]
         + (tail[0], tail[1], sdr.m_out), lambda a, b: max_err(zip(a, b))),
        ("sa_walk", None, tfm.sa_walk_cuda, tfm.sa_lookup_batched,
         lambda f: (f, keys, sdr.sa_max_steps),
         lambda a, b: max_err(zip(a, b))),
        ("occ4", None, toc.occ4_cuda, tfm.occ4,
         lambda f: (f.blocks, f.primary_int, okeys),
         lambda a, b: max_err([(a, b)])))
    symbol = dict(SYMBOLS, occ4="occ4_kernel")
    out = {}
    for parts in SPLIT_PARTS:
        sp = DeviceFmIndex.from_host(fm_host).split([dev] * parts)
        for name, bucket, kern, plain, make, cmp in cases:
            w_ms, wo = cuda_ms(lambda: kern(*make(d)), 3)
            k_ms, ko = cuda_ms(lambda: kern(*make(sp)), 3)
            p_ms, po = cuda_ms(lambda: plain(*make(sp)), 1, False)
            err = max(cmp(ko, po), cmp(ko, wo))
            if err:
                raise RuntimeError(f"{label}: {name} over {parts} parts "
                                   f"differs ({err})")
            w_dev, w_key = own_ms(lambda: kern(*make(d)), symbol[name])
            k_dev, k_key = own_ms(lambda: kern(*make(sp)), symbol[name])
            if name == "occ4":   # its keys, output and distinct rows
                kk = okeys - (okeys >= d.primary_int).long()
                rows = int(torch.unique(kk[okeys >= 0] >> 7).numel())
                bd = bound(nbytes((okeys, ko)) + OCC_ROW_BYTES * rows,
                           OPS_PER_OCC_ROW * okeys.numel())
            else:                # the whole-table record's, same inputs
                like = [r for r in rec[name] if r.get("index") == label
                        and r.get("bucket") == bucket and "bound_ms" in r]
                bd = {k: like[-1][k] for k in ("bound_ms", "bound_by",
                                               "bound_bytes", "bound_ops")}
            r = dict(index=label, bucket=f"{bucket or 'main'}_split{parts}",
                     split=parts, ms=k_ms, plain_ms=p_ms, max_abs_err=err,
                     whole_ms=w_ms, device_ms_by=k_key, device_ms=k_dev,
                     whole_device_ms=w_dev, lookup_cost_ms=k_dev - w_dev,
                     **bd)
            rec[name].append(r)
            out.setdefault(name, []).append(r)
        del sp
        torch.cuda.empty_cache()
    say("split_kernels", index=label, parts=list(SPLIT_PARTS),
        keys=int(n_keys), occ4_keys=OCC4_KEYS, results=out,
        seconds=time.perf_counter() - t0)


MAIN_SHAPES = {   # the record of each occ-row kernel in the kernels line
    "gather_rows": lambda ln: (ln["table_name"].startswith("index:")
                               and ln["ids"] == 2 * 8192 * 16),
    "occ4": lambda ln: (ln["table_name"].startswith("index:")
                        and ln["ids"] == 2 * 8192 * 16),
    "row_chain": lambda ln: (ln["table_bytes"] == 4 << 30
                             and ln["width"] == 16 and ln["mode"] == "dep"
                             and ln["K"] == 1 and ln["lanes"] == 8192),
    "affine_loop": lambda ln: True}
CHAIN_STEP_OPS = 8   # a chain step's next id: xor, multiply, adds, modulo


class SweepCheck:
    """microbench.run's check: every kernel call of the sweep against its
    plain version on the same CUDA inputs, at full width and tolerance
    zero, with its bound; one record per call in rec.  Bytes are the
    inputs and outputs once and each distinct table row once (the rows
    the plain version fetched); operations are 96 per occ4 key, and for
    a chain a row's words summed plus CHAIN_STEP_OPS a step."""

    def __init__(self, rec):
        self.rec = rec

    def __call__(self, kernel, line, out, args, library=None):
        import torch
        from bwamem_tpu_torch.ops import occ as toc
        plain = {"gather_rows": toc.gather_rows_plain,
                 "occ4": toc.occ4_plain, "row_chain": toc.row_chain_plain,
                 "affine_loop": toc.affine_loop_plain}[kernel]
        p_ms, po = cuda_ms(lambda: plain(*args), 1, False)
        if kernel == "affine_loop":
            err = float((out - po).abs().max())
            err = err or line["max_abs_diff"]   # against one-step launches
        else:
            err = max_err([(out, po)])
        if err or line.get("result", "OK") != "OK" \
                or line.get("equal_to_index_select") is False:
            raise RuntimeError(f"{kernel} differs from its plain version "
                               f"({err}): {line}")
        table = args[0]
        if kernel == "gather_rows":
            ids = args[1]
            ok = (ids >= 0) & (ids < table.shape[0])
            rows = int(torch.unique(ids[ok]).numel())
            bd = bound(nbytes((ids, out))
                       + rows * table.shape[1] * table.element_size(), 0)
        elif kernel == "affine_loop":
            bd = bound(2 * nbytes(args[:1]), 2 * table.numel() * args[1])
        else:
            with rows_fetched(table.shape[0], table.device) as log:
                plain(*args)
            row_b = table.shape[1] * table.element_size()
            if kernel == "occ4":
                bd = bound(nbytes((args[2], out)) + row_b * log.distinct(),
                           OPS_PER_OCC_ROW * args[2].numel())
            else:
                idx0, T = args[1], args[2]
                bd = bound(nbytes((idx0, out)) + row_b * log.distinct(),
                           table.shape[1] * log.fetched
                           + CHAIN_STEP_OPS * idx0.numel() * T)
        r = dict(index=line.get("table_name", "random_64x128"),
                 ms=line.get("ms", line.get("ms_in_kernel")),
                 device_ms=line.get("device_ms",
                                    line.get("device_ms_in_kernel")),
                 plain_ms=p_ms, max_abs_err=err, **bd,
                 library_ms=(library or {}).get("ms"),
                 library_device_ms=(library or {}).get("device_ms"))
        if not MAIN_SHAPES[kernel](line):
            r["bucket"] = "_".join(
                str(line[k]) for k in ("sub", "mode", "K", "lanes", "ids")
                if k in line)
        self.rec[kernel].append(r)


def microbench_sweep(idx_prefix, rec):
    """The slice's main path: ``python -m bwamem_tpu_torch.microbench
    all`` in this process (gather, chain, loop and probe at their
    defaults, with the index's occ table), each kernel call held against
    its plain version by SweepCheck, each line printed and kept in
    .smoke_data/microbench.jsonl."""
    from bwamem_tpu_torch import microbench
    t0 = time.perf_counter()
    args = microbench.parser().parse_args(["all", "--index", idx_prefix])
    lines = microbench.run(args, emit=lambda ln: say("microbench", **ln),
                           check=SweepCheck(rec))
    with open(os.path.join(HERE, ".smoke_data", "microbench.jsonl"),
              "w") as f:
        f.writelines(json.dumps(ln) + "\n" for ln in lines)
    say("microbench_done", lines=len(lines),
        checked={k: len(rec[k]) for k in MAIN_SHAPES},
        results={k: rec[k] for k in MAIN_SHAPES},
        seconds=time.perf_counter() - t0)


def main(argv):
    global EMULATE, SPLIT
    quick = "--quick" in argv
    kernels_only = "--kernels" in argv
    real_runs = int(argv[argv.index("--real") + 1]) if "--real" in argv \
        else 0
    root = argv[argv.index("--root") + 1] if "--root" in argv else HERE
    human = float(argv[argv.index("--human") + 1]) if "--human" in argv \
        else 0
    human_chunks = int(argv[argv.index("--bench-chunks") + 1]) \
        if "--bench-chunks" in argv else HUMAN_BENCH_CHUNKS
    sa8_mb = float(argv[argv.index("--sa8-mb") + 1]) if "--sa8-mb" in argv \
        else None
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "bwamem_tpu_torch")) or \
            not os.path.isdir(os.path.join(root, "bwamem_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    os.environ.update(WIDTHS)
    sys.path.insert(0, os.path.abspath(root))
    EMULATE = root == HERE   # another tree's package has no emulation
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    SPLIT = hasattr(DeviceFmIndex, "split")   # a parent may predate them

    # 1. probe
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"expected capability (9, 0), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_kernels._nvcc(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    tb = time.perf_counter()
    _kernels.library()
    build_s = time.perf_counter() - tb
    ptxas = [ln.replace("ptxas info    : ", "").strip()
             for ln in _kernels.build_log().splitlines()
             if "registers" in ln or "spill" in ln
             or "Function properties for" in ln]
    say("probe", device=name, capability=list(cap), smi=smi, nvcc=nvcc,
        torch=torch.__version__, build_seconds=build_s, ptxas=ptxas,
        seconds=time.perf_counter() - t0)

    # phase 9 alone at another size (the human-scale runs)
    rec_h = {k.name: [] for k in (_kernels.SMEM, _kernels.SA,
                                  _kernels.EXTEND)}
    if human:
        human_scale(human, "--repeats" in argv, human_chunks, rec_h,
                    sa8_mb=sa8_mb)
        return 0

    # bacterial-size dataset (cached in a git-ignored directory)
    if not quick:
        t0 = time.perf_counter()
        if not os.path.exists(os.path.join(BIG, "genome.fa.sa8")):
            subprocess.run([sys.executable,
                            os.path.join(HERE, "tools", "make_biggenome.py"),
                            BIG] + BIG_ARGS, check=True,
                           stdout=subprocess.DEVNULL)
        for sub, n_se, n_pe, rl in LONG_SETS:
            dst = os.path.join(BIG, sub)
            if not os.path.exists(os.path.join(dst, "reads_se.fq")):
                os.makedirs(dst, exist_ok=True)
                subprocess.run([sys.executable, os.path.join(
                    HERE, "tools", "sample_reads.py"),
                    os.path.join(BIG, "genome.fa"), "--out", dst,
                    "--n-se", str(n_se), "--n-pe", str(n_pe),
                    "--read-len", str(rl)], check=True,
                    stdout=subprocess.DEVNULL)
        say("data", dir=BIG, long_sets=[s[0] for s in LONG_SETS],
            seconds=time.perf_counter() - t0)
    for _ in range(real_runs):
        real_size(timed_only=True)
    if real_runs:
        return 0

    # 2. kernels against their plain versions
    rec = {k.name: [] for k in _kernels.KERNELS}
    check_kernels("bundled_105kbp", os.path.join(DATA, "genome.fa"),
                  os.path.join(DATA, "reads_se.fq"), rec)
    if not quick:
        check_kernels("ecoli_len_4.64Mbp", os.path.join(BIG, "genome.fa"),
                      os.path.join(BIG, "reads_se.fq"), rec)
    if kernels_only:
        say("kernels_only", root=os.path.abspath(root), smi=smi,
            ms={k: {r.get("bucket", "-") + "@" + r["index"]:
                    {key: r[key] for key in r if key.startswith(TIME_KEYS)}
                    for r in v}
                for k, v in rec.items() if v})
        return 0

    # 3-4 on the flat route: launch counts zeroed just before, read just
    # after
    out = os.path.join(HERE, ".smoke_data")
    os.makedirs(out, exist_ok=True)
    ref = os.path.join(DATA, "genome.fa")
    _kernels.reset_counts()
    t0 = time.perf_counter()
    for tag, args, golden in GOLDENS:
        check_golden(args, os.path.join(out, f"smoke_{tag}.sam"), golden)
    say("goldens", identical=[g for _, _, g in GOLDENS],
        launches={k.name: k.launches for k in _kernels.KERNELS},
        seconds=time.perf_counter() - t0)
    defaults = {}
    if not quick:
        defaults = real_size()
        defaults.update(long_reads())
    launches = read_counts((_kernels.SMEM, _kernels.SA, _kernels.EXTEND),
                           "the flat route")
    buckets = read_buckets((_kernels.SMEM, _kernels.EXTEND),
                           () if quick else ("smem_superstep_L256",
                                             "smem_superstep_L512",
                                             "extend_lr_LQ256",
                                             "extend_lr_LQ512"),
                           "the flat route")

    # 3-4 on the two routes of the flat path chosen by environment, each
    # counted on its own: round-per-launch seeding (the iterator-step
    # kernel) and the extension rows built on the device
    for route, env, kernels in (
            ("superstep0", {"BWAMEM_TPU_SUPERSTEP": "0"},
             (_kernels.SMEM1, _kernels.SA, _kernels.EXTEND)),
            ("onchip_ext", {"BWAMEM_TPU_ONCHIP_EXT": "1"},
             (_kernels.SMEM, _kernels.SA, _kernels.BUILD,
              _kernels.EXTEND))):
        _kernels.reset_counts()
        route_goldens(route, env)
        if not quick:
            route_real_size(route, env, defaults)
        counts = read_counts(kernels, f"the {route} route")
        launches.update({k: v for k, v in counts.items()
                         if k not in launches})
        buckets.update(read_buckets(
            [k for k in kernels if k in (_kernels.SMEM1, _kernels.BUILD)],
            (), f"the {route} route"))

    # 3-4 on the routes their switches select, each counted on its own:
    # the no-native route (phase 3's goldens and trace, phase 4's cut),
    # the Python chain route with the library there, no speculation, and
    # the unfused seeding route (phase 4's 100k SE set)
    for route, env, names in SWITCH_ROUTES:
        kernels = [getattr(_kernels, n) for n in names]
        _kernels.reset_counts()
        switch_goldens(route, env)
        if not quick and route == "no_native":
            no_native_real_size(defaults)
        if not quick and route == "gcap0":
            with switched(env):
                route_real_size(route, env, defaults, ("se",))
        counts = read_counts(kernels, f"the {route} route")
        say(f"launches_{route}", launches=counts)
        launches.update({k: v for k, v in counts.items()
                         if k not in launches})

    # 3-4 on the generator wave path, counted the same way
    _kernels.reset_counts()
    t0 = time.perf_counter()
    wave_stats = {}
    for tag, args, golden in (
            ("se_v4", ["-v", "4", ref, os.path.join(DATA, "reads_se.fq")],
             "golden_se_v4.txt"),
            ("pe_v4", ["-v", "4", ref, os.path.join(DATA, "reads_1.fq"),
                       os.path.join(DATA, "reads_2.fq")], "golden_pe_v4.txt"),
            ("se1_v5", ["-v", "5", ref, os.path.join(DATA, "reads_se1.fq")],
             "golden_se1_v5.txt")):
        err = check_golden(args, os.path.join(out, f"smoke_{tag}.txt"),
                           golden)
        wave_stats[tag] = {k: v for k, v in device_stats(err).items()
                           if k.startswith(("wave_", "n_"))}
    say("trace_goldens", identical=["golden_se_v4.txt", "golden_pe_v4.txt",
                                    "golden_se1_v5.txt"],
        launches={k.name: k.launches for k in _kernels.KERNELS},
        stats=wave_stats, seconds=time.perf_counter() - t0)
    if not quick:
        trace_real_size()
        seed_rich()
    launches.update(read_counts(
        (_kernels.EXTEND2, _kernels.GLOBAL2, _kernels.ALIGN2),
        "the wave path"))

    # the microbench entry point, each kernel call held against its
    # plain version, counted like the paths above
    _kernels.reset_counts()
    microbench_sweep(os.path.join(DATA if quick else BIG, "genome.fa"), rec)
    launches.update(read_counts(
        (_kernels.GATHER, _kernels.OCC4, _kernels.CHAIN, _kernels.LOOP),
        "the microbench sweep"))

    # 6. a reads mesh and two processes, counted on their own
    mesh_real = multi_card(defaults)

    # 7. the tables split over the mesh, counted on their own
    split_tables(defaults, mesh_real, rec)

    # 8. the other commands and the entry points, each in its own process
    commands(quick)

    # 9. the human-scale regime: run3g over tables past the L2, counted
    # run by run
    if not quick:
        human_scale(HUMAN_MBP, False, human_chunks, rec_h, rec)

    kernels = kernels_line(rec, launches, buckets, rec_h)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_line(rec, launches, buckets, rec_h):
    """The kernels JSON record: one entry per kernel, from its records
    (rec), its launches on its path and its per-bucket launches, and for
    the kernels of phase 9 their record there (rec_h, `human_scale`)."""
    from bwamem_tpu_torch.ops import _kernels
    kernels = []
    for k in _kernels.KERNELS:
        # ms and plain_ms: the L=128/LQ=128 shape (or the kernel's only
        # one) on the largest index measured; the other buckets beside
        main = [r for r in rec[k.name]
                if r.get("bucket") in (None, "L128", "LQ128")][-1]
        # the kernel's own time: torch.profiler's for the kernels of
        # phase 2, CUDA-graph replay for the sweep's; the host cost is the
        # rest of the CUDA-event ms
        dev_ms = main.get("profiler_ms") or main.get("device_ms")
        extra = {}
        if k is _kernels.SA:
            extra = {key: main[key] for key in (
                "longest_walk", "chain_ns_per_step", "chain_floor_ms")}
        if k is _kernels.GATHER:
            extra = {f"ids{n}": {
                key: g.get(key) for key in ("index", "ms", "profiler_ms",
                                            "device_ms", "host_ms",
                                            "library_ms",
                                            "library_profiler_ms",
                                            "bound_ms", "rounds_ms")}
                for n in (GATHER_IDS, GATHER_IDS_BIG)
                for g in [[r for r in rec[k.name]
                           if r.get("bucket") == f"ids{n}"][-1]]}
        human = rec_h.get(k.name, [])
        if human:
            extra["human_scale"] = {key: human[-1].get(key) for key in (
                "index", "ms", "profiler_ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "max_abs_err", "chain_floor_ms",
                "sa_intv")}
        kernels.append(dict(
            name=k.name, route="cuda", source=k.source,
            replaces=k.replaces, launches=launches[k.name],
            max_abs_err=max(r["max_abs_err"] for r in rec[k.name] + human),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main.get("library_ms"), index=main["index"],
            device_ms=dev_ms,
            device_ms_by="profiler" if main.get("profiler_ms")
            else "cuda_graph",
            host_ms=None if dev_ms is None else main["ms"] - dev_ms,
            bucket_launches={b: n for b, n in buckets.items()
                             if b.startswith(k.name + "_")},
            bucket_ms={r["bucket"]: [r["ms"], r["plain_ms"],
                                     r.get("profiler_ms")
                                     or r.get("device_ms")]
                       for r in rec[k.name]
                       if "bucket" in r and r["index"] == main["index"]},
            bucket_bound_ms={r["bucket"]: r["bound_ms"]
                             for r in rec[k.name]
                             if "bucket" in r and "bound_ms" in r
                             and r["index"] == main["index"]},
            # the split tables (phase 2 on the largest index, phase 7's
            # 4 GiB occ4): each split time beside the whole table's
            split={r["bucket"]: {key: r.get(key) for key in (
                "index", "ms", "device_ms", "whole_ms", "whole_device_ms",
                "lookup_cost_ms", "max_abs_err")}
                for r in rec[k.name] if "split" in r},
            # align2's i16 pass and the bounds over the cells run, the
            # wrappers' device scratch
            **extra,
            **{key: v for key, v in main.items()
               if key.startswith(("ms_", "plain_ms_", "bound_ms_",
                                  "bound_run_ms_", "device_scratch",
                                  "profiler_ms", "device_ms_",
                                  "host_ms_"))}))
    return kernels


def check_golden(args, path, golden, env=None):
    """`mem` on tests/data against a golden file; returns its stderr."""
    err, _ = run_mem(args, path, env)
    if sam_body(path) != sam_body(os.path.join(DATA, golden)):
        raise RuntimeError(f"golden {golden}: output differs ({path})")
    return err


def read_counts(kernels, path):
    """The launch counts of a path's kernels; each must be > 0."""
    counts = {k.name: k.launches for k in kernels}
    if min(counts.values()) == 0:
        raise RuntimeError(f"a kernel of {path} did not launch: {counts}")
    return counts


def read_cards(kernels, mesh, path):
    """Each kernel's launches per card, as Kernel.launch counted them
    where it launched: they must add up to its launches, and every card
    of the mesh must show some."""
    out = {}
    for k in kernels:
        cards = dict(k.by_card)
        if sum(cards.values()) != k.launches:
            raise RuntimeError(f"{path}: {k.name}'s launches per card "
                               f"{cards} do not add up to {k.launches}")
        idle = {d.index for d in mesh} - {c for c, n in cards.items() if n}
        if idle:
            raise RuntimeError(f"{path}: {k.name} did not launch on cards "
                               f"{sorted(idle)}")
        out[k.name] = {f"cuda:{c}": n for c, n in sorted(cards.items())}
    return out


def read_buckets(kernels, required, path):
    """The per-bucket launch counts of a path's kernels; each bucket in
    `required` must be > 0."""
    counts = {}
    for k in kernels:
        counts.update(k.buckets)
    missing = [b for b in required if not counts.get(b)]
    if missing:
        raise RuntimeError(f"{path} did not launch {missing}: {counts}")
    return counts


def real_size(timed_only=False):
    """100k SE reads and 20k pairs: timed, again with every extension
    verified, and the diff subsets against the host engine.  Returns the
    runs the routes are held to (with timed_only, the timed runs only:
    `mem` in this process, index load and engine build included)."""
    idx = os.path.join(BIG, "genome.fa")
    se = os.path.join(BIG, "reads_se.fq")
    r1 = os.path.join(BIG, "reads_1.fq")
    r2 = os.path.join(BIG, "reads_2.fq")
    defaults = {}     # the runs the routes are held to: args, SAM, reads
    for tag, args, n_reads in (("se", [idx, se], 100000),
                               ("pe", [idx, r1, r2], 40000)):
        path = os.path.join(BIG, f"port_{tag}.sam")
        err, dt = run_mem(args, path)
        say(f"real_{tag}", reads=n_reads, seconds=dt,
            reads_per_s=n_reads / dt, stats=device_stats(err))
        REAL_RPS[tag] = n_reads / dt
        if timed_only:
            continue
        # again with every extension checked against the scalar twin
        vpath = os.path.join(BIG, f"port_{tag}_verify.sam")
        err, dt = run_mem(args, vpath, env={"BWAMEM_TPU_VERIFY": "1"})
        n_ok = sum("[M::verify] extension wave verified" in ln
                   for ln in err.splitlines())
        bad = [ln for ln in err.splitlines() if ln.startswith("[E::verify]")]
        if bad or not n_ok:
            raise RuntimeError(f"verify {tag}: {bad or 'no verify line'}")
        if sam_body(vpath) != sam_body(path):
            raise RuntimeError(f"verify {tag}: output differs from the "
                               f"timed run")
        say(f"verify_{tag}", reads=n_reads, seconds=dt,
            verified_chunks=n_ok)
        defaults[tag] = (args, path, n_reads)
    if timed_only:
        return defaults
    # diff subsets against the host engine of the JAX package's CLI
    t0 = time.perf_counter()
    subs = []
    for src, n in ((se, N_DIFF_SE), (r1, N_DIFF_PE), (r2, N_DIFF_PE)):
        dst = os.path.join(BIG, "sub_" + os.path.basename(src))
        with open(src) as f, open(dst, "w") as g:
            for i, ln in enumerate(f):
                if i >= 4 * n:
                    break
                g.write(ln)
        subs.append(dst)
    for tag, files in (("se", subs[:1]), ("pe", subs[1:])):
        mine = os.path.join(BIG, f"diff_port_{tag}.sam")
        host = os.path.join(BIG, f"diff_host_{tag}.sam")
        run_mem([idx] + files, mine)
        with open(host, "w") as f:
            subprocess.run([sys.executable, "-m", "bwamem_tpu.cli", "mem",
                            "--engine", "host", idx] + files, stdout=f,
                           stderr=subprocess.DEVNULL, check=True, cwd=HERE)
        a, b = sam_body(mine), sam_body(host)
        if a != b:
            raise RuntimeError(f"diff {tag}: port and host engine differ "
                               f"({mine} vs {host})")
        say(f"diff_{tag}", records=len(a) - 1, identical=True,
            seconds=time.perf_counter() - t0)
    return defaults


def long_reads():
    """The long-read runs: each timed, served on the device
    (host_routed_reads 0, its chunk in the L=256 or L=512 seeding
    bucket), its first N_DIFF_LONG reads byte-identical to
    ``bwamem_tpu.cli mem --engine host``.  Returns the runs the routes
    are held to."""
    idx = os.path.join(BIG, "genome.fa")
    defaults = {}
    for tag, sub, files, n_reads, bucket in LONG_RUNS:
        paths = [os.path.join(BIG, sub, f) for f in files]
        path = os.path.join(BIG, sub, f"port_{tag}.sam")
        err, dt = run_mem([idx] + paths, path)
        stats = device_stats(err)
        if stats.get("host_routed_reads", 0) or not stats.get(bucket):
            raise RuntimeError(f"long reads {tag}: not served in {bucket} "
                               f"on the device: {stats}")
        n = N_DIFF_LONG // len(paths)
        subs = [head_fastq(p, os.path.join(BIG, sub, f"sub_{tag}_{m}.fq"), n)
                for m, p in enumerate(paths)]
        mine = os.path.join(BIG, sub, f"diff_port_{tag}.sam")
        host = os.path.join(BIG, sub, f"diff_host_{tag}.sam")
        _, dt_sub = run_mem([idx] + subs, mine)
        t1 = time.perf_counter()
        host_mem([idx] + subs, host)
        dt_host = time.perf_counter() - t1
        if sam_body(mine) != sam_body(host):
            raise RuntimeError(f"long reads {tag}: port and host engine "
                               f"differ ({mine} vs {host})")
        say(f"long_{tag}", reads=n_reads, seconds=dt,
            reads_per_s=n_reads / dt, stats=stats, diffed_reads=n * len(paths),
            identical=True, diff_seconds=dt_sub, host_seconds=dt_host)
        defaults[tag] = ([idx] + paths, path, n_reads)
    return defaults


def route_goldens(route, env):
    """The SE and PE goldens through a route of the flat path."""
    t0 = time.perf_counter()
    out = os.path.join(HERE, ".smoke_data")
    stats = {}
    for tag, args, golden in GOLDENS:
        if tag == "se_aM":
            continue
        err = check_golden(args, os.path.join(out, f"smoke_{route}_{tag}.sam"),
                           golden, env)
        stats[tag] = device_stats(err)
    say(f"goldens_{route}", identical=["golden_se.sam", "golden_pe.sam"],
        stats=stats, seconds=time.perf_counter() - t0)


def route_real_size(route, env, defaults, tags=("se", "pe150")):
    """The 100k SE 101 bp run and the 2x150 bp run (or `tags`) through a
    route, timed, each byte-identical to the default route's SAM."""
    for tag in tags:
        args, want, n_reads = defaults[tag]
        path = os.path.join(BIG, f"{route}_{tag}.sam")
        err, dt = run_mem(args, path, env)
        if sam_body(path) != sam_body(want):
            raise RuntimeError(f"{route} {tag}: output differs from the "
                               f"default route ({path} vs {want})")
        say(f"{route}_{tag}", reads=n_reads, seconds=dt,
            reads_per_s=n_reads / dt, identical_to_default=True,
            default_reads_per_s=REAL_RPS.get(tag), stats=device_stats(err))


# the routes their switches select (the engine's module constants,
# read at import, are set with their variables): the Python route
# without the native library, the same with the library there, no
# speculation, and the unfused seeding route; what each must launch
SWITCH_ROUTES = (
    ("no_native", {"BWAMEM_TPU_NATIVE_FINALIZE": "0"}, ("SMEM", "SA",
                                                        "EXTEND")),
    ("native_regions0", {"BWAMEM_TPU_NATIVE_REGIONS": "0"},
     ("SMEM", "SA", "EXTEND")),
    ("speculate0", {"BWAMEM_TPU_SPECULATE": "0"}, ("SMEM", "SA", "EXTEND")),
    ("gcap0", {"BWAMEM_TPU_GCAP_PER_LANE": "0"}, ("SMEM", "SA", "EXTEND")),
    ("fuse_sa0", {"BWAMEM_TPU_FUSE_SA": "0"}, ("SMEM", "SA", "EXTEND")))
N_NONATIVE_SE, N_NONATIVE_PE = 10000, 2000   # the no-native route's cut


@contextlib.contextmanager
def switched(env):
    """The engine's module constants that env's switches set (where the
    package has them: a parent tree may not)."""
    from bwamem_tpu_torch.ops import engine
    saved = {}
    try:
        for key, val in env.items():
            name = key[len("BWAMEM_TPU_"):]
            if hasattr(engine, name) and name in ("NATIVE_REGIONS",
                                                  "SPECULATE"):
                saved[name] = getattr(engine, name)
                setattr(engine, name, val != "0")
        yield
    finally:
        for name, val in saved.items():
            setattr(engine, name, val)


def switch_goldens(route, env):
    """The goldens through a switch's route: the SE, SE -a -M and PE
    goldens and the -v 4 SE trace without the native library, the SE
    golden through the others."""
    t0 = time.perf_counter()
    out = os.path.join(HERE, ".smoke_data")
    runs = [g for g in GOLDENS if route == "no_native" or g[0] == "se"]
    if route == "no_native":
        runs.append(("se_v4", ["-v", "4", os.path.join(DATA, "genome.fa"),
                               os.path.join(DATA, "reads_se.fq")],
                     "golden_se_v4.txt"))
    stats = {}
    with switched(env):
        for tag, args, golden in runs:
            err = check_golden(args, os.path.join(
                out, f"smoke_{route}_{tag}.out"), golden, env)
            stats[tag] = device_stats(err)
    say(f"goldens_{route}", identical=[g for _, _, g in runs], stats=stats,
        seconds=time.perf_counter() - t0)


def first_records(path, n_reads):
    """The SAM records of a file's first n_reads reads."""
    out, names = [], set()
    for ln in records(path):
        if not ln:
            continue
        name = ln.split("\t", 1)[0]
        if name not in names:
            if len(names) == n_reads:
                break
            names.add(name)
        out.append(ln)
    return out


def no_native_real_size(defaults):
    """The no-native route on a cut of the 4.64 Mbp set (the first
    N_NONATIVE_SE SE reads and N_NONATIVE_PE pairs), timed beside the
    default route on the same files: equal SAM, and on the SE cut equal
    to phase 4's 100k SE SAM's records of those reads."""
    env = dict(SWITCH_ROUTES[0][1])
    for tag, files, n in (("se", ["reads_se.fq"], N_NONATIVE_SE),
                          ("pe", ["reads_1.fq", "reads_2.fq"],
                           N_NONATIVE_PE)):
        cut = [head_fastq(os.path.join(BIG, f), os.path.join(
            BIG, f"cut_{n}_{f}"), n) for f in files]
        args = [os.path.join(BIG, "genome.fa")] + cut
        want = os.path.join(BIG, f"cut_default_{tag}.sam")
        _, dt_default = run_mem(args, want)
        path = os.path.join(BIG, f"no_native_{tag}.sam")
        with switched(env):
            err, dt = run_mem(args, path, env)
        if sam_body(path) != sam_body(want):
            raise RuntimeError(f"no_native {tag}: output differs from the "
                               f"default route ({path} vs {want})")
        if tag == "se" and first_records(path, n) != first_records(
                defaults["se"][1], n):
            raise RuntimeError("no_native se: output differs from phase "
                               "4's SAM of those reads")
        n_reads = n * len(files)
        say(f"no_native_{tag}", reads=n_reads, seconds=dt,
            reads_per_s=n_reads / dt, default_seconds=dt_default,
            default_reads_per_s=n_reads / dt_default,
            identical_to_default=True, stats=device_stats(err))


def records(path):
    """SAM records: the lines that are not trace lines or headers."""
    return [ln for ln in sam_body(path)
            if not ln.startswith(("*", "=====>", "@"))]


def trace_real_size():
    """-v 4 on 5,000 pairs: the SAM records equal a -v 3 run of the same
    files (insert-size statistics are per chunk, so the same files), and
    on the first 500 pairs the whole output equals the host engine's."""
    idx = os.path.join(BIG, "genome.fa")
    for n_pairs in (N_TRACE_PE, N_TRACE_HOST_PE):
        files = [head_fastq(os.path.join(BIG, f"reads_{m}.fq"),
                            os.path.join(BIG, f"v4_{n_pairs}_{m}.fq"),
                            n_pairs) for m in (1, 2)]
        v4 = os.path.join(BIG, f"port_v4_{n_pairs}.txt")
        err, dt = run_mem(["-v", "4", idx] + files, v4)
        if n_pairs == N_TRACE_PE:
            v3 = os.path.join(BIG, f"port_v3_{n_pairs}.sam")
            _, dt3 = run_mem([idx] + files, v3)
            a, b = records(v4), records(v3)
            if a != b or len(a) < 2 * n_pairs:
                raise RuntimeError(f"-v 4 records differ from -v 3 ({v4} "
                                   f"vs {v3})")
            say("trace_pe", pairs=n_pairs, seconds=dt,
                reads_per_s=2 * n_pairs / dt, v3_seconds=dt3,
                records=len(a), trace_lines=len(sam_body(v4)) - len(a),
                stats=device_stats(err))
        else:
            t0 = time.perf_counter()
            host = os.path.join(BIG, f"host_v4_{n_pairs}.txt")
            host_mem(["-v", "4", idx] + files, host)
            if sam_body(v4) != sam_body(host):
                raise RuntimeError(f"-v 4 differs from the host engine "
                                   f"({v4} vs {host})")
            say("trace_pe_vs_host", pairs=n_pairs, identical=True,
                lines=len(sam_body(v4)), seconds=dt,
                host_seconds=time.perf_counter() - t0)


def seed_rich():
    """Seed-rich chunks: SE and PE reads of a 16 Mbp repeat genome
    through the generator path, byte-identical to the host engine."""
    t0 = time.perf_counter()
    fa = os.path.join(REP, "genome.fa")
    if not os.path.exists(os.path.join(REP, "reads_2.fq")):
        for cmd in (["tools/make_gbp_fasta.py", REP, "--mbp", "16",
                     "--repeats"],
                    ["-m", "bwamem_tpu_torch.cli", "index", fa],
                    ["tools/sample_reads.py", fa] + REP_READS):
            subprocess.run([sys.executable] + cmd, check=True, cwd=HERE,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    say("repeat_data", dir=REP, seconds=time.perf_counter() - t0)
    for tag, files, n_reads in (
            ("se", ["reads_se.fq"], 2000),
            ("pe", ["reads_1.fq", "reads_2.fq"], 2000)):
        args = [fa] + [os.path.join(REP, f) for f in files]
        mine = os.path.join(REP, f"port_{tag}.sam")
        err, dt = run_mem(args, mine)
        stats = device_stats(err)
        t1 = time.perf_counter()
        host = os.path.join(REP, f"host_{tag}.sam")
        host_mem(args, host)
        if sam_body(mine) != sam_body(host):
            raise RuntimeError(f"seed-rich {tag}: port and host engine "
                               f"differ ({mine} vs {host})")
        if not stats.get("seed_rich_chunks") or not stats.get("wave_rounds"):
            raise RuntimeError(f"seed-rich {tag}: the wave path was not "
                               f"taken: {stats}")
        say(f"seed_rich_{tag}", reads=n_reads, seconds=dt,
            reads_per_s=n_reads / dt, identical=True,
            records=len(sam_body(mine)), host_seconds=time.perf_counter()
            - t1, stats=stats)


# the __global__ function of each kernel, as a profiler trace names it
SYMBOLS = {"smem_superstep": "superstep_kernel", "sa_walk": "sa_walk_kernel",
           "extend_lr": "extend_lr_kernel", "extend2": "extend2_kernel",
           "global2": "global_kernel", "align2": "align_kernel",
           "smem1_step": "iter_step_kernel", "build_rows": "build_rows_kernel"}
DIST_CHUNK_BP = {"golden": "20000", "se100k": "1000000"}


def engine_mem(engine, fm, bns, files, out_path, flags=(), verbose=3):
    """`mem` through an engine built here (a mesh the CLI cannot name,
    such as two shards on one card), driven by
    core.pipeline.process_chunk_stream as bench.py drives an engine: the
    CLI's defaults, chunks of opt.chunk_size bases, `flags` among -a and
    -M; the header and the records (and at verbose 4 the traces) into
    out_path.  Returns the seconds."""
    from bwamem_tpu_torch.config import (MEM_F_ALL, MEM_F_NO_MULTI,
                                         MEM_F_PE, MemOptions, fill_scmat)
    from bwamem_tpu_torch.core.pipeline import process_chunk_stream
    from bwamem_tpu_torch.core.sam import sam_header
    from bwamem_tpu_torch.io.native import make_chunk_reader
    opt = MemOptions()
    for f in flags:
        opt.flag |= {"-a": MEM_F_ALL, "-M": MEM_F_NO_MULTI}[f]
    if len(files) > 1:
        opt.flag |= MEM_F_PE
    opt.rescale_for_a()
    opt.mat = fill_scmat(opt.a, opt.b)
    reader = make_chunk_reader(files[0], files[1] if len(files) > 1 else None)

    def chunks():
        while True:
            reads = reader.read_chunk(opt.chunk_size * opt.n_threads)
            if not reads:
                return
            for r in reads:
                r.comment = None
            yield reads
    so, se = sys.stdout, sys.stderr
    t0 = time.perf_counter()
    with open(out_path, "w") as f:
        sys.stdout, sys.stderr = f, io.StringIO()
        try:
            f.write(sam_header(bns, None, "@PG\tID:bwa\tPN:bwa"))
            process_chunk_stream(opt, fm, bns, bns.pac, chunks(), None, "",
                                 engine, verbose,
                                 emit=lambda rs: f.writelines(r.sam
                                                              for r in rs))
        finally:
            sys.stdout, sys.stderr = so, se
    return time.perf_counter() - t0


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_procs(arg_lists, out_paths, env):
    """`python -m bwamem_tpu_torch.cli mem --device DEVICE` once per
    argument list, all at once, stdout to its path; (stderr texts,
    seconds until the last ended).  Any non-zero exit fails; every
    process is ended on a timeout."""
    t0 = time.perf_counter()
    procs = []
    try:
        for args, path in zip(arg_lists, out_paths):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "bwamem_tpu_torch.cli", "mem",
                     "--device", DEVICE] + args, stdout=f,
                    stderr=subprocess.PIPE, cwd=HERE, text=True,
                    env=dict(os.environ, **env)))
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.perf_counter() - t0
    for p, err in zip(procs, errs):
        if p.returncode:
            raise RuntimeError(f"mem {p.args} exited {p.returncode}:\n"
                               f"{err[-3000:]}")
    return errs, dt


def read_names(lines):
    """The sorted read names of SAM lines (headers and blanks left out)."""
    return sorted(ln.split("\t")[0] for ln in lines
                  if ln and not ln.startswith("@"))


def distributed_pairs(sets, names_of):
    """Two `--distributed` processes for each (tag, mem args, chunk) set, all
    pairs at once: rank i on card i mod the cards, --shard i/2 by
    default.  Each rank's records must equal its `--shard i/2` twin (run
    here, in this process, at the same chunk size) and the pair's read
    names those of names_of[tag].  Returns the pairs' wall seconds."""
    out = os.path.join(HERE, ".smoke_data")
    args, paths = [], []
    for tag, mem_args, _ in sets:
        port = free_port()
        for i in range(2):
            args.append(["--distributed", f"127.0.0.1:{port},2,{i}"]
                        + mem_args)
            paths.append(os.path.join(out, f"dist_{tag}_{i}.sam"))
    chunk = {s[2] for s in sets}
    if len(chunk) != 1:
        raise ValueError("one chunk size per call")
    env = {"BWAMEM_TPU_CHUNK_BP": chunk.pop()}
    errs, dt = cli_procs(args, paths, env)
    for k, (tag, mem_args, _) in enumerate(sets):
        body = []
        for i in range(2):
            if f"distributed: process {i} of 2 on {DEVICE}" \
                    not in errs[2 * k + i]:
                raise RuntimeError(f"distributed {tag}: rank {i} said "
                                   f"nothing of its card")
            recs = [ln for ln in sam_body(paths[2 * k + i])
                    if not ln.startswith("@")]
            twin = os.path.join(out, f"twin_{tag}_{i}.sam")
            run_mem(["--shard", f"{i}/2"] + mem_args, twin, env)
            if recs != [ln for ln in sam_body(twin)
                        if not ln.startswith("@")]:
                raise RuntimeError(f"distributed {tag}: rank {i} differs "
                                   f"from its --shard {i}/2 twin")
            body += recs
        if read_names(body) != names_of[tag]:
            raise RuntimeError(f"distributed {tag}: the pair's read names "
                               f"are not the single run's")
    return dt


def multi_card(defaults):
    """Phase 6: the engine over a reads mesh (every card when there are
    two or more, else two shards on card 0) through process_chunk_stream
    on the goldens, the -v 4 trace, and, unless --quick, the 100k SE and
    20k PE sets against phase 4's single-card SAM; `mem --mesh auto`;
    pairs of `--distributed` processes; `--profile`.  Launch counts are
    zeroed before the mesh runs and read after them."""
    import torch
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    from bwamem_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    out = os.path.join(HERE, ".smoke_data")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        mesh, ran = make_mesh(), f"{n_cards} cards"
    else:
        one = torch.device(DEVICE, 0 if DEVICE == "cuda" else None)
        mesh, ran = (one,) * 2, "2 shards on one card"
    ref = os.path.join(DATA, "genome.fa")
    se = os.path.join(DATA, "reads_se.fq")
    _kernels.reset_counts()
    fm, bns = load_index(ref)
    eng = TorchSeedingEngine(fm, mesh[0], mesh=mesh)
    identical = []
    for tag, args, golden in GOLDENS + (
            ("se_v4", ["-v", "4", ref, se], "golden_se_v4.txt"),):
        path = os.path.join(out, f"mesh_{tag}.sam")
        engine_mem(eng, fm, bns, [a for a in args if a.endswith(".fq")],
                   path, [a for a in args if a in ("-a", "-M")],
                   4 if "-v" in args else 3)
        if sam_body(path) != sam_body(os.path.join(DATA, golden)):
            raise RuntimeError(f"mesh {tag}: differs from {golden} ({path})")
        identical.append(golden)
    real = {}
    if defaults:
        bfm, bbns = load_index(os.path.join(BIG, "genome.fa"))
        beng = TorchSeedingEngine(bfm, mesh[0], mesh=mesh)
        for tag in ("se", "pe"):
            args, want, n_reads = defaults[tag]
            path = os.path.join(BIG, f"mesh_{tag}.sam")
            dt = engine_mem(beng, bfm, bbns, args[1:], path)
            if sam_body(path) != sam_body(want):
                raise RuntimeError(f"mesh {tag}: differs from the single-card "
                                   f"run ({path} vs {want})")
            real[tag] = {"reads": n_reads, "seconds": dt,
                         "reads_per_s": n_reads / dt, "ran_on": ran}
    sharded = (_kernels.SMEM, _kernels.SA, _kernels.EXTEND, _kernels.EXTEND2,
               _kernels.GLOBAL2)
    launches = read_counts(sharded, "the reads mesh")
    by_card = read_cards(sharded, mesh, "the reads mesh")
    say("multi_card_mesh", ran_on=ran, shards=[str(d) for d in mesh],
        identical=identical, real_size=real, launches=launches,
        launches_by_card=by_card, seconds=time.perf_counter() - t0)

    # the CLI's own --mesh auto (every card; one card: no mesh)
    t1 = time.perf_counter()
    path = os.path.join(out, "mesh_auto_se.sam")
    err, dt = run_mem(["--mesh", "auto", ref, se], path)
    if sam_body(path) != sam_body(os.path.join(DATA, "golden_se.sam")):
        raise RuntimeError("--mesh auto: differs from golden_se.sam")
    mesh_line = [ln for ln in err.splitlines() if "reads mesh over" in ln]

    # pairs of --distributed processes: the goldens, then the 100k SE set
    golden_names = {tag: read_names(sam_body(os.path.join(DATA, g)))
                    for tag, _, g in GOLDENS}
    dist_golden_s = distributed_pairs(
        [(tag, args, DIST_CHUNK_BP["golden"]) for tag, args, _ in GOLDENS],
        golden_names)
    dist = {"goldens_identical_to_twins": [g for _, _, g in GOLDENS],
            "golden_pairs_seconds": dist_golden_s}
    if defaults:
        args, _, n_reads = defaults["se"]
        env = {"BWAMEM_TPU_CHUNK_BP": DIST_CHUNK_BP["se100k"]}
        single = os.path.join(BIG, "single_se100k.sam")
        _, single_s = cli_procs([args], [single], env)
        pair_s = distributed_pairs(
            [("se100k", args, DIST_CHUNK_BP["se100k"])],
            {"se100k": read_names(sam_body(single))})
        dist.update(se100k_reads=n_reads, chunk_bp=int(
            DIST_CHUNK_BP["se100k"]), pair_seconds=pair_s,
            single_seconds=single_s, pair_reads_per_s=n_reads / pair_s,
            single_reads_per_s=n_reads / single_s,
            ran_on=("2 processes on 2 cards" if n_cards >= 2
                    else "2 processes on one card"))

    # --profile in a fresh process: the SAM and a trace naming the run's
    # kernels
    pdir = os.path.join(out, "profile_se")
    if os.path.isdir(pdir):
        for f in os.listdir(pdir):
            os.remove(os.path.join(pdir, f))
    ppath = os.path.join(out, "profile_se.sam")
    perr, prof_s = cli_procs([["--profile", pdir, ref, se]], [ppath], {})
    if sam_body(ppath) != sam_body(os.path.join(DATA, "golden_se.sam")):
        raise RuntimeError("--profile: differs from golden_se.sam")
    traces = [f for f in os.listdir(pdir) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise RuntimeError(f"--profile: expected one trace, got {traces}")
    with open(os.path.join(pdir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    seen = {}
    for e in events:
        if e.get("cat") == "kernel":
            for k, sym in SYMBOLS.items():
                if sym in e.get("name", ""):
                    seen[k] = seen.get(k, 0) + 1
    need = ("smem_superstep", "sa_walk", "extend_lr")
    if not all(seen.get(k) for k in need):
        raise RuntimeError(f"--profile: the trace names {seen}, not every "
                           f"kernel of {need}")
    say("multi_card_cli", mesh_auto_identical=True,
        mesh_auto_line=mesh_line[0] if mesh_line else None,
        distributed=dist, profile={"identical": True, "trace": traces[0],
                                   "kernel_events": seen,
                                   "seconds": prof_s},
        seconds=time.perf_counter() - t1)
    return real


def split_occ4_4gib(dev, rec):
    """occ4 at OCC4_KEYS keys on the microbench's 4 GiB random table of
    64-byte rows (microbench.make_table; a 3.1 Gbp index's occ table is
    ~3.1 GB), whole and split into 4 parts of 1 GiB on the card, through
    microbench.Bench.gather: equal outputs, each held against its plain
    version, both timed in this call."""
    import torch
    from bwamem_tpu_torch import microbench
    from bwamem_tpu_torch.ops import occ as toc
    from bwamem_tpu_torch.ops.fm import SplitTable
    b = microbench.Bench(dev, seed=4, reps=20, emit=lambda ln: None)
    rows = OCC4_TABLE_BYTES // 64
    table = microbench.make_table(rows, 16, b.gen(rows * 16), dev)
    split = SplitTable.cut(table, [dev] * 4)
    outs, lines = {}, {}

    def check(kernel, line, out, args, library=None):
        if kernel != "occ4":     # the whole table's gathers run too
            return
        p_ms, po = cuda_ms(lambda: toc.occ4_plain(*args), 1, False)
        err = max_err([(out, po)])
        if err:
            raise RuntimeError(f"occ4 on the 4 GiB table differs from its "
                               f"plain version ({err})")
        tag = "split4" if isinstance(args[0], SplitTable) else "whole"
        outs[tag], lines[tag] = out, dict(line, plain_ms=p_ms)
        outs["keys"], outs["primary"] = args[2], args[1]
    b.check = check
    for tag, t in (("whole", table), ("split4", split), ("whole", table)):
        b.gather(t, [OCC4_KEYS], f"random_4GiB_{tag}")
    err = max_err([(outs["split4"], outs["whole"])])
    if err:
        raise RuntimeError(f"occ4 on the 4 GiB table: 4 parts differ from "
                           f"the whole table ({err})")
    s, w = lines["split4"], lines["whole"]
    keys = outs["keys"]
    kk = keys - (keys >= outs["primary"]).long()
    rows = int(torch.unique(kk[keys >= 0] >> 7).numel())
    r = dict(index="random_4GiB", bucket="random_4GiB_split4", split=4,
             ms=s["ms"], device_ms=s["device_ms"], plain_ms=s["plain_ms"],
             whole_ms=w["ms"], whole_device_ms=w["device_ms"],
             lookup_cost_ms=s["device_ms"] - w["device_ms"],
             max_abs_err=err, parts=s["parts"],
             **bound(nbytes((keys, outs["whole"])) + OCC_ROW_BYTES * rows,
                     OPS_PER_OCC_ROW * OCC4_KEYS))
    rec["occ4"].append(r)
    del table, split
    torch.cuda.empty_cache()
    return r


def split_tables(defaults, mesh_real, rec):
    """Phase 7: `mem --shard-tables`, the engine over a reads mesh with
    its occ table and sampled SA split by rows over the shards (every
    card when there are two or more, one part each; else two parts on
    card 0): the SE, SE -a -M and PE goldens and the -v 4 SE trace
    byte-identical, BWAMEM_TPU_SUPERSTEP=0 on the SE golden, and, unless
    --quick, the 100k SE and 20k PE sets equal to phase 4's single-card
    SAM, timed beside phase 4's and phase 6's reads/s; each kernel's
    launches per card; with two or more cards, each card's device memory
    after the engine is built (about 1/n of the tables each).  Then occ4
    on the 4 GiB table split in 4 parts (split_occ4_4gib).  Launch
    counts are zeroed before the split runs and read after them."""
    import torch
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    from bwamem_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    out = os.path.join(HERE, ".smoke_data")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        mesh, ran = make_mesh(), f"{n_cards} cards, a part on each"
    else:
        one = torch.device(DEVICE, 0 if DEVICE == "cuda" else None)
        mesh, ran = (one,) * 2, "2 parts on one card"
    ref = os.path.join(DATA, "genome.fa")
    se = os.path.join(DATA, "reads_se.fq")
    _kernels.reset_counts()

    def engine(fm):
        """The split engine, and each card's device memory it added."""
        torch.cuda.synchronize()
        before = [torch.cuda.memory_allocated(i) for i in range(n_cards)]
        eng = TorchSeedingEngine(fm, mesh[0], mesh=mesh, shard_tables=True)
        torch.cuda.synchronize()
        added = [torch.cuda.memory_allocated(i) - before[i]
                 for i in range(n_cards)]
        d = eng.dfm
        if not eng.shard_tables or len(d.blocks.parts) != len(mesh) or [
                p.device for p in d.blocks.parts] != list(mesh):
            raise RuntimeError("split tables: the engine did not split its "
                               "tables one part per shard")
        tables = sum(p.numel() * p.element_size()
                     for t in (d.blocks, d.sa) for p in t.parts)
        if n_cards >= 2 and max(added) > 1.25 * tables / len(mesh) \
                + (1 << 20):
            raise RuntimeError(f"split tables: a card holds more than its "
                               f"share of the {tables} table bytes: "
                               f"{added}")
        return eng, {"table_bytes": tables, "added_by_card": {
            f"cuda:{i}": a for i, a in enumerate(added)}}

    fm, bns = load_index(ref)
    eng, mem_small = engine(fm)
    identical = []
    for tag, args, golden in GOLDENS + (
            ("se_v4", ["-v", "4", ref, se], "golden_se_v4.txt"),
            ("se_superstep0", [ref, se], "golden_se.sam")):
        path = os.path.join(out, f"split_{tag}.sam")
        prev = os.environ.get("BWAMEM_TPU_SUPERSTEP")
        os.environ["BWAMEM_TPU_SUPERSTEP"] = \
            "0" if tag.endswith("superstep0") else "1"
        try:
            engine_mem(eng, fm, bns, [a for a in args if a.endswith(".fq")],
                       path, [a for a in args if a in ("-a", "-M")],
                       4 if "-v" in args else 3)
        finally:
            if prev is None:
                os.environ.pop("BWAMEM_TPU_SUPERSTEP")
            else:
                os.environ["BWAMEM_TPU_SUPERSTEP"] = prev
        if sam_body(path) != sam_body(os.path.join(DATA, golden)):
            raise RuntimeError(f"split {tag}: differs from {golden} "
                               f"({path})")
        identical.append(f"{tag}: {golden}")
    del eng
    real, mem_big = {}, None
    if defaults:
        bfm, bbns = load_index(os.path.join(BIG, "genome.fa"))
        beng, mem_big = engine(bfm)
        for tag in ("se", "pe"):
            args, want, n_reads = defaults[tag]
            path = os.path.join(BIG, f"split_{tag}.sam")
            dt = engine_mem(beng, bfm, bbns, args[1:], path)
            if sam_body(path) != sam_body(want):
                raise RuntimeError(f"split {tag}: differs from the "
                                   f"single-card run ({path} vs {want})")
            real[tag] = {"reads": n_reads, "seconds": dt,
                         "reads_per_s": n_reads / dt,
                         "phase4_single_card_reads_per_s": REAL_RPS.get(tag),
                         "phase6_mesh_reads_per_s":
                         mesh_real.get(tag, {}).get("reads_per_s")}
        del beng
    split = (_kernels.SMEM, _kernels.SA, _kernels.EXTEND, _kernels.EXTEND2,
             _kernels.GLOBAL2, _kernels.SMEM1)
    launches = read_counts(split, "the split tables")
    by_card = read_cards(split[:5], mesh, "the split tables")
    torch.cuda.empty_cache()
    occ4 = split_occ4_4gib(mesh[0], rec)
    say("split_tables", ran_on=ran, shards=[str(d) for d in mesh],
        identical=identical, real_size=real, launches=launches,
        launches_by_card=by_card, memory={"bundled": mem_small,
                                          "ecoli_len": mem_big},
        occ4_4gib=occ4, seconds=time.perf_counter() - t0)


# phase 8: the port's other commands and entry points, each in a process
# of its own (what a user runs); the JAX package's CLI, where it is the
# reference, too
PORT_CLI = "bwamem_tpu_torch.cli"
JAX_CLI = "bwamem_tpu.cli"
INDEX_EXTS = (".bwt", ".pac", ".ann", ".amb", ".sa")
N_ALN_BIG = 1000     # reads of phase 4's SE set through aln + samse
BENCH_CHUNKS = "2"   # BWAMEM_TPU_BENCH_CHUNKS for the bench at 4.64 Mbp


def command_env():
    """The environment of a command as a user starts it: without the
    launch widths this script sets for its own phases."""
    return {k: v for k, v in os.environ.items() if k not in WIDTHS}


def run_module(module, args, out_path, env=None, code=None):
    """`python -m module args` (or `python -c code`) in a fresh process,
    stdout to out_path; (stderr, seconds).  A non-zero exit fails."""
    cmd = [sys.executable] + (["-c", code] if code else ["-m", module]) \
        + ([] if code else args)
    t0 = time.perf_counter()
    with open(out_path, "wb") as f:
        res = subprocess.run(cmd, stdout=f, stderr=subprocess.PIPE,
                             cwd=HERE, env=env or command_env(), timeout=600)
    dt = time.perf_counter() - t0
    err = res.stderr.decode(errors="replace")
    if res.returncode:
        raise RuntimeError(f"{cmd[2:]} exited {res.returncode}:\n"
                           f"{err[-3000:]}")
    return err, dt


def run_jobs(jobs):
    """Jobs of host commands, all at once (the commands of one job in
    order): {name: (module, args, out_path) list}.  Returns {name:
    seconds}, each job's wall time among the others."""
    from concurrent.futures import ThreadPoolExecutor

    def one(steps):
        t0 = time.perf_counter()
        for module, args, out in steps:
            run_module(module, args, out)
        return time.perf_counter() - t0
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        futs = {name: ex.submit(one, steps) for name, steps in jobs.items()}
        return {name: f.result() for name, f in futs.items()}


def same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def check_same(pairs, what):
    """Each (ours, reference, compare) must agree."""
    bad = [(a, b) for a, b, cmp in pairs if not cmp(a, b)]
    if bad:
        raise RuntimeError(f"{what}: outputs differ: {bad}")


def sam_same(a, b):
    return sam_body(a) == sam_body(b)


def commands(quick):
    """Phase 8: the port's index at 4.64 Mbp against tools/make_biggenome.py's
    artifacts; the staged index commands, fastmap, aln, samse, sampe,
    bwasw and pemerge on tests/data against the goldens or the JAX CLI,
    with aln + samse on phase 4's reads against the JAX CLI; mem --engine
    host with CUDA never initialised; the graft entry's dry run on the
    card; the bench and run_eval on phase 4's dataset.  `quick` keeps the
    bundled-genome steps and the dry run."""
    t_phase = time.perf_counter()
    out = os.path.join(HERE, ".smoke_data", "commands")
    os.makedirs(out, exist_ok=True)
    seconds, identical = {}, []

    def o(name):
        return os.path.join(out, name)

    def d(name):
        return os.path.join(DATA, name)

    if not quick:   # the 4.64 Mbp index, alone (its build time is kept)
        fa = o("genome.fa")
        with open(os.path.join(BIG, "genome.fa"), "rb") as f, \
                open(fa, "wb") as g:
            g.write(f.read())
        _, seconds["index_4.64Mbp"] = run_module(PORT_CLI, ["index", fa],
                                                 o("index.log"))
        exts = INDEX_EXTS + ((".sa8",) if os.path.exists(
            os.path.join(BIG, "genome.fa.sa8")) else ())
        check_same([(fa + e, os.path.join(BIG, "genome.fa") + e, same_bytes)
                    for e in exts], "index at 4.64 Mbp")
        identical.append("index at 4.64 Mbp: " + " ".join(exts))

    # the host commands, all at once
    st = o("staged")
    with open(d("genome.fa"), "rb") as f, open(st + ".fa", "wb") as g:
        g.write(f.read())
    jobs = {
        "staged_index": [
            (PORT_CLI, ["fa2pac", st + ".fa", st], o("fa2pac.log")),
            (PORT_CLI, ["pac2bwt", st + ".pac", st + ".bwt"],
             o("pac2bwt.log")),
            (PORT_CLI, ["bwtupdate", st + ".bwt"], o("bwtupdate.log")),
            (PORT_CLI, ["bwt2sa", "-i", "32", st + ".bwt", st + ".sa"],
             o("bwt2sa.log")),
            (PORT_CLI, ["fa2pac", "-f", st + ".fa", st + "_fwd"],
             o("fa2pac_f.log"))],
        "fastmap": [(PORT_CLI, ["fastmap", d("genome.fa"), d("reads_se.fq")],
                     o("fastmap.txt"))],
        "samse": [(PORT_CLI, ["samse", d("genome.fa"), d("golden_se.sai"),
                              d("reads_se.fq")], o("samse.sam"))],
        "sampe": [(PORT_CLI, ["sampe", d("genome.fa"), d("golden_r1.sai"),
                              d("golden_r2.sai"), d("reads_1.fq"),
                              d("reads_2.fq")], o("sampe.sam"))],
        "bwasw": [(PORT_CLI, ["bwasw", d("genome.fa"), d("reads_se.fq")],
                   o("bwasw.sam"))],
        "pemerge": [(PORT_CLI, ["pemerge", d("reads_1.fq"), d("reads_2.fq")],
                     o("pemerge.fq"))],
        "pemerge_jax": [(JAX_CLI, ["pemerge", d("reads_1.fq"),
                                   d("reads_2.fq")], o("pemerge_jax.fq"))],
    }
    for tag, fq in (("se", "reads_se.fq"), ("r1", "reads_1.fq"),
                    ("r2", "reads_2.fq")):
        jobs[f"aln_{tag}"] = [(PORT_CLI, ["aln", d("genome.fa"), d(fq)],
                               o(f"aln_{tag}.sai"))]
    if not quick:
        sub = head_fastq(os.path.join(BIG, "reads_se.fq"),
                         o(f"big_{N_ALN_BIG}.fq"), N_ALN_BIG)
        big = os.path.join(BIG, "genome.fa")
        for name, module in (("aln_samse_big", PORT_CLI),
                             ("aln_samse_big_jax", JAX_CLI)):
            jobs[name] = [(module, ["aln", big, sub], o(name + ".sai")),
                          (module, ["samse", big, o(name + ".sai"), sub],
                           o(name + ".sam"))]
    seconds.update(run_jobs(jobs))
    ref = d("genome.fa")
    check_same([(st + e, ref + e, same_bytes) for e in (".bwt", ".sa")]
               + [(st + "_fwd" + e, ref + e, same_bytes)
                  for e in (".pac", ".ann", ".amb")], "staged index")
    check_same([(o("fastmap.txt"), d("golden_fastmap.txt"), same_bytes),
                (o("aln_se.sai"), d("golden_se.sai"), same_bytes),
                (o("aln_r1.sai"), d("golden_r1.sai"), same_bytes),
                (o("aln_r2.sai"), d("golden_r2.sai"), same_bytes),
                (o("samse.sam"), d("golden_samse.sam"), sam_same),
                (o("sampe.sam"), d("golden_sampe.sam"), sam_same),
                (o("bwasw.sam"), d("golden_bwasw.sam"), sam_same),
                (o("pemerge.fq"), o("pemerge_jax.fq"), same_bytes)],
               "the bundled commands")
    identical += ["staged index: .bwt .sa .pac .ann .amb",
                  "fastmap, aln se/r1/r2, samse, sampe, bwasw: the goldens",
                  "pemerge: the JAX CLI's"]
    if not quick:
        check_same([(o("aln_samse_big.sai"), o("aln_samse_big_jax.sai"),
                     same_bytes),
                    (o("aln_samse_big.sam"), o("aln_samse_big_jax.sam"),
                     sam_same)], f"aln + samse on {N_ALN_BIG} reads")
        identical.append(f"aln + samse on {N_ALN_BIG} reads of the 4.64 "
                         "Mbp set: the JAX CLI's")

    # mem --engine host: the golden, and no CUDA context in the process
    argv = [PORT_CLI, "mem", "--engine", "host", ref, d("reads_se.fq")]
    code = ("import atexit, runpy, sys\n"
            "def report():\n"
            "    t = sys.modules.get('torch')\n"
            "    sys.stderr.write('CUDA_INITIALIZED %%s\\n'\n"
            "                     %% bool(t and t.cuda.is_initialized()))\n"
            "atexit.register(report)\n"
            "sys.argv = %r\n"
            "runpy.run_module(%r, run_name='__main__', alter_sys=True)\n"
            % (argv, PORT_CLI))
    err, seconds["mem_engine_host"] = run_module(None, None, o("host.sam"),
                                                 code=code)
    if "CUDA_INITIALIZED False" not in err:
        raise RuntimeError("mem --engine host initialised CUDA:\n"
                           + err[-2000:])
    check_same([(o("host.sam"), d("golden_se.sam"), sam_same)],
               "mem --engine host")
    identical.append("mem --engine host: golden_se.sam, CUDA never "
                     "initialised")

    # the compile check and dry run on the card
    _, seconds["graft_entry"] = run_module("bwamem_tpu_torch.graft_entry",
                                           [], o("graft_entry.json"))
    with open(o("graft_entry.json")) as f:
        graft = json.loads(f.read().splitlines()[-1])
    idle = [k for k in ("smem1_step", "smem_superstep", "sa_walk",
                        "extend_lr") if not graft["launches"][k]]
    if not graft["ok"] or idle:
        raise RuntimeError(f"graft_entry: {idle} did not launch: {graft}")

    bench, run_eval = {}, None
    if not quick:
        # the bench, SE and PE, on phase 4's dataset, its chunks cut
        for tag, pe in (("se", ""), ("pe", "1")):
            env = dict(command_env(), BWAMEM_TPU_BENCH_DATA=BIG,
                       BWAMEM_TPU_BENCH_CHUNKS=BENCH_CHUNKS,
                       BWAMEM_TPU_BENCH_STAGES="1", BWAMEM_TPU_BENCH_PE=pe)
            err, seconds[f"bench_{tag}"] = run_module(
                "bwamem_tpu_torch.bench", [], o(f"bench_{tag}.json"), env)
            with open(o(f"bench_{tag}.json")) as f:
                lines = f.read().splitlines()
            if len(lines) != 1:
                raise RuntimeError(f"bench {tag}: {len(lines)} stdout lines")
            bench[tag] = {"line": json.loads(lines[0]),
                          "env": {"BWAMEM_TPU_BENCH_CHUNKS": BENCH_CHUNKS},
                          "stages": [ln for ln in err.splitlines()
                                     if ln.startswith(("[bench] workload",
                                                       "[bench] pass",
                                                       "[bench] stages"))]}
        # one process: the diffs against phase 4's host SAMs, then a
        # one-chunk bench of each
        _, seconds["run_eval"] = run_module(
            "bwamem_tpu_torch.run_eval",
            [BIG, "--n-diff", str(N_DIFF_SE), "--se-host",
             os.path.join(BIG, "diff_host_se.sam"), "--pe-host",
             os.path.join(BIG, "diff_host_pe.sam"), "--bench-chunks", "1"],
            o("run_eval.txt"))
        with open(o("run_eval.txt")) as f:
            run_eval = f.read().splitlines()
        passed = [ln.split()[1] for ln in run_eval if ln.startswith("PASS")]
        if sorted(passed) != ["pe", "se"]:
            raise RuntimeError(f"run_eval: {run_eval}")
    say("commands", seconds=seconds, identical=identical,
        graft_entry=graft, bench=bench, run_eval=run_eval,
        phase_seconds=time.perf_counter() - t_phase)


HUMAN_MBP = 128   # phase 9's genome: a 128 MB occ table and .sa8, ~5x the L2
HUMAN_READS = ["--n-se", "2000", "--n-pe", "1000"]
# the kernels' reads: 4 x 8,192 distinct SE reads, as phase 2 takes from
# the 100k set (the superstep's lanes, the extension's seeds)
HUMAN_KERNEL_READS = ["--n-se", "32768"]
N_DIFF_HUMAN = 2000   # reads of each diff (pairs: half)
HUMAN_BENCH_CHUNKS = 2
RUN3G = "bwamem_tpu_torch.run3g"


# run_peak's parent of the measured command: a child's rusage counts the
# RSS it inherits at the fork, so the command is forked from this small
# process, not from this script (gigabytes with the card's context)
PEAK_PARENT = ("import resource, subprocess, sys; "
               "subprocess.run(sys.argv[1:], check=True, "
               "stdout=subprocess.DEVNULL); "
               "print(resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss)")


def run_peak(cmd, env):
    """``python cmd`` in a subprocess from the checkout, stdout dropped:
    (seconds, its peak RSS in bytes).  A non-zero exit fails."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", PEAK_PARENT, sys.executable]
                         + cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                         check=True)
    return time.perf_counter() - t0, int(res.stdout.split()[-1]) << 10


def human_data(mbp, repeats):
    """Phase 9's set at mbp Mbp, cached in .smoke_data: the genome from
    tools/make_gbp_fasta.py (i.i.d., or ~45% repeats), the port's index
    (built in memory at every size, BWAMEM_TPU_STREAM_INDEX=0), 2,000 SE
    reads and 1,000 pairs from tools/sample_reads.py, and 32,768 SE reads
    in kernel/ for the kernels.  Returns (its directory, the seconds and
    the peak RSS in GiB of each step made in this run); each step's
    marker is written when it has ended."""
    name = f"human_{mbp:g}mbp" + ("_repeats" if repeats else "")
    dst = os.path.join(HERE, ".smoke_data", name)
    os.makedirs(os.path.join(dst, "kernel"), exist_ok=True)
    fa = os.path.join(dst, "genome.fa")
    seconds, peak = {}, {}
    for step, cmd in (
            ("genome", ["tools/make_gbp_fasta.py", dst, "--mbp", f"{mbp:g}"]
             + (["--repeats"] if repeats else [])),
            ("index", ["-m", PORT_CLI, "index", fa]),
            ("reads", ["tools/sample_reads.py", fa] + HUMAN_READS),
            ("kernel_reads", ["tools/sample_reads.py", fa]
             + HUMAN_KERNEL_READS + ["--out", os.path.join(dst, "kernel")])):
        done = os.path.join(dst, f".{step}_complete")
        if os.path.exists(done):
            continue
        seconds[step], rss = run_peak(
            cmd, dict(command_env(), BWAMEM_TPU_STREAM_INDEX="0"))
        peak[step] = rss / (1 << 30)
        open(done, "w").close()
        say("human_step", step=step, seconds=seconds[step],
            peak_rss_gib=peak[step])
    return dst, seconds, peak


def run3g_log(err):
    """The numbers of run3g's stderr: load and engine-up seconds, seq_len,
    cdt, sa_intv, the tables' bytes, each phase's seconds and stats
    line."""
    out = {}
    for ln in err.splitlines():
        if not ln.startswith("[run3g] "):
            continue
        words = ln[len("[run3g] "):].split()
        if words[0] in ("stats", "stages"):
            out[f"{words[0]}_{words[1]}"] = json.loads(" ".join(words[2:]))
        elif words[:2] == ["index", "loaded"]:
            out["load_s"] = float(words[3])
            out["seq_len"] = int(words[5][len("(seq_len="):-1])
        elif words[:2] == ["engine", "up"]:
            out["engine_up_s"] = float(words[3])
            out.update(w.split("=", 1) for w in words if "=" in w)
            out["table_bytes"] = int(out["table_bytes"]) + int(words[-2])
        elif words[:2] == ["diff", "phase:"]:
            out["diff_s"] = float(words[5])
        elif words[0] == "bench:":
            out["bench_s"] = float(words[4])
        elif words[:3] == ["bench", "device", "busy:"]:
            out["device_busy_s"] = float(words[3])
            out["device_events"] = int(words[8][1:])
            out["device_busy_share"] = out["device_busy_s"] / float(words[6])
    return out


def human_scale(mbp, repeats, bench_chunks, rec, rec2=None, sa8_mb=None):
    """Phase 9 at mbp Mbp: the host references (``bwamem_tpu.cli mem
    --engine host`` and ``run3g host``, all at once), then ``run3g cuda``
    on the 2,000 SE reads and the 1,000 pairs in this process, each
    counted on its own (the superstep, SA walk and extend_lr launched),
    its records byte-identical to both references, then a bench of
    bench_chunks chunks; the same with BWAMEM_TPU_FORCE_I64=1 where the
    index's coordinates are int32; the SE bench traced in a process of
    its own; the SE diff with the extension rows built on the card
    (BWAMEM_TPU_ONCHIP_EXT=1, build_rows launched); then the superstep,
    the SA walk and extend_lr against their plain versions at full width
    on this index (rec), each beside phase 2's 4.64 Mbp record (rec2).
    With sa8_mb, the SE run and the three kernels once more with
    BWAMEM_TPU_SA8_MAX_MB=sa8_mb (the .sa8 sample where it fits)."""
    from bwamem_tpu_torch import run3g
    from bwamem_tpu_torch.ops import _kernels
    from bwamem_tpu_torch.ops.fm import coordinate_dtype, dense_sa_serves
    import torch
    t_phase = time.perf_counter()
    data, seconds, peak = human_data(mbp, repeats)
    fa = os.path.join(data, "genome.fa")
    out = os.path.join(data, "out")
    os.makedirs(out, exist_ok=True)

    def o(name):
        return os.path.join(out, name)

    # the index's doubled length: twice the genome's bases as made
    with open(fa + ".bwt", "rb") as f:
        seq_len = int.from_bytes(f.read(40)[32:40], "little")
    with open(fa + ".ann") as f:
        l_pac = int(f.readline().split()[0])
    if l_pac != int(mbp * 1e6) or seq_len != 2 * l_pac:
        raise RuntimeError(f"seq_len {seq_len}, l_pac {l_pac}: not twice "
                           f"the genome's {int(mbp * 1e6)} bases")
    sets = (("se", ["reads_se.fq"], []),
            ("pe", ["reads_1.fq", "reads_2.fq"], ["--pe"]))
    jobs = {}
    for tag, files, flag in sets:
        jobs[f"jax_host_{tag}"] = [(JAX_CLI, ["mem", "--engine", "host", fa]
                                    + [os.path.join(data, f) for f in files],
                                    o(f"jax_host_{tag}.sam"))]
        jobs[f"run3g_host_{tag}"] = [(RUN3G, ["host", data, str(N_DIFF_HUMAN)]
                                      + flag, o(f"run3g_host_{tag}.sam"))]
    seconds.update(run_jobs(jobs))
    wide = coordinate_dtype(seq_len) == torch.int64

    def records_match(path, tag, what, chunks):
        """path's records against both references of the tag's set; the
        bench's JSON line (the last) taken off first where chunks ran."""
        with open(path) as f:
            lines = f.read().splitlines(keepends=True)
        bench = json.loads(lines.pop()) if chunks else None
        for ref in (f"jax_host_{tag}.sam", f"run3g_host_{tag}.sam"):
            with open(o(ref)) as f:
                want = [ln for ln in f if not ln.startswith("@")]
            if lines != want:
                raise RuntimeError(f"{what}: its records differ from "
                                   f"{o(ref)}")
        return len(lines), bench

    def cuda_run(name, tag, flag, env, chunks, build=False):
        """run3g cuda in this process, counted on its own: the flat
        route's kernels (and build_rows) launched; on a repeat genome's
        seed-rich chunks the wave path may extend with extend2."""
        _kernels.reset_counts()
        argv = ([DEVICE, data, str(N_DIFF_HUMAN), "--bench-chunks",
                 str(chunks)] + flag)
        rc, err, dt = run_entry(run3g.main, argv, o(f"cuda_{name}.out"),
                                env)
        with open(o(f"cuda_{name}.err"), "w") as f:
            f.write(err)
        if rc:
            raise RuntimeError(f"run3g {argv} exited {rc}:\n{err}")
        launches = {k.name: k.launches for k in (
            _kernels.SMEM, _kernels.SA, _kernels.EXTEND, _kernels.EXTEND2,
            _kernels.GLOBAL2, _kernels.ALIGN2, _kernels.BUILD)}
        need = ("smem_superstep", "sa_walk") + (() if repeats else (
            ("extend_lr",) + (("build_rows",) if build else ())))
        if not all(launches[n] for n in need) or not (
                launches["extend_lr"] or launches["extend2"]):
            raise RuntimeError(f"a kernel of run3g cuda {name} did not "
                               f"launch: {launches}")
        records, bench = records_match(o(f"cuda_{name}.out"), tag,
                                       f"run3g cuda {name}", chunks)
        got = run3g_log(err)
        if got.get("seq_len") != seq_len:
            raise RuntimeError(f"run3g {name}: seq_len {got.get('seq_len')}")
        if (env.get("BWAMEM_TPU_FORCE_I64") or wide) and \
                got.get("cdt") != "int64":
            raise RuntimeError(f"run3g {name}: cdt {got.get('cdt')}")
        gc.collect()   # the run's index, gigabytes at human scale
        say("human_run", run=name, seconds=dt, bench=bench)
        return dict(reads=N_DIFF_HUMAN, identical=True, records=records,
                    seconds=dt, bench=bench, launches=launches, **got)

    runs = {}
    for i64 in [""] + ([] if wide else ["1"]):
        for tag, _, flag in sets:
            name = tag + ("_i64" if i64 else "")
            runs[name] = cuda_run(
                name, tag, flag, {"BWAMEM_TPU_FORCE_I64": i64} if i64 else {},
                bench_chunks)
    # the card's busy share: the SE run again in a process of its own,
    # its bench traced by torch.profiler (run3g --profile)
    if bench_chunks:
        argv = [DEVICE, data, str(N_DIFF_HUMAN), "--bench-chunks",
                str(bench_chunks), "--profile", o("profile")]
        err, dt = run_module(RUN3G, argv, o("cuda_se_profiled.out"))
        records, bench = records_match(o("cuda_se_profiled.out"), "se",
                                       "run3g cuda --profile", bench_chunks)
        runs["se_profiled"] = dict(reads=N_DIFF_HUMAN, identical=True,
                                   records=records, seconds=dt, bench=bench,
                                   **run3g_log(err))
    # the extension rows built on the card: the JAX package turns this
    # route off past 2^31 doubled bases (a TPU VMEM limit), the port
    # takes it at every size
    runs["se_onchip_ext"] = cuda_run("se_onchip_ext", "se", [],
                                     {"BWAMEM_TPU_ONCHIP_EXT": "1"}, 0,
                                     build=True)

    # the kernels at full width on this index (8,192 distinct reads),
    # each beside phase 2's
    label = f"human_{mbp:g}Mbp" + ("_repeats" if repeats else "")
    kreads = os.path.join(data, "kernel", "reads_se.fq")
    check_kernels(label, fa, kreads, rec, main_only=True)
    # the SE run and the kernels at another .sa8 cap: at human scale the
    # dense sample on the card beside the sparse one
    if sa8_mb is not None:
        env = {"BWAMEM_TPU_SA8_MAX_MB": f"{sa8_mb:g}"}
        name = f"se_sa8_{sa8_mb:g}mb"
        runs[name] = cuda_run(name, "se", [], env, bench_chunks)
        with environ(env):
            want = "8" if dense_sa_serves(fa) else "32"
            if runs[name].get("sa_intv") != want:
                raise RuntimeError(f"run3g {name}: sa_intv "
                                   f"{runs[name].get('sa_intv')}, not {want}")
            check_kernels(f"{label}_sa8_{sa8_mb:g}mb", fa, kreads, rec,
                          main_only=True)

    def brief(r):
        return r and {k: r[k] for k in (
            "index", "ms", "profiler_ms", "device_ms", "host_ms", "plain_ms",
            "bound_ms", "bound_by", "max_abs_err", "lanes", "keys",
            "live_keys", "longest_walk", "chain_ns_per_step",
            "chain_floor_ms", "sa_intv", "sa_bytes") if k in r}

    def phase2(name):
        got = [r for r in (rec2 or {}).get(name, ())
               if r.get("bucket") in (None, "L128", "LQ128")]
        return brief(got[-1]) if got else None
    say("human_scale", mbp=mbp, repeats=repeats, data=data,
        seq_len=seq_len, l_pac=l_pac, past_2_32=seq_len > 1 << 32,
        data_seconds=seconds, peak_rss_gib=peak, runs=runs,
        kernels={k: {"here": [brief(r) for r in v
                              if r["index"].startswith(label)],
                     "phase2": phase2(k)}
                 for k, v in rec.items()},
        phase_seconds=time.perf_counter() - t_phase)


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
