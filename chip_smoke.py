#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bwamem_tpu_torch) on one GPU.

    python3 chip_smoke.py           # all phases, one GPU
    python3 chip_smoke.py --quick   # phases 1-3 on the bundled genome only

Phases, each printing one line with its own numbers and seconds:

1. probe: the card, its capability (must be 9.0), its power limit, nvcc,
   and the build of the CUDA kernels from csrc/ (one nvcc per source,
   all started together);
2. kernels: each kernel against its plain PyTorch version on the same
   CUDA inputs at the main path's widths (LANES=8192, KEY_CAP=65536,
   WAVE_EXT=16384; WAVE=512 for extend2 and align2, WAVE_GLO=1024 for
   global2), on the bundled genome and on a 4,641,652 bp genome (the
   length of E. coli K-12 MG1655) generated by tools/make_biggenome.py.
   The extend2 lanes are the extension rows of the genome's seeds; the
   global2 and align2 lanes are its reads against mutated reference
   windows at their seeds.  Integer outputs: the tolerance is zero;
3. goldens: ``mem`` SE, SE -a -M and PE on tests/data through
   ``bwamem_tpu_torch.cli --device cuda``, byte-identical to the goldens
   (without @PG), then the -v 4 SE, -v 4 PE and -v 5 traces of the
   reference binary through the generator wave path;
4. real size: 100,000 SE reads and 20,000 pairs on the bacterial-size
   genome, timed (reads/s, device time per tag, host-route counters),
   then again with BWAMEM_TPU_VERIFY=1 (every extension checked against
   the native scalar twin, same output), then the first 4,000 reads and
   2,000 pairs diffed against ``bwamem_tpu.cli mem --engine host``;
   then -v 4 on 5,000 pairs, whose SAM records equal a -v 3 run of the
   same files, and on their first 500 pairs the whole -v 4 output equal
   to ``bwamem_tpu.cli mem --engine host -v 4``; then seed-rich chunks:
   2,000 reads and 1,000 pairs of a 16 Mbp repeat genome
   (tools/make_gbp_fasta.py --repeats, ~45% repeat bases; cut from a
   human-scale genome for the time limit), byte-identical to
   ``--engine host``.

Launch counts are zeroed just before the phase-3 goldens; the flat-route
kernels (superstep, SA walk, extend_lr) must have launched after phase
4, and the wave-path kernels (extend2, global2, align2) after the
phase-3 traces.  The last two lines are the kernels' JSON record and the
result JSON; any failure exits non-zero without them.
"""

import io
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
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


def say(phase, **kv):
    print(json.dumps(dict(phase=phase, **kv)), flush=True)


def run_mem(args, out_path, env=None):
    """`mem` in this process through the port's CLI: stdout to out_path,
    stderr captured.  Returns (stderr text, seconds)."""
    from bwamem_tpu_torch import cli
    old_env = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    err = io.StringIO()
    so, se = sys.stdout, sys.stderr
    t0 = time.perf_counter()
    try:
        with open(out_path, "w") as f:
            sys.stdout, sys.stderr = f, err
            rc = cli.main_mem(["--device", DEVICE] + args)
    finally:
        sys.stdout, sys.stderr = so, se
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"mem {args} exited {rc}:\n{err.getvalue()}")
    return err.getvalue(), dt


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


def max_err(pairs):
    """Largest |kernel - plain| over the compared arrays (0 = equal)."""
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise RuntimeError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


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
    from bwamem_tpu.index.bntseq import NT4_TABLE
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


def check_kernels(label, idx_prefix, fq, rec):
    """Phase 2 on one index: each kernel against its plain version."""
    import numpy as np
    import torch
    from bwamem_tpu.config import MemOptions, fill_scmat
    from bwamem_tpu.index import load_index
    from bwamem_tpu.core import nfinalize
    from bwamem_tpu.io.fastq import parse_fastx
    from bwamem_tpu_torch.ops import fm as tfm, smem as tsm, ksw as tks
    from bwamem_tpu_torch.ops.engine import TorchSeedingEngine
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    fm_host, bns = load_index(idx_prefix)
    eng = TorchSeedingEngine(fm_host, dev)
    d = eng.dfm
    sdr = eng.seeder
    B, L, M, OC = sdr.lanes, sdr.L, sdr.M, sdr.out_cap
    opt = MemOptions()
    opt.mat = fill_scmat(opt.a, opt.b)

    # SMEM superstep: B reads (the file's reads, repeated to fill)
    seqs = read_fastq_seqs(fq, B)
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
    over = po[5]
    if not torch.equal(ko[5], over):
        raise RuntimeError(f"{label}: superstep over flags differ")
    ok = ~over
    if not torch.equal(ko[4][ok], po[4][ok]):
        raise RuntimeError(f"{label}: superstep n_out differs")
    slot = (torch.arange(OC, device=dev).unsqueeze(0)
            < po[4].unsqueeze(1)) & ok.unsqueeze(1)
    err = max_err([(ko[i][slot], po[i][slot]) for i in range(4)]
                  + [(ko[4][ok], po[4][ok])])
    if err:
        raise RuntimeError(f"{label}: superstep slots differ ({err})")
    rec["smem_superstep"].append(dict(index=label, ms=k_ms, plain_ms=p_ms,
                                      max_abs_err=err, lanes=B,
                                      over=int(over.sum())))

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
    rec["sa_walk"].append(dict(index=label, ms=k_ms, plain_ms=p_ms,
                               max_abs_err=err, keys=len(keys),
                               live_keys=nk))

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
    rows = lambda k, w: T(pk[k][grp][:, :w // 2])  # noqa: E731
    ext_args = (rows("lq_pk", LQ), rows("lt_pk", LT), T(pk["llq"][grp]),
                T(pk["llt"][grp]), rows("rq_pk", LQ), rows("rt_pk", LT),
                T(pk["rlq"][grp]), T(pk["rlt"][grp]), eng._mat_dev(opt),
                opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
                opt.pen_clip5, opt.pen_clip3, opt.zdrop, T(pk["scs"][grp]),
                T(pk["sqb"][grp]), T(pk["srb"][grp]), T(pk["rmax0"][grp]),
                T(pk["lqv"][grp]), T(pk["slv"][grp]), LQ, LT)
    k_ms, ke = cuda_ms(lambda: tks.extend_lr_cuda(*ext_args), 3)
    p_ms, pe_ = cuda_ms(lambda: tks.extend_lr_plain(*ext_args), 1, False)
    err = max_err(list(zip(ke, pe_)))
    if err:
        raise RuntimeError(f"{label}: extension differs ({err})")
    rec["extend_lr"].append(dict(index=label, ms=k_ms, plain_ms=p_ms,
                                 max_abs_err=err, lanes=W, LT=LT,
                                 distinct_seeds=len(lanes)))
    check_sw_kernels(label, eng, bns, opt, reads, cb.flat, pk, rec)
    del eng
    torch.cuda.empty_cache()
    say("kernels", index=label, blocks=int(d.n_blocks),
        seconds=time.perf_counter() - t0,
        results={k: v[-1] for k, v in rec.items()})


def check_sw_kernels(label, eng, bns, opt, reads, flat, pk, rec):
    """Phase 2, the wave-path kernels: extend2 over the seeds' extension
    rows, global2 and align2 over reads against mutated reference
    windows at their first seed, each at its wave width."""
    import numpy as np
    import torch
    from bwamem_tpu.index.bntseq import get_seq
    from bwamem_tpu_torch.ops import ksw as tks, ksw_align as tka
    dev = torch.device("cuda")
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
    rec["extend2"].append(dict(index=label, ms=k_ms, plain_ms=p_ms,
                               max_abs_err=err, lanes=eng.wave, LT=LT))

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
    rec["global2"].append(dict(index=label, ms=k_ms, plain_ms=p_ms,
                               max_abs_err=err, lanes=W, LQ=GLQ, LT=GLT))

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
        res.update({f"ms_{tag}": k_ms, f"plain_ms_{tag}": p_ms})
    # the kernels line reports the u8 pass: bwa's mate rescue of reads
    # shorter than 250 bp takes it (KSW_XBYTE when l_ms * a < 250)
    res.update(ms=res["ms_u8"], plain_ms=res["plain_ms_u8"])
    rec["align2"].append(res)


def main(argv):
    quick = "--quick" in argv
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "bwamem_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    os.environ.update(WIDTHS)
    sys.path.insert(0, HERE)
    from bwamem_tpu_torch.ops import _kernels

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
    ptxas = [ln.strip() for ln in _kernels.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say("probe", device=name, capability=list(cap), smi=smi, nvcc=nvcc,
        torch=torch.__version__, build_seconds=build_s, ptxas=ptxas,
        seconds=time.perf_counter() - t0)

    # bacterial-size dataset (cached in a git-ignored directory)
    if not quick:
        t0 = time.perf_counter()
        if not os.path.exists(os.path.join(BIG, "genome.fa.sa8")):
            subprocess.run([sys.executable,
                            os.path.join(HERE, "tools", "make_biggenome.py"),
                            BIG] + BIG_ARGS, check=True,
                           stdout=subprocess.DEVNULL)
        say("data", dir=BIG, seconds=time.perf_counter() - t0)

    # 2. kernels against their plain versions
    rec = {k.name: [] for k in _kernels.KERNELS}
    check_kernels("bundled_105kbp", os.path.join(DATA, "genome.fa"),
                  os.path.join(DATA, "reads_se.fq"), rec)
    if not quick:
        check_kernels("ecoli_len_4.64Mbp", os.path.join(BIG, "genome.fa"),
                      os.path.join(BIG, "reads_se.fq"), rec)

    # 3-4 on the flat route: launch counts zeroed just before, read just
    # after
    out = os.path.join(HERE, ".smoke_data")
    os.makedirs(out, exist_ok=True)
    ref = os.path.join(DATA, "genome.fa")
    _kernels.reset_counts()
    t0 = time.perf_counter()
    for tag, args, golden in (
            ("se", [ref, os.path.join(DATA, "reads_se.fq")],
             "golden_se.sam"),
            ("se_aM", ["-a", "-M", ref, os.path.join(DATA, "reads_se.fq")],
             "golden_se_aM.sam"),
            ("pe", [ref, os.path.join(DATA, "reads_1.fq"),
                    os.path.join(DATA, "reads_2.fq")], "golden_pe.sam")):
        check_golden(args, os.path.join(out, f"smoke_{tag}.sam"), golden)
    say("goldens", identical=["golden_se.sam", "golden_se_aM.sam",
                              "golden_pe.sam"],
        launches={k.name: k.launches for k in _kernels.KERNELS},
        seconds=time.perf_counter() - t0)
    if not quick:
        real_size()
    launches = read_counts((_kernels.SMEM, _kernels.SA, _kernels.EXTEND),
                           "the flat route")

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

    kernels = []
    for k in _kernels.KERNELS:
        last = rec[k.name][-1]      # the largest index measured
        kernels.append(dict(
            name=k.name, route="cuda", source=k.source,
            replaces=k.replaces, launches=launches[k.name],
            max_abs_err=max(r["max_abs_err"] for r in rec[k.name]),
            ms=last["ms"], plain_ms=last["plain_ms"]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def check_golden(args, path, golden):
    """`mem` on tests/data against a golden file; returns its stderr."""
    err, _ = run_mem(args, path)
    if sam_body(path) != sam_body(os.path.join(DATA, golden)):
        raise RuntimeError(f"golden {golden}: output differs ({path})")
    return err


def read_counts(kernels, path):
    """The launch counts of a path's kernels; each must be > 0."""
    counts = {k.name: k.launches for k in kernels}
    if min(counts.values()) == 0:
        raise RuntimeError(f"a kernel of {path} did not launch: {counts}")
    return counts


def real_size():
    idx = os.path.join(BIG, "genome.fa")
    se = os.path.join(BIG, "reads_se.fq")
    r1 = os.path.join(BIG, "reads_1.fq")
    r2 = os.path.join(BIG, "reads_2.fq")
    for tag, args, n_reads in (("se", [idx, se], 100000),
                               ("pe", [idx, r1, r2], 40000)):
        path = os.path.join(BIG, f"port_{tag}.sam")
        err, dt = run_mem(args, path)
        say(f"real_{tag}", reads=n_reads, seconds=dt,
            reads_per_s=n_reads / dt, stats=device_stats(err))
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
                    ["-m", "bwamem_tpu.cli", "index", fa],
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


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
