"""The PyTorch seeding engine, pluggable into core.pipeline.

Port of bwamem_tpu/ops/engine.py (JaxSeedingEngine), with its two
routes:

- the native flat-array route of ``mem``: per chunk, device seeding
  (superstep + SA walk kernels) -> native chaining -> native packing of
  every seed's extension -> device extension kernel in WAVE_EXT lane
  groups -> native region building;
- the generator wave path, ``drive_waves``: the shared generators of
  bwamem_tpu/core yield Smith-Waterman requests (core/swdrive.py), and
  each round serves the live ones grouped by type, batched launches per
  type: extend2 and extend_lr (csrc/extend.cu), global2
  (csrc/global.cu), align2 (csrc/align.cu).  It serves ``-v 4``/``-v 5``
  tracing (the per-read extension, then the SE and PE finalize of
  core.pipeline) and chunks richer than 16 seeds per read.

The host C++ library (native/) is required.  Each chunk takes the
smallest length bucket that holds its longest read of at most
BWAMEM_TPU_DEV_MAX_LEN (default 512) bp, as in the JAX engine
(engine.py:156-211): seeding at L=128, 256 or 512, the flat route's
extension at LQ=128 (target buckets BWAMEM_TPU_LT_BUCKETS, 160/320/544),
LQ=256 (BWAMEM_TPU_LT_BUCKETS_LONG, 320/544/800) or LQ=512
(BWAMEM_TPU_LT_BUCKETS_XL, 576/1056).  Reads longer than the chunk's
seeding bucket take the host oracle and are counted as
``host_routed_reads``; the wave path keeps LQ=128, as the JAX engine's
does.  The JAX package's TPU limits on these buckets are left behind:
the uint8 wire of the 256 bucket (qe == 256 sent as 0), the radix-1024
merge key of the 512 bucket (the kernels compare (qb, qe) pairs), and
the on-chip row builder's VMEM caps.

Two routes of the flat path are chosen by environment, as in the JAX
engine: BWAMEM_TPU_SUPERSTEP=0 seeds round by round (ops/seeding.py
interval_streams), and BWAMEM_TPU_ONCHIP_EXT=1 (or ``force``) builds
the extension rows on the device from per-seed scalars
(ops/extbuild.py).

On the wave path, requests a wave does not take go
to the scalar oracle (core.swdrive.serve_host) and are counted in
``kernel_time_by_tag``: ``wave_host_oversize_<type>`` for lanes past the
kernel's shapes, ``wave_host_tail`` for rounds with fewer than MIN_WAVE
live requests; ``wave_rounds`` counts the rounds.

Every seeding, SA-walk and SW launch but two goes through
parallel.mesh.ShardedKernels, which takes its lanes on the host: over
the engine's one device, or over a reads mesh (``mesh``, a tuple of
devices from parallel/mesh.py make_mesh; JAX engine.py:110-166), the
index and the scoring matrix replicated on each device, the lanes split.
The lane widths must be divisible by the shard count.  As in the JAX
engine, only the L=128 bucket seeds under the mesh (longer reads chain on
the host oracle), the on-device row builder stays off, and align2 and the
SUPERSTEP=0 route's iterator steps run on the mesh's first device.
With ``shard_tables`` (or BWAMEM_TPU_SHARD_TABLES=1, JAX
engine.py:131-152) over a mesh of two or more shards, the occ table and
the sampled SA are split by rows over the shards instead of replicated
(parallel/mesh.py), and every kernel that reads them, the first
device's iterator steps too, reads each part where it lies.

The JAX engine's speculative extension cache (ExtCache,
_speculate_extensions) is not ported: on the routes that reach
drive_waves it is bypassed (traces) or over its budget (seed-rich
chunks, the budget being 16 seeds per read), so it never answers a
request there.
"""

import os
import subprocess
import sys
import time
from typing import List

import numpy as np
import torch

from bwamem_tpu_torch.core import nfinalize

from .extbuild import extend_lr_onchip, pac_tensor, reads_matrix
from .fm import DeviceFmIndex
from .ksw import cigars_from_tracebacks
from .ksw_align import align2_wave
from .seeding import BatchedSeeder


def _default_min_wave() -> int:
    """Below this many live requests a round goes to the scalar oracle:
    64 with the native C++ oracle (~50 us an extension), 8 with the pure
    Python one (bwamem_tpu/ops/engine.py:30-39)."""
    from bwamem_tpu_torch.oracle.ksw import _native
    return 64 if _native() else 8


def _int_list(name: str, default: str) -> tuple:
    """A comma-separated list of ints from the environment."""
    return tuple(int(x) for x in os.environ.get(name, default).split(","))


def _pack4(buf: np.ndarray) -> np.ndarray:
    """Two bases per byte (values 0..4)."""
    return buf[:, 0::2] | (buf[:, 1::2] << np.int8(4))


def _chains_from_flat(flat, n_reads):
    """Per-read Chain-object lists from the flat chain arrays (the input
    of the generator path)."""
    from bwamem_tpu_torch.core.chain import Chain
    chain_off, seed_off, s_rbeg, s_qbeg, s_len = flat
    rb_l, qb_l, ln_l = (np.asarray(s_rbeg).tolist(),
                        np.asarray(s_qbeg).tolist(),
                        np.asarray(s_len).tolist())
    c_off_l = np.asarray(chain_off).tolist()
    sd_off_l = np.asarray(seed_off).tolist()
    out = []
    for i in range(n_reads):
        lst = []
        for c in range(c_off_l[i], c_off_l[i + 1]):
            lo, hi = sd_off_l[c], sd_off_l[c + 1]
            seeds_c = list(zip(rb_l[lo:hi], qb_l[lo:hi], ln_l[lo:hi]))
            lst.append(Chain(pos=seeds_c[0][0], seeds=seeds_c))
        out.append(lst)
    return out


class ChainBatch:
    """chain_batch's result: `.flat` holds the chains of the whole chunk
    as flat arrays (chain_off, seed_off, rbeg, qbeg, len)."""

    def __init__(self, flat):
        self.flat = flat


def _require_native() -> None:
    """Build and load the host C++ library, or raise with make's
    output: the flat route runs through it."""
    res = subprocess.run(["make", "-C", nfinalize._NATIVE_DIR],
                         capture_output=True, text=True)
    if res.returncode != 0 or not nfinalize.available():
        raise RuntimeError("the native host library (native/) is required "
                           "and did not build or load:\n" + res.stdout
                           + res.stderr)


class TorchSeedingEngine:
    """Device engine for core.pipeline: the same methods and counters
    that pipeline calls on the JAX engine."""

    def __init__(self, fm_host, device, mesh=None, shard_tables=None):
        _require_native()
        env = os.environ.get
        self.fm_host = fm_host
        # lane-group widths of the launches (engine.py:24-46): extend2
        # and align2 waves, extend_lr groups, global2 waves
        self.wave = int(env("BWAMEM_TPU_WAVE", "512"))
        self.wave_ext = int(env("BWAMEM_TPU_WAVE_EXT", str(self.wave * 2)))
        self.wave_glo = int(env("BWAMEM_TPU_WAVE_GLO", str(self.wave * 2)))
        # every launch but align2 and the iterator steps goes through the
        # kernels, over a reads mesh (engine.py:116-152) or over this one
        # device; the index is replicated on each of the mesh's devices,
        # or split over them with shard_tables (a mesh of two or more)
        from bwamem_tpu_torch.parallel.mesh import ShardedKernels
        self.mesh = mesh
        if mesh is not None:     # the engine's device is the mesh's first
            device = mesh[0]
            if len(mesh) > 1:
                self._check_widths(len(mesh))
        if shard_tables is None:
            shard_tables = env("BWAMEM_TPU_SHARD_TABLES", "0") != "0"
        self.shard_tables = bool(shard_tables) and mesh is not None \
            and len(mesh) > 1
        self.device = torch.device(device)
        self.kernels = ShardedKernels(
            (self.device,) if mesh is None else mesh,
            DeviceFmIndex.from_host(fm_host), self.shard_tables)
        self.dfm = self.kernels.index_on(self.device)
        self.seeder = BatchedSeeder(self.dfm, fm_host, self, self.kernels)
        # per-chunk length buckets: the L=256 and L=512 seeders are
        # built when a chunk first needs them (engine.py:156-199); a mesh
        # keeps the L=128 one
        self._seeders = {self.seeder.L: self.seeder}
        self.dev_max_len = (128 if mesh is not None else
                            int(env("BWAMEM_TPU_DEV_MAX_LEN", "512")))
        self.min_wave = (int(env("BWAMEM_TPU_MIN_WAVE", "0"))
                         or _default_min_wave())
        # extension target buckets of the three query widths
        # (engine.py:48-56); each list ends at its bucket's LT cap
        self.lt_buckets = _int_list("BWAMEM_TPU_LT_BUCKETS", "160,320,544")
        self.lt_buckets_long = _int_list("BWAMEM_TPU_LT_BUCKETS_LONG",
                                         "320,544,800")
        self.lt_buckets_xl = _int_list("BWAMEM_TPU_LT_BUCKETS_XL",
                                       "576,1056")
        # extension shapes of reads up to 128 bp (engine.py:167-170), the
        # wave path's at every length; a global alignment's target is
        # within the band of its query
        self._ext_lq, self._ext_lt = 128, 544
        self._glo_lq, self._glo_lt = 128, 160
        self._mat = None
        self._pac = None     # (pac, l_pac, its device tensor)
        # device-time accounting (fetch-inclusive, per dispatch tag) and
        # the host-route counters
        self.kernel_time = 0.0
        self.n_dispatches = 0
        self.kernel_time_by_tag = {}

    def _check_widths(self, n: int) -> None:
        """Every launch width must split evenly over n shards
        (engine.py:125-130)."""
        env = os.environ.get
        for width in (int(env("BWAMEM_TPU_LANES", "512")),
                      int(env("BWAMEM_TPU_SA_SLICE", "16384")), self.wave,
                      self.wave_ext, self.wave_glo):
            if width % n:
                raise ValueError(
                    f"lane width {width} not divisible by mesh size "
                    f"{n}; adjust BWAMEM_TPU_LANES/WAVE")

    def _native_ok(self) -> bool:
        return True  # checked in __init__: the engine needs the library

    def _timed(self, fn, *args, _tag="other", **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        dt = time.perf_counter() - t0
        self.kernel_time += dt
        self.n_dispatches += 1
        kt = self.kernel_time_by_tag
        kt[_tag] = kt.get(_tag, 0.0) + dt
        kt["n_" + _tag] = kt.get("n_" + _tag, 0) + 1
        return out

    def _count(self, tag: str, n: int = 1) -> None:
        """Host-route accounting (SMEM buffer, SA walk, key expansion,
        length routing), in the same stats dict."""
        kt = self.kernel_time_by_tag
        kt[tag] = kt.get(tag, 0) + n

    def _mat_dev(self, opt) -> torch.Tensor:
        key = tuple(opt.mat)
        if self._mat is None or self._mat[0] != key:
            self._mat = (key, torch.as_tensor(
                np.asarray(opt.mat, np.int8)).to(self.device))
        return self._mat[1]

    def _seeder_for(self, max_rl: int) -> BatchedSeeder:
        """The smallest seeding bucket that holds a chunk's longest
        device-eligible read (JAX engine.py:181-199)."""
        L = 128 if max_rl <= 128 else (256 if max_rl <= 256 else 512)
        if L not in self._seeders:
            self._seeders[L] = BatchedSeeder(self.dfm, self.fm_host, self,
                                             self.kernels, L=L)
        return self._seeders[L]

    def _ext_shapes(self, reads):
        """The flat route's extension shapes for a chunk: (LQ, LT_max,
        LT buckets) of its longest read (JAX engine.py:201-211)."""
        max_rl = max((len(r.seq_nt4) for r in reads), default=0)
        if max_rl <= self._ext_lq:
            return self._ext_lq, self._ext_lt, self.lt_buckets
        if max_rl <= 256:
            return 256, self.lt_buckets_long[-1], self.lt_buckets_long
        return 512, self.lt_buckets_xl[-1], self.lt_buckets_xl

    def chain_batch(self, opt, reads, traces=None, trace_seeds=False):
        """Device seeding + SA, native chaining, for a chunk; returns a
        ChainBatch whose `.flat` covers every read in order.  The chunk
        seeds in the smallest bucket that holds its longest read of at
        most dev_max_len bp; longer reads chain on the host oracle and
        are spliced in.  With `traces` (one TraceLog per read) it returns
        per-read Chain lists instead, and `trace_seeds` writes the -v 5
        seed dump (bwamem.c:478-479): every seed of a read in array
        order, the ones bridging the forward-reverse boundary included,
        which the native chainer then drops (native/chain.cpp:78)."""
        from bwamem_tpu_torch.core.chain import mem_chain
        from bwamem_tpu_torch.core.pipeline import encode_read
        for r in reads:
            encode_read(r)
        lens = [len(r.seq_nt4) for r in reads]
        seeder = self._seeder_for(max(
            (n for n in lens if n <= self.dev_max_len), default=0))
        dev_idx = [i for i, n in enumerate(lens)
                   if opt.min_seed_len <= n <= seeder.L]
        host_idx = [i for i, n in enumerate(lens) if n > seeder.L]
        if dev_idx:
            self._count(f"chunks_L{seeder.L}")
        if host_idx:
            self._count("host_routed_reads", len(host_idx))
        l_pac = self.fm_host.seq_len >> 1
        c_off = np.zeros(1, np.int64)
        sd_off = np.zeros(1, np.int64)
        o_rb = np.zeros(0, np.int64)
        o_qb = np.zeros(0, np.int32)
        o_ln = np.zeros(0, np.int32)
        if dev_idx:
            queries = [reads[i].seq_nt4 for i in dev_idx]
            iv = seeder.interval_arrays(opt, queries)
            rid, s_rb, s_qb, s_ln = seeder.seeds_from_arrays(
                self.fm_host, iv, opt)
            if trace_seeds and traces is not None:
                for r, rb, qb, ln in zip(rid.tolist(), s_rb.tolist(),
                                         s_qb.tolist(), s_ln.tolist()):
                    traces[dev_idx[r]].append(
                        "* Found SEED: length=%d,query_beg=%d,ref_beg=%d\n"
                        % (ln, qb, rb))
            counts = (np.bincount(rid, minlength=len(dev_idx)) if len(rid)
                      else np.zeros(len(dev_idx), np.int64))
            read_off = np.zeros(len(dev_idx) + 1, dtype=np.int64)
            np.cumsum(counts, out=read_off[1:])
            out = nfinalize.chain_batch_native(
                l_pac, opt.w, opt.max_chain_gap, len(dev_idx), read_off,
                s_rb, s_qb, s_ln)
            if out is None:
                raise RuntimeError("native chaining failed")
            c_off, sd_off, o_rb, o_qb, o_ln = out
        if traces is not None:
            chains = [[] for _ in reads]
            for bi, lst in enumerate(_chains_from_flat(
                    (c_off, sd_off, o_rb, o_qb, o_ln), len(dev_idx))):
                chains[dev_idx[bi]] = lst
            for i in host_idx:
                chains[i] = mem_chain(opt, self.fm_host, l_pac,
                                      reads[i].seq_nt4,
                                      traces[i] if trace_seeds else None)
            return chains
        n_chains = np.zeros(len(reads), np.int64)
        n_chains[np.asarray(dev_idx, np.int64)] = np.diff(c_off)
        if not host_idx:
            chain_off = np.zeros(len(reads) + 1, np.int64)
            np.cumsum(n_chains, out=chain_off[1:])
            return ChainBatch((chain_off, sd_off, o_rb, o_qb, o_ln))
        # mixed chunk: splice the host reads' chains in global read order
        hch = {i: mem_chain(opt, self.fm_host, l_pac, reads[i].seq_nt4)
               for i in host_idx}
        dev_pos = {i: bi for bi, i in enumerate(dev_idx)}
        for i, lst in hch.items():
            n_chains[i] = len(lst)
        chain_off = np.zeros(len(reads) + 1, np.int64)
        np.cumsum(n_chains, out=chain_off[1:])
        seed_cnt, rb_p, qb_p, ln_p = [], [], [], []
        sd_cnt_dev = np.diff(sd_off)
        for i in range(len(reads)):
            bi = dev_pos.get(i)
            if bi is not None:
                c0, c1 = int(c_off[bi]), int(c_off[bi + 1])
                if c1 > c0:
                    seed_cnt.append(sd_cnt_dev[c0:c1])
                    lo, hi = int(sd_off[c0]), int(sd_off[c1])
                    rb_p.append(o_rb[lo:hi])
                    qb_p.append(o_qb[lo:hi])
                    ln_p.append(o_ln[lo:hi])
            else:
                for c in hch.get(i, ()):
                    seed_cnt.append(np.asarray([c.n], np.int64))
                    rb_p.append(np.asarray([s[0] for s in c.seeds],
                                           o_rb.dtype))
                    qb_p.append(np.asarray([s[1] for s in c.seeds],
                                           o_qb.dtype))
                    ln_p.append(np.asarray([s[2] for s in c.seeds],
                                           o_ln.dtype))
        sd_off_full = np.zeros(int(chain_off[-1]) + 1, np.int64)
        if seed_cnt:
            np.cumsum(np.concatenate(seed_cnt), out=sd_off_full[1:])
        cat = lambda p, a: np.concatenate(p) if p else a[:0]  # noqa: E731
        return ChainBatch((chain_off, sd_off_full, cat(rb_p, o_rb),
                           cat(qb_p, o_qb), cat(ln_p, o_ln)))

    def align_batch(self, opt, fm, bns, pac, reads, traces=None,
                    trace_seeds=False, chains=None):
        """Regions for a chunk: seeding and chaining (or the prefetched
        result of prefetch_batch), then the flat route (the extension
        kernel over every seed, native region building), or, with traces
        or for a seed-rich chunk, the generators of align1_core_gen
        through drive_waves (JAX engine.py:419-438)."""
        from bwamem_tpu_torch.core.pipeline import align1_core_gen
        prefetched = isinstance(chains, tuple)
        packed = None
        if prefetched:                     # prefetch_batch output
            chains, packed = chains
        if chains is None:
            chains = self.chain_batch(opt, reads, traces=traces,
                                      trace_seeds=trace_seeds)
        if isinstance(chains, ChainBatch):
            if not prefetched:
                packed = self._pack_and_dispatch(opt, bns, pac, reads,
                                                 chains.flat)
            if packed is not None:
                return self._collect_and_regions(opt, bns, pac, reads,
                                                 chains.flat, *packed)
            chains = _chains_from_flat(chains.flat, len(reads))
        gens = [align1_core_gen(
                    opt, fm, bns, pac, r, chains=chains[i],
                    trace=traces[i] if traces is not None else None)
                for i, r in enumerate(reads)]
        return self.drive_waves(opt, gens)

    def _pack_and_dispatch(self, opt, bns, pac, reads, flat):
        """Native pack of every seed's extension (oversize lanes served
        by the native scalar twin) and the extension kernel launches in
        WAVE_EXT lane groups, size-sorted and LT-bucketed, at the chunk's
        extension shapes.  With BWAMEM_TPU_ONCHIP_EXT=1 (or ``force``)
        the rows are built on the device (ops/extbuild.py): the chunk's
        reads go up once and each group uploads its per-seed scalars
        only.  Returns (pk, pend), or None for a chunk with more than 16
        seeds per read: most of those seeds are never extended (the chain
        filter and the containment test drop them), so such a chunk takes
        the generator path, which extends only what the serial logic asks
        for (engine.py:449-451)."""
        n_seeds = len(flat[2])
        if n_seeds > 16 * max(len(reads), 1):
            self._count("seed_rich_chunks")
            return None
        LQ, LT_max, lt_buckets = self._ext_shapes(reads)
        pk = nfinalize.pack_extlr_native(opt, bns.l_pac, pac, reads, flat,
                                         LQ, LT_max)
        if pk is None:
            raise RuntimeError("native extension packing unavailable")
        n_host = int(np.count_nonzero(pk["served"]))
        if n_host:
            self._count("ext_host_lanes", n_host)
        dev = np.nonzero(pk["served"] == 0)[0]
        order = dev[np.argsort(pk["lt_need"][dev], kind="stable")]
        mat = self._mat_dev(opt)
        B = self.wave_ext
        gap = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w,
               opt.pen_clip5, opt.pen_clip3, opt.zdrop)
        # the row builder stays off under a mesh (engine.py:468); it
        # takes its lanes on the device, the kernels on the host
        onchip = (os.environ.get("BWAMEM_TPU_ONCHIP_EXT", "0")
                  in ("1", "force") and self.mesh is None)
        to_dev = ((lambda a: torch.from_numpy(a).to(self.device))
                  if onchip else torch.from_numpy)
        if onchip and len(order):
            # the reads up to the longest one a device lane extends go up
            # once per chunk; each group then uploads its scalars only
            reads_q = to_dev(reads_matrix([r.seq_nt4 for r in reads],
                                          int(pk["lqv"][order].max())))
            pac_d = self._pac_dev(pac, bns.l_pac)
            rid = nfinalize.seed_read_ids(flat, len(reads))
            rmax1 = pk["srb"] + pk["slv"] + pk["rlt"]
        pend = []
        for lo in range(0, len(order), B):
            grp = order[lo:lo + B]
            g = len(grp)
            LT = next(b for b in lt_buckets
                      if b >= int(pk["lt_need"][grp].max()))

            def rows(key, width):
                buf = np.full((B, width >> 1), 0x44, np.int8)
                buf[:g] = pk[key][grp][:, :width >> 1]
                return to_dev(buf)

            def scal(a, dt, fill=0):
                out = np.full(B, fill, dt)
                out[:g] = (pk[a] if isinstance(a, str) else a)[grp]
                return to_dev(out)

            common = (scal("llq", np.int32), scal("llt", np.int32),
                      scal("rlq", np.int32), scal("rlt", np.int32))
            if onchip:
                dev_out = extend_lr_onchip(
                    reads_q, pac_d, bns.l_pac, scal(rid, np.int32),
                    scal("sqb", np.int32), scal("slv", np.int32),
                    scal("srb", np.int64), scal("rmax0", np.int64),
                    scal(rmax1, np.int64), scal("lqv", np.int32, fill=1),
                    *common, scal("scs", np.int32), mat, *gap, LQ=LQ,
                    LT=LT)
            else:
                llq, llt, rlq, rlt = common
                dev_out = self.kernels.extend_lr(
                    rows("lq_pk", LQ), rows("lt_pk", LT), llq, llt,
                    rows("rq_pk", LQ), rows("rt_pk", LT), rlq, rlt, mat,
                    *gap, scal("scs", np.int32), scal("sqb", np.int32),
                    scal("srb", np.int64), scal("rmax0", np.int64),
                    scal("lqv", np.int32, fill=1), scal("slv", np.int32),
                    LQ=LQ, LT=LT)
            pend.append((grp, dev_out))
        return pk, pend

    def _pac_dev(self, pac, l_pac: int) -> torch.Tensor:
        """The index's pac on the device, uploaded once per index (keyed
        by the array itself, JAX engine.py:544-552)."""
        if self._pac is None or self._pac[0] is not pac \
                or self._pac[1] != l_pac:
            self._pac = (pac, l_pac, pac_tensor(pac).to(self.device))
        return self._pac[2]

    def _collect_and_regions(self, opt, bns, pac, reads, flat, pk, pend):
        """Fetch the extension groups and build regions natively; with
        BWAMEM_TPU_VERIFY set, also run the native scalar twin of every
        seed and report device==software."""
        res_keys = ("r_score", "r_truesc", "r_qb", "r_rb", "r_qe", "r_re",
                    "r_aw0", "r_aw1")
        for grp, dev_out in pend:
            res = self._timed(lambda d=dev_out: [t.cpu().numpy() for t in d],
                              _tag="extend_lr")
            g = len(grp)
            for key, arr in zip(res_keys, res):
                pk[key][grp] = arr[:g]
        if os.environ.get("BWAMEM_TPU_VERIFY"):
            LQ, LT_max, _ = self._ext_shapes(reads)
            ref = nfinalize.pack_extlr_native(
                opt, bns.l_pac, pac, reads, flat, LQ, LT_max,
                force_scalar=True)
            n_bad = sum(int((pk[k] != ref[k]).sum()) for k in res_keys)
            if n_bad:
                sys.stderr.write(
                    "[E::verify] device/software extension mismatch in "
                    "%d fields over %d seeds\n" % (n_bad, len(pk["r_score"])))
            else:
                sys.stderr.write(
                    "[M::verify] extension wave verified: %d seeds "
                    "device==software\n" % len(pk["r_score"]))
        regs = nfinalize.regions_batch_native_flat(
            opt, bns.l_pac, pac, reads, flat,
            tuple(pk[k] for k in res_keys), as_flat=True)
        if regs is None:
            raise RuntimeError("native region building failed")
        return regs

    def prefetch_batch(self, opt, bns, pac, reads):
        """The pipelined stage for chunk k+1: seeding, chaining and the
        extension launches, so the device work of the next chunk
        overlaps this chunk's host finalize.  align_batch unpacks the
        result; for a seed-rich chunk it is (chains, None)."""
        chains = self.chain_batch(opt, reads)
        return chains, self._pack_and_dispatch(opt, bns, pac, reads,
                                               chains.flat)

    def warm_shapes(self, opt):
        """Build the kernels and run every fixed launch shape once on
        empty lanes (each extension LT bucket, the extend2 and global2
        waves), so no build lands inside a served chunk."""
        B, LQ = self.wave_ext, self._ext_lq
        dev = torch.device("cpu")   # lanes go to the kernels on the host
        mat = self._mat_dev(opt)
        gap = (opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)

        def rows(b, width):
            return torch.full((b, width // 2), 0x44, dtype=torch.int8,
                              device=dev)

        def lanes(b, dt=torch.int32):
            return torch.zeros(b, dtype=dt, device=dev)
        outs = []
        zi, z6 = lanes(B), lanes(B, torch.int64)
        for LT in self.lt_buckets:
            zq, zt = rows(B, LQ), rows(B, LT)
            outs.append(self.kernels.extend_lr(
                zq, zt, zi, zi, zq, zt, zi, zi, mat, *gap, opt.w,
                opt.pen_clip5, opt.pen_clip3, opt.zdrop, zi, zi, z6, z6,
                zi + 1, zi, LQ=LQ, LT=LT))
        zi = lanes(self.wave)
        outs.append(self.kernels.extend2(
            rows(self.wave, LQ), rows(self.wave, self._ext_lt), zi, zi, mat,
            *gap, zi + 1, zi, opt.zdrop, zi, LQ=LQ, LT=self._ext_lt))
        zi = lanes(self.wave_glo)
        outs.append(self.kernels.global2(
            rows(self.wave_glo, self._glo_lq),
            rows(self.wave_glo, self._glo_lt), zi + 1, zi, mat, *gap,
            zi + 1, LQ=self._glo_lq, LT=self._glo_lt))
        for o in outs:
            o[0].cpu()

    def drive_waves(self, opt, gens) -> List:
        """Advance every generator in lock-step (JAX engine.py:730-800):
        each round gathers the live requests and serves each type with
        batched launches; a round with fewer than MIN_WAVE requests goes
        to the scalar oracle.  Returns each generator's return value."""
        from bwamem_tpu_torch.core.swdrive import serve_host
        results: List = [None] * len(gens)
        live = {}

        def advance(i, out):
            try:
                live[i] = gens[i].send(out)
            except StopIteration as e:
                results[i] = e.value

        serve = {"extend2": self._extend_wave,
                 "extend_lr": self._extend_lr_wave,
                 "global2": self._global_wave,
                 "align2": self._align2_wave}
        for i in range(len(gens)):
            advance(i, None)
        while live:
            order = list(live)
            reqs = [live[i] for i in order]
            live = {}
            self._count("wave_rounds")
            outs = [None] * len(reqs)
            if len(reqs) < self.min_wave:
                self._count("wave_host_tail", len(reqs))
                outs = [serve_host(r, opt) for r in reqs]
            else:
                by_type = {}
                for j, r in enumerate(reqs):
                    by_type.setdefault(r[0], []).append(j)
                for tag, js in by_type.items():
                    if tag not in serve:
                        raise ValueError(f"unknown SW request {tag!r}")
                    for j, out in zip(js, serve[tag](
                            opt, [reqs[j] for j in js])):
                        outs[j] = out
            for i, out in zip(order, outs):
                advance(i, out)
        return results

    def _host_lanes(self, opt, reqs, fits, tag, outs):
        """Serve the requests that do not fit the kernel's shapes on the
        scalar oracle, counted; returns the indices of those that do."""
        from bwamem_tpu_torch.core.swdrive import serve_host
        dev_idx = []
        for i, r in enumerate(reqs):
            if fits(r):
                dev_idx.append(i)
            else:
                outs[i] = serve_host(r, opt)
        if len(dev_idx) < len(reqs):
            self._count("wave_host_oversize_" + tag,
                        len(reqs) - len(dev_idx))
        return dev_idx

    def _fetch_groups(self, pend, tag, outs):
        """Fetch each launched group and hand every lane its tuple."""
        for grp, dev_out in pend:
            res = self._timed(lambda d=dev_out: [t.cpu().numpy() for t in d],
                              _tag=tag)
            cols = [r.tolist() for r in res]
            for bi, i in enumerate(grp):
                outs[i] = tuple(c[bi] for c in cols)

    def _extend_wave(self, opt, reqs):
        """ksw_extend2 over ("extend2", qs, rs, w, end_bonus, h0)
        requests, in groups of WAVE lanes (engine.py:830)."""
        LQ, LT = self._ext_lq, self._ext_lt
        outs = [None] * len(reqs)
        dev_idx = self._host_lanes(
            opt, reqs, lambda r: len(r[1]) <= LQ and len(r[2]) <= LT,
            "extend2", outs)
        pend = []   # launch every group before fetching any
        for lo in range(0, len(dev_idx), self.wave):
            grp = dev_idx[lo:lo + self.wave]
            B = len(grp)
            qb = np.full((B, LQ), 4, np.int8)
            tb = np.full((B, LT), 4, np.int8)
            sc = np.zeros((5, B), np.int32)   # qlen, tlen, w, bonus, h0
            for bi, i in enumerate(grp):
                _, qs, rs, w, pen, h0 = reqs[i]
                qb[bi, :len(qs)] = qs
                tb[bi, :len(rs)] = rs
                sc[:, bi] = (len(qs), len(rs), w, pen, h0)
            pend.append((grp, self.kernels.extend2(
                _pack4(qb), _pack4(tb), sc[0], sc[1],
                self._mat_dev(opt), opt.o_del, opt.e_del, opt.o_ins,
                opt.e_ins, sc[2], sc[3], opt.zdrop, sc[4],
                LQ=LQ, LT=LT)))
        self._fetch_groups(pend, "extend2", outs)
        return outs

    def _extend_lr_wave(self, opt, reqs):
        """The fused left+right extension over ("extend_lr", qs, rs, qrt,
        rrt, sc_seed, s_qbeg, s_rbeg, rmax0, l_query, s_len) requests
        (engine.py:885): lanes size-sorted, groups of WAVE_EXT, each at
        the smallest LT bucket that holds it."""
        LQ, LT_max = self._ext_lq, self._ext_lt
        outs = [None] * len(reqs)
        dev_idx = self._host_lanes(
            opt, reqs, lambda r: (len(r[1]) <= LQ and len(r[2]) <= LT_max
                                  and len(r[3]) <= LQ
                                  and len(r[4]) <= LT_max),
            "extend_lr", outs)
        dev_idx.sort(key=lambda i: max(len(reqs[i][2]), len(reqs[i][4])))
        pend = []
        for lo in range(0, len(dev_idx), self.wave_ext):
            grp = dev_idx[lo:lo + self.wave_ext]
            B = len(grp)
            LT = next(b for b in self.lt_buckets if b >= max(
                max(len(reqs[i][2]), len(reqs[i][4])) for i in grp))
            lqb = np.full((B, LQ), 4, np.int8)
            ltb = np.full((B, LT), 4, np.int8)
            rqb = np.full((B, LQ), 4, np.int8)
            rtb = np.full((B, LT), 4, np.int8)
            sc = np.zeros((8, B), np.int32)
            rb = np.zeros((2, B), np.int64)   # s_rbeg, rmax0
            for bi, i in enumerate(grp):
                (_, qs, rs, qrt, rrt, sc_seed, s_qbeg, s_rbeg, rmax0,
                 l_query, s_len) = reqs[i]
                lqb[bi, :len(qs)] = qs
                ltb[bi, :len(rs)] = rs
                rqb[bi, :len(qrt)] = qrt
                rtb[bi, :len(rrt)] = rrt
                sc[:, bi] = (len(qs), len(rs), len(qrt), len(rrt), sc_seed,
                             s_qbeg, l_query, s_len)
                rb[:, bi] = (s_rbeg, rmax0)
            pend.append((grp, self.kernels.extend_lr(
                _pack4(lqb), _pack4(ltb), sc[0], sc[1],
                _pack4(rqb), _pack4(rtb), sc[2], sc[3],
                self._mat_dev(opt), opt.o_del, opt.e_del, opt.o_ins,
                opt.e_ins, opt.w, opt.pen_clip5, opt.pen_clip3, opt.zdrop,
                sc[4], sc[5], rb[0], rb[1], sc[6], sc[7],
                LQ=LQ, LT=LT)))
        self._fetch_groups(pend, "extend_lr", outs)
        return outs

    def _global_wave(self, opt, reqs):
        """ksw_global2 with the traceback on the device over ("global2",
        qs, rs, w) requests, in groups of WAVE_GLO lanes (engine.py:964);
        the host turns each traceback into its CIGAR."""
        LQ, LT = self._glo_lq, self._glo_lt
        outs = [None] * len(reqs)
        dev_idx = self._host_lanes(
            opt, reqs, lambda r: 0 < len(r[1]) <= LQ and 0 < len(r[2]) <= LT,
            "global2", outs)
        pend = []
        for lo in range(0, len(dev_idx), self.wave_glo):
            grp = dev_idx[lo:lo + self.wave_glo]
            B = len(grp)
            qb = np.full((B, LQ), 4, np.int8)
            tb = np.full((B, LT), 4, np.int8)
            sc = np.zeros((3, B), np.int32)   # qlen, tlen, w
            for bi, i in enumerate(grp):
                _, qs, rs, w = reqs[i]
                qb[bi, :len(qs)] = qs
                tb[bi, :len(rs)] = rs
                sc[:, bi] = (len(qs), len(rs), w)
            pend.append((grp, self.kernels.global2(
                _pack4(qb), _pack4(tb), sc[0], sc[1],
                self._mat_dev(opt), opt.o_del, opt.e_del, opt.o_ins,
                opt.e_ins, sc[2], LQ=LQ, LT=LT)))
        for grp, dev_out in pend:
            score, ops, n_ops, ri, rk = self._timed(
                lambda d=dev_out: [t.cpu().numpy() for t in d],
                _tag="global2")
            cigars = cigars_from_tracebacks(ops, n_ops, ri, rk,
                                            range(len(grp)))
            for bi, i in enumerate(grp):
                outs[i] = (int(score[bi]), cigars[bi])
        return outs

    def _align2_wave(self, opt, reqs):
        """Mate-rescue local SW over ("align2", qs, rs, xtra) requests, in
        groups of WAVE lanes (ops/ksw_align.py align2_wave)."""
        return align2_wave(opt, reqs, self.wave, self._mat_dev(opt),
                           timed=lambda fn: self._timed(fn, _tag="align2"),
                           count=self._count)
