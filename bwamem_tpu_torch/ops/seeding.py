"""Batched seeding: SMEM intervals and their SA-resolved seeds for a
chunk's reads, as flat arrays for the native chainer.

Port of bwamem_tpu/ops/seeding.py (BatchedSeeder.interval_arrays :418,
interval_streams :191 with _SliceRun :809, seed_positions :370,
seeds_from_arrays :620, _resolve_keys_device :729).  A seeder serves one
length bucket, L=128, 256 or 512: reads up to L bp, in fixed-width lane
groups.  By default each group is one fused superstep + SA-walk dispatch
(ops.smem.smem_superstep_sa) and one fetch.  The unfused route
(BWAMEM_TPU_GCAP_PER_LANE=0 or BWAMEM_TPU_FUSE_SA=0, and the list form
superstep_streams that the engine's Python chain route seeds from) is one
superstep launch a group, its per-lane streams fetched whole, and the
SA walk as launches of their own afterwards.  With
``BWAMEM_TPU_SUPERSTEP=0`` the iterator runs round by round instead,
one ops.smem.smem_iter_step launch and fetch per round, the ordered
merge and the bookkeeping between rounds on the host, and every seed's
SA value comes from the SA-walk kernel afterwards.  The fused call and
the SA walks of _resolve_keys_device go through ``kernels`` (the
engine's parallel.mesh.ShardedKernels: over a reads mesh, JAX
seeding.py:65-69, :183, :256, or over the engine's one device): each
shard of a lane group is a group of its own, with its own compact wire
(GCAP = GCAP_PER x its lanes, KEY_CAP split alike).  The round route's
iterator steps stay on the seeder's index, the mesh's first device, as
in the JAX engine.  Lanes that overflow
a device buffer re-run on the host oracle and are spliced back in place;
SA walks past the step cap and key expansions past KEY_CAP are resolved
the way the JAX engine resolves them, and each route is counted in the
engine's stats: ``ovf_smem_lanes`` (buffer overflows, the M_OUT and
pass-2 redos of the round route), ``smem_host_tail`` (reads of the round
route's straggler tail finished on the host), ``ovf_sa_keys`` and
``ovf_keyexp_groups``.
"""

import os
from collections import deque
from typing import List, Sequence, Tuple

import numpy as np
import torch

from bwamem_tpu_torch.config import MEM_F_NO_EXACT

from .fm import DeviceFmIndex
from .smem import smem_iter_step

Intv = Tuple[int, int, int, int]  # (x0, x1, s, info=qb<<32|qe)


def _merge(matches: List[Intv], sub: List[Intv], max_len: int,
           ori_start: int, qlen: int) -> List[Intv]:
    """Ordered merge of main and re-seeded matches
    (software/bwamem.c:206-238): keep sub-matches at least half the max
    length that end after the original start."""
    merged: List[Intv] = []
    i = j = 0
    while i < len(matches) and j < len(sub):
        pi, pj = matches[i], sub[j]
        xi = (pi[3] >> 32 << 32) | (qlen - (pi[3] & 0xFFFFFFFF))
        xj = (pj[3] >> 32 << 32) | (qlen - (pj[3] & 0xFFFFFFFF))
        if xi < xj:
            merged.append(pi)
            i += 1
        elif ((pj[3] & 0xFFFFFFFF) - (pj[3] >> 32) >= (max_len >> 1)
                and (pj[3] & 0xFFFFFFFF) > ori_start):
            merged.append(pj)
            j += 1
        else:
            j += 1
    merged.extend(matches[i:])
    for pj in sub[j:]:
        if ((pj[3] & 0xFFFFFFFF) - (pj[3] >> 32) >= (max_len >> 1)
                and (pj[3] & 0xFFFFFFFF) > ori_start):
            merged.append(pj)
    return merged


def interval_buffer(seq_len: int) -> int:
    """The SMEM iterator's interval buffer M for an index of seq_len
    doubled bases, where BWAMEM_TPU_SMEM_M does not set it.  A forward
    extension pushes about log4(seq_len) + 1 intervals before its size
    reaches one, and a lane whose buffer overflows redoes its read on the
    host oracle.  On the H100, 16 entries: no overflow at 4.64 Mbp;
    0.05% of 101 bp reads over at 64 Mbp, 0.85% at 128 Mbp, 2.55% at
    256 Mbp (half the reads/s of 32 entries) and 46% at 1.1 Gbp.  32
    entries cost the superstep ~1.3x (1.30 against 0.98 ms at 64 Mbp),
    yet were ahead end to end in every SE and PE bench at 64 and 128
    Mbp.  So the switch sits between 4.64 and 64 Mbp, where log4 puts
    the overflow's onset: 32 from 2^26 doubled bases (33.5 Mbp)."""
    return 16 if seq_len < 1 << 26 else 32


class BatchedSeeder:
    """Per-read interval streams and seeds, computed by the device
    kernels in lane groups, for reads of up to L (128, 256 or 512) bp."""

    def __init__(self, dfm: DeviceFmIndex, fm_host, timer, kernels,
                 L: int = 128):
        env = os.environ.get
        if L not in (128, 256, 512):
            raise ValueError(f"the seeding buckets are L=128, 256 and 512, "
                             f"got {L}")
        self.dfm = dfm
        self.kernels = kernels      # the engine's ShardedKernels
        self.fm_host = fm_host      # host oracle for the overflow routes
        self.L = L                  # the seeding bucket: reads <= L bp
        # psi-walk step cap: the walk to a sampled row is ~geometric
        # with mean sa_intv; past the cap a key takes the host walk
        self.sa_max_steps = 1024
        self.timer = timer          # the engine: _timed / _count
        self.lanes = int(env("BWAMEM_TPU_LANES", "512"))
        self.sa_slice = int(env("BWAMEM_TPU_SA_SLICE", "16384"))
        self.M = int(env("BWAMEM_TPU_SMEM_M", "0")) \
            or interval_buffer(dfm.seq_len_int)
        # the round route's fetch width: steps with more SMEMs than
        # M_OUT redo on the host oracle
        self.m_out = min(int(env("BWAMEM_TPU_SMEM_MOUT", "12")), self.M)
        # below this many live reads a lane group's remaining rounds run
        # on the host oracle (the round route's straggler tail)
        self.min_seed_wave = int(env("BWAMEM_TPU_MIN_SEED_WAVE", "32"))
        # per-bucket stream caps (JAX seeding.py:90-92): 512 bp reads
        # emit about twice the intervals of the shorter buckets
        out_cap = int(env("BWAMEM_TPU_OUT_CAP", "48"))
        gcap_per = int(env("BWAMEM_TPU_GCAP_PER_LANE", "12"))
        self.out_cap = out_cap if L <= 256 else max(out_cap, 64)
        self.gcap_per = gcap_per if L <= 256 else 2 * gcap_per
        self.key_cap = int(env("BWAMEM_TPU_KEY_CAP", str(8 * self.lanes)))
        # the fused launch needs the compact wire (JAX seeding.py:47-51,
        # :432-433): GCAP_PER_LANE=0 or FUSE_SA=0 take the unfused route
        self.fuse = (env("BWAMEM_TPU_FUSE_SA", "1") != "0"
                     and self.gcap_per > 0)
        self._sa_prefetch = None

    def _fetch(self, tensors, tag: str):
        """One dispatch's results to host numpy arrays (None stays None),
        timed."""
        return self.timer._timed(
            lambda: [None if t is None else t.cpu().numpy()
                     for t in tensors], _tag=tag)

    def _oracle_finish(self, opt, query, start: int, start_width: int,
                       split_len: int, split_width: int, out: list) -> None:
        """Run the iterator to exhaustion for one read on the host
        oracle (identical results to the device path)."""
        qlen = len(query)
        while start < qlen:
            while start < qlen and query[start] > 3:
                start += 1
            if start >= qlen:
                break
            start, matches = self._oracle_step(
                opt, query, start, start_width, split_len, split_width)
            out.extend(matches)

    def _oracle_step(self, opt, query, x: int, start_width: int,
                     split_len: int, split_width: int):
        """One iterator step on the host oracle (pass 1 + split + pass 2
        + merge) for a lane that overflowed the device buffers."""
        from bwamem_tpu_torch.oracle.smem import smem1
        oret, matches = smem1(self.fm_host, query, x, start_width)
        if not matches:
            return oret, matches
        best_len, best = 0, 0
        for j, p in enumerate(matches):
            ln = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
            if best_len < ln:
                best_len, best = ln, j
        pm = matches[best]
        if (split_len > 0 and best_len >= split_len
                and pm[2] <= split_width):
            _, sub = smem1(self.fm_host, query,
                           ((pm[3] >> 32) + (pm[3] & 0xFFFFFFFF)) >> 1,
                           pm[2] + 1)
            matches = _merge(matches, sub, best_len, x, len(query))
        return oret, matches

    def _lane_group(self, opt, grp):
        """A lane group's packed queries [lanes, L/2], lengths, split
        lengths and active flags (numpy)."""
        B = self.lanes
        sl_init = int(opt.min_seed_len * opt.split_factor + .499)
        qpad = np.full((B, self.L), 4, dtype=np.int8)
        qlen = np.zeros(B, dtype=np.int32)
        slens = np.zeros(B, dtype=np.int32)
        for i, qq in enumerate(grp):
            qlen[i] = len(qq)
            qpad[i, :len(qq)] = qq
            slens[i] = min(sl_init, len(qq))
        active = np.zeros(B, dtype=np.uint8)
        active[:len(grp)] = 1
        qpk = qpad[:, 0::2] | (qpad[:, 1::2] << np.int8(4))
        return qpk, qlen, slens, active

    def superstep_streams(self, opt, queries: Sequence[np.ndarray]
                          ) -> List[List[Intv]]:
        """Per read, the concatenated interval lists (x0, x1, s,
        qb<<32|qe) of every iterator call, in call order (the stream
        mem_chain consumes), from one superstep launch per lane group
        (_unfused_arrays; JAX seeding.py _streams_superstep :232); x1 is
        0, the superstep does not keep it."""
        x0, sz, qb, qe, read_off = self._unfused_arrays(opt, queries)
        items = list(zip(x0.tolist(), [0] * len(x0), sz.tolist(),
                         ((qb << 32) | qe).tolist()))
        off = read_off.tolist()
        return [items[off[i]:off[i + 1]] for i in range(len(queries))]

    def interval_streams(self, opt, queries: Sequence[np.ndarray],
                         need_x1: bool = True) -> List[List[Intv]]:
        """The round route (BWAMEM_TPU_SUPERSTEP=0, JAX seeding.py:191-230
        and _SliceRun :809-943): per read, the concatenated interval
        lists (x0, x1, s, qb<<32|qe) of every iterator call, in call
        order.  Each round of a lane group is one smem_iter_step launch
        and one fetch; every group's first round is launched before any
        is fetched, and a group's next round is launched as soon as the
        previous one is processed.  need_x1=False leaves x1 0 and does
        not fetch it."""
        states = [_SliceRun(self, opt, queries[lo:lo + self.lanes])
                  for lo in range(0, len(queries), self.lanes)]
        pending = deque()
        for st in states:
            if st.advance():
                pending.append((st, st.dispatch()))
        while pending:
            st, res = pending.popleft()
            if not need_x1:       # m1 and s1: the pass-1 and pass-2 x1
                res = [None if k in (3, 12) else t
                       for k, t in enumerate(res)]
            st.process(self._fetch(res, "smem"))
            if st.advance():
                pending.append((st, st.dispatch()))
        out: List[List[Intv]] = []
        for st in states:
            out.extend(st.out)
        return out

    def _splice_oracle(self, opt, grp, n_l, over_l, cols):
        """Splice the host oracle's streams into the overflow lanes of a
        fetched group, in place of their empty device segments.  cols are
        the group's flat (x0, s, qb, qe) int64 arrays in lane order, n_l
        the lanes' counts (0 for the over_l lanes); returns the new cols,
        the counts and each interval's device mark (False: spliced)."""
        start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
        sl_init = int(opt.min_seed_len * opt.split_factor + .499)
        dev_mark = np.ones(len(cols[0]), bool)
        if not over_l.any():
            return cols, n_l, dev_mark
        cut = np.cumsum(n_l)[:-1]
        parts = [np.split(a, cut) for a in (*cols, dev_mark)]
        self.timer._count("ovf_smem_lanes", int(over_l.sum()))
        for i in np.nonzero(over_l)[0]:
            lst: List[Intv] = []
            self._oracle_finish(opt, grp[i], 0, start_width,
                                min(sl_init, len(grp[i])), opt.split_width,
                                lst)
            for part, vals in zip(parts, (
                    [p[0] for p in lst], [p[2] for p in lst],
                    [p[3] >> 32 for p in lst],
                    [p[3] & 0xFFFFFFFF for p in lst])):
                part[i] = np.asarray(vals, np.int64)
            parts[4][i] = np.zeros(len(lst), bool)
            n_l[i] = len(lst)
        joined = [np.concatenate(p) for p in parts]
        return joined[:4], n_l, joined[4]

    def _unfused_arrays(self, opt, queries: Sequence[np.ndarray]):
        """The unfused route (JAX seeding.py:489-495, :523-537): one
        superstep launch per lane group, its per-lane streams of OUT_CAP
        slots fetched whole and flattened on the host, lane by lane.
        Returns (x0, size, qb, qe) int64 arrays and read_off."""
        start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
        B = self.lanes
        pend = []
        for lo in range(0, len(queries), B):
            grp = queries[lo:lo + B]
            qpk, qlen, slens, active = self._lane_group(opt, grp)
            pend.append((grp, self.kernels.superstep_unfused(
                qpk, qlen, np.full(B, start_width, np.int64), active, slens,
                np.full(B, opt.split_width, np.int32), L=self.L, M=self.M,
                OUT_CAP=self.out_cap)))
        cols_all, cnts = [], []
        for grp, res in pend:
            o0, os_, oqb, oqe, n_out, over = self._fetch(res, "smem")
            ng = len(grp)
            over_l = over[:ng].astype(bool)
            n_l = np.where(over_l, 0, n_out[:ng]).astype(np.int64)
            mask = np.arange(o0.shape[1])[None, :] < n_l[:, None]
            cols = [a[:ng][mask].astype(np.int64)
                    for a in (o0, os_, oqb, oqe)]
            cols, n_l, _ = self._splice_oracle(opt, grp, n_l, over_l, cols)
            cols_all.append(cols)
            cnts.append(n_l)
        x0, sz, qb, qe = (np.concatenate([c[k] for c in cols_all])
                          if cols_all else np.zeros(0, np.int64)
                          for k in range(4))
        read_off = np.zeros(len(queries) + 1, dtype=np.int64)
        if cnts:
            np.cumsum(np.concatenate(cnts), out=read_off[1:])
        return x0, sz, qb, qe, read_off

    def interval_arrays(self, opt, queries: Sequence[np.ndarray]):
        """Per-interval (x0, size, qb, qe) int64 arrays + read_off, in
        the exact per-read stream order of the host iterator.  On the
        fused route (the superstep, the compaction, the key expansion and
        the SA walk in one call a lane group) the SA values of the
        device-covered intervals are kept for seeds_from_arrays.  The
        unfused route (BWAMEM_TPU_GCAP_PER_LANE=0 or BWAMEM_TPU_FUSE_SA=0,
        _unfused_arrays) and the round route (BWAMEM_TPU_SUPERSTEP=0,
        which flattens interval_streams) leave every key to the SA-walk
        kernel."""
        if os.environ.get("BWAMEM_TPU_SUPERSTEP", "1") == "0":
            self._sa_prefetch = None
            streams = self.interval_streams(opt, queries, need_x1=False)
            counts = np.asarray([len(st) for st in streams], np.int64)
            read_off = np.zeros(len(queries) + 1, dtype=np.int64)
            np.cumsum(counts, out=read_off[1:])
            flat = [p for st in streams for p in st]
            x0 = np.asarray([p[0] for p in flat], np.int64)
            sz = np.asarray([p[2] for p in flat], np.int64)
            info = np.asarray([p[3] for p in flat], np.int64)
            return x0, sz, info >> 32, info & 0xFFFFFFFF, read_off
        if not self.fuse:
            self._sa_prefetch = None
            return self._unfused_arrays(opt, queries)
        start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
        B = self.lanes
        gcap = self.gcap_per * B
        n = self.kernels.n
        pend = []
        for lo in range(0, len(queries), B):
            grp = queries[lo:lo + B]
            qpk, qlen, slens, active = self._lane_group(opt, grp)
            outs = self.kernels.superstep(
                qpk, qlen, np.full(B, start_width, np.int64), active, slens,
                np.full(B, opt.split_width, np.int32),
                int(opt.min_seed_len), int(opt.max_occ), L=self.L, M=self.M,
                OUT_CAP=self.out_cap, GCAP=gcap // n,
                KEY_CAP=self.key_cap // n, SA_STEPS=self.sa_max_steps)
            pend += [(grp[a:b], res) for (a, b), res in outs]
        xs, szs, qbs, qes, cnts, dms = [], [], [], [], [], []
        sa_vals, sa_over, sa_ok = [], [], True
        for grp, res in pend:
            (gx, gs, gqb, gqe, n_out, over, g_vals, g_over, g_nk,
             g_kovf) = self._fetch(res, "smem")
            ng = len(grp)
            n_l = n_out[:ng].astype(np.int64)
            over_l = over[:ng].astype(bool)
            tot = int(n_out.astype(np.int64).sum())
            assert tot == int(n_l.sum())
            gx = gx[:tot].astype(np.int64)
            gs = gs[:tot].astype(np.int64)
            gqb = gqb[:tot].astype(np.int64)
            gqe = gqe[:tot].astype(np.int64)
            # the key expansion covers exactly the clean lanes' streams
            # (overflow lanes have n_out 0), which survive the oracle
            # splice unchanged; spliced intervals resolve freshly
            if bool(g_kovf):
                sa_ok = False
                self.timer._count("ovf_keyexp_groups")
            else:
                nk = int(g_nk)
                sa_vals.append(g_vals[:nk])
                sa_over.append(g_over[:nk].astype(bool))
            (gx, gs, gqb, gqe), n_l, dev_mark = self._splice_oracle(
                opt, grp, n_l, over_l, [gx, gs, gqb, gqe])
            xs.append(gx)
            szs.append(gs)
            qbs.append(gqb)
            qes.append(gqe)
            cnts.append(n_l)
            dms.append(dev_mark)
        cat = lambda a, dt: (np.concatenate(a) if a  # noqa: E731
                             else np.zeros(0, dt))
        x0, sz = cat(xs, np.int64), cat(szs, np.int64)
        qb, qe = cat(qbs, np.int64), cat(qes, np.int64)
        counts = cat(cnts, np.int64)
        read_off = np.zeros(len(queries) + 1, dtype=np.int64)
        np.cumsum(counts, out=read_off[1:])
        iv = (x0, sz, qb, qe, read_off)
        if sa_ok:
            # the pairing token pins the iv this prefetch belongs to
            # (object identity) and the filter parameters baked into the
            # dispatch; dev_mark flags the device-covered intervals
            self._sa_prefetch = (
                cat(sa_vals, np.int64), cat(sa_over, bool),
                (read_off, float(opt.min_seed_len), float(opt.max_occ)),
                cat(dms, bool))
        else:
            self._sa_prefetch = None
        return iv

    def seeds_from_arrays(self, fm_host, iv, opt):
        """(read_ids, rbeg, qbeg, len) flat seed arrays in the exact
        (read, interval, occurrence) order, from interval_arrays
        output."""
        x0, sz, qb, qe, read_off = iv
        n_reads = len(read_off) - 1
        slen = qe - qb
        keep = (slen >= opt.min_seed_len) & (sz <= opt.max_occ)
        iv_read = np.repeat(np.arange(n_reads, dtype=np.int32),
                            np.diff(read_off))
        x0k, szk = x0[keep], sz[keep]
        qbk, slk = qb[keep], slen[keep]
        rdk = iv_read[keep]
        total = int(szk.sum())
        if total == 0:
            z32 = np.zeros(0, np.int32)
            self._sa_prefetch = None
            return z32, np.zeros(0, np.int64), z32, z32
        base = np.repeat(x0k, szk)
        excl = np.concatenate([[0], np.cumsum(szk)[:-1]])
        keys = base + np.arange(total, dtype=np.int64) - np.repeat(excl,
                                                                   szk)
        pre = self._sa_prefetch
        self._sa_prefetch = None
        if pre is not None and (
                pre[2][0] is not read_off
                or pre[2][1] != float(opt.min_seed_len)
                or pre[2][2] != float(opt.max_occ)):
            pre = None  # prefetch was for a different iv/opt
        if pre is not None:
            dm = pre[3][keep]
            if int(szk[dm].sum()) != len(pre[0]):
                pre = None  # layout mismatch: resolve the split way
        if pre is not None:
            vals = np.empty(total, dtype=np.int64)
            over = np.zeros(total, dtype=bool)
            sel = np.repeat(dm, szk)  # per occurrence, output order
            vals[sel] = pre[0]
            over[sel] = pre[1]
            n_fresh = int((~sel).sum())
            if n_fresh:
                fkeys = keys[~sel]
                from bwamem_tpu_torch.oracle import nsmem
                # few keys: one native host walk beats a padded device
                # dispatch
                fv = (nsmem.sa_lookup_batch_native(fm_host, fkeys)
                      if n_fresh <= 8192 and nsmem.available() else None)
                if fv is not None:
                    fo = np.zeros(n_fresh, bool)
                else:
                    fv, fo = self._resolve_keys_device(fkeys)
                vals[~sel] = fv
                over[~sel] = fo
        else:
            vals, over = self._resolve_keys_device(keys)
        n_ovf = int(np.count_nonzero(over))
        if n_ovf:
            self.timer._count("ovf_sa_keys", n_ovf)
        for idx in np.nonzero(over)[0]:  # walks past the step cap
            vals[idx] = fm_host.sa_lookup(int(keys[idx]))
        read_ids = np.repeat(rdk, szk).astype(np.int32)
        qbeg = np.repeat(qbk, szk).astype(np.int32)
        slen_a = np.repeat(slk, szk).astype(np.int32)
        return read_ids, vals, qbeg, slen_a

    def seed_positions(self, fm_host, intervals_per_read, opt
                       ) -> List[List[Tuple[int, int, int]]]:
        """Per read, the (rbeg, qbeg, len) seeds of its interval stream
        after the min_seed_len and max_occ filters, in (interval,
        occurrence) order (JAX seeding.py:370-416,
        software/bwamem.c:407-420); every occurrence's SA value from the
        SA-walk launches of _resolve_keys_device, walks past the step cap
        on the host."""
        keys: List[int] = []
        layout = []   # (read, qb, len, occurrences, first key)
        for i, intervals in enumerate(intervals_per_read):
            for p in intervals:
                slen = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
                if slen < opt.min_seed_len or p[2] > opt.max_occ:
                    continue
                layout.append((i, p[3] >> 32, slen, p[2], len(keys)))
                keys.extend(range(p[0], p[0] + p[2]))
        out: List[List[Tuple[int, int, int]]] = [
            [] for _ in intervals_per_read]
        if not keys:
            return out
        karr = np.asarray(keys, dtype=np.int64)
        vals, over = self._resolve_keys_device(karr)
        n_ovf = int(np.count_nonzero(over))
        if n_ovf:
            self.timer._count("ovf_sa_keys", n_ovf)
        for idx in np.nonzero(over)[0]:   # walks past the step cap
            vals[idx] = fm_host.sa_lookup(int(karr[idx]))
        vals_l = vals.tolist()
        for i, qb, slen, n_occ, off in layout:
            out[i].extend((v, qb, slen) for v in vals_l[off:off + n_occ])
        return out

    def _resolve_keys_device(self, keys: np.ndarray):
        """SA values of arbitrary keys through SA_SLICE-padded walks on
        the device; returns (vals int64, over bool)."""
        n = len(keys)
        vals = np.empty(n, dtype=np.int64)
        over = np.empty(n, dtype=bool)
        pend = []
        for lo in range(0, n, self.sa_slice):
            sl = keys[lo:lo + self.sa_slice]
            pad = np.zeros(self.sa_slice, dtype=np.int64)
            pad[:len(sl)] = sl
            pend.append((lo, len(sl),
                         self.kernels.sa_lookup(pad, self.sa_max_steps)))
        for lo, n_sl, res in pend:
            v, o = self._fetch(res, "sa")
            vals[lo:lo + n_sl] = v[:n_sl]
            over[lo:lo + n_sl] = o[:n_sl]
        return vals, over


def _lane_intervals(i: int, n: int, x0, x1, s, qb, qe) -> List[Intv]:
    """The first n intervals of lane i of a fetched pass (x1 None: 0)."""
    x1l = [0] * n if x1 is None else x1[i, :n].tolist()
    return [(a, b, c, (d << 32) | e) for a, b, c, d, e in zip(
        x0[i, :n].tolist(), x1l, s[i, :n].tolist(), qb[i, :n].tolist(),
        qe[i, :n].tolist())]


class _SliceRun:
    """Iterator state of one lane group on the round route (JAX
    seeding.py _SliceRun): advance() does the host bookkeeping between
    rounds (the ambiguous-base skip, the straggler tail), dispatch()
    launches one smem_iter_step, process() takes its fetched results
    (the M_OUT and pass-2 redos on the host oracle, the ordered merge)."""

    def __init__(self, seeder: BatchedSeeder, opt, queries):
        self.seeder = seeder
        self.opt = opt
        self.queries = queries
        self.start_width = 2 if (opt.flag & MEM_F_NO_EXACT) else 1
        qpk, qlen, slens, _ = seeder._lane_group(opt, queries)
        self.qlen = qlen
        self.split_lens = slens
        B = seeder.lanes
        self.start = np.zeros(B, dtype=np.int64)
        self.exhausted = np.zeros(B, dtype=bool)
        self.exhausted[len(queries):] = True
        self.out: List[List[Intv]] = [[] for _ in queries]
        # the loop-invariant arrays go up once
        dev = seeder.dfm.device
        self.q_d, self.qlen_d, self.sl_d = (
            torch.from_numpy(a).to(dev) for a in (qpk, qlen, slens))
        self.sw_d = torch.full((B,), opt.split_width, dtype=torch.int32,
                               device=dev)
        self.mi_d = torch.full((B,), self.start_width, dtype=torch.int64,
                               device=dev)
        self.active = None
        self.ori_start = None

    def _finish_on_host(self, i: int) -> None:
        self.seeder._oracle_finish(
            self.opt, self.queries[i], int(self.start[i]), self.start_width,
            int(self.split_lens[i]), self.opt.split_width, self.out[i])
        self.exhausted[i] = True

    def advance(self) -> bool:
        """The bookkeeping between rounds; True when a round is to be
        launched."""
        sdr = self.seeder
        for i in np.nonzero(~self.exhausted)[0]:
            q, s, n = self.queries[i], int(self.start[i]), int(self.qlen[i])
            while s < n and q[s] > 3:    # software/bwamem.c:258-259
                s += 1
            self.start[i] = s
            self.exhausted[i] = s >= n
        active = ~self.exhausted
        n_live = int(active.sum())
        if n_live == 0:
            return False
        if n_live < sdr.min_seed_wave:
            # straggler tail: the few live reads finish on the host
            # oracle instead of paying full-width rounds
            sdr.timer._count("smem_host_tail", n_live)
            for i in np.nonzero(active)[0]:
                self._finish_on_host(i)
            return False
        self.active = active
        return True

    def dispatch(self):
        sdr = self.seeder
        dev = sdr.dfm.device
        self.ori_start = self.start.copy()
        x = np.where(self.active, self.start, 0).astype(np.int32)
        return smem_iter_step(
            sdr.dfm, self.q_d, self.qlen_d, torch.from_numpy(x).to(dev),
            self.mi_d, torch.from_numpy(self.active).to(dev), self.sl_d,
            self.sw_d, L=sdr.L, M=sdr.M, M_OUT=sdr.m_out)

    def process(self, res) -> None:
        from bwamem_tpu_torch.oracle.smem import smem1
        sdr = self.seeder
        (ret, n_mem, m0, m1, ms, mqb, mqe, over1, need2, _, n2, s0, s1,
         ss, sqb, sqe, over2) = res
        n_mem = np.where(over1, sdr.M + 1, n_mem)
        n2 = np.where(over2, sdr.M + 1, n2)
        ori = self.ori_start
        self.start = np.where(self.active, ret, self.start)

        for i in np.nonzero(self.active)[0]:
            query, qlen = self.queries[i], int(self.qlen[i])
            if n_mem[i] > sdr.m_out:
                # more SMEMs than the fetch holds: the whole step again
                # on the host oracle
                sdr.timer._count("ovf_smem_lanes")
                oret, matches = sdr._oracle_step(
                    self.opt, query, int(ori[i]), self.start_width,
                    int(self.split_lens[i]), self.opt.split_width)
                self.start[i] = oret
                self.out[i].extend(matches)
                continue
            matches = _lane_intervals(i, int(n_mem[i]), m0, m1, ms, mqb,
                                      mqe)
            if need2[i] and matches:
                best_len, best = 0, 0
                for j, p in enumerate(matches):
                    ln = (p[3] & 0xFFFFFFFF) - (p[3] >> 32)
                    if best_len < ln:
                        best_len, best = ln, j
                pm = matches[best]
                if n2[i] > sdr.m_out:    # pass 2 outgrew the fetch
                    sdr.timer._count("ovf_smem_lanes")
                    _, sub = smem1(sdr.fm_host, query,
                                   ((pm[3] >> 32) + (pm[3] & 0xFFFFFFFF))
                                   >> 1, pm[2] + 1)
                else:
                    sub = _lane_intervals(i, int(n2[i]), s0, s1, ss, sqb,
                                          sqe)
                matches = _merge(matches, sub, best_len, int(ori[i]),
                                 qlen)
            self.out[i].extend(matches)
