"""bwa samse: .sai -> SAM conversion (software/bwase.c, whole file).

Hit selection among equal-best alignments uses drand48 with the .ann
seed (software/bwase.c:22-97,520) — the exact glibc LCG sequence is
reproduced so output bytes match the reference."""

import math
import struct
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..index.bntseq import NT4_TABLE, get_seq
from ..oracle.ksw import ksw_global2
from ..utils.rand48 import Rand48
from .aln import Aln1, GapOpt, SAI_MAGIC, cal_maxdiff, BWA_AVG_ERR
from .seqio import LegacyRead, read_seqs

BWA_TYPE_NO_MATCH = 0
BWA_TYPE_UNIQUE = 1
BWA_TYPE_REPEAT = 2
BWA_TYPE_MATESW = 3

SAM_FSU = 4
SAM_FSR = 16
SAM_FMR = 32
SAM_FMU = 8

FROM_M, FROM_I, FROM_D, FROM_S = 0, 1, 2, 3
SW_BW = 50

G_LOG_N = [0] + [int(4.343 * math.log(i) + 0.5) for i in range(1, 256)]


@dataclass
class Multi1:
    """bwt_multi1_t."""
    pos: int = 0
    gap: int = 0
    mm: int = 0
    strand: int = 0
    ref_shift: int = 0
    cigar: Optional[List[int]] = None  # op<<14|len (bwa_cigar_t)


@dataclass
class AlnState:
    """The alignment-related slice of bwa_seq_t."""
    type: int = BWA_TYPE_NO_MATCH
    n_mm: int = 0
    n_gapo: int = 0
    n_gape: int = 0
    ref_shift: int = 0
    score: int = 0
    sa: int = 0
    c1: int = 0
    c2: int = 0
    seQ: int = 0
    mapQ: int = 0
    strand: int = 0
    pos: int = -1
    n_multi: int = 0
    multi: List[Multi1] = field(default_factory=list)
    cigar: Optional[List[int]] = None
    nm: int = 0
    md: Optional[str] = None


def cig_op(c):
    return c >> 14


def cig_len(c):
    return c & 0x3FFF


def cig_make(op, ln):
    return (op << 14) | ln


def aln2seq_core(alns: List[Aln1], s: AlnState, set_main: bool,
                 n_multi: int, rng: Rand48) -> None:
    """bwa_aln2seq_core (software/bwase.c:22-97)."""
    if not alns:
        s.type = BWA_TYPE_NO_MATCH
        s.c1 = s.c2 = 0
        return
    if set_main:
        best = alns[0].score
        cnt = 0
        i = 0
        while i < len(alns):
            p = alns[i]
            if p.score > best:
                break
            if rng.drand48() * (p.l - p.k + 1 + cnt) > float(cnt):
                s.n_mm, s.n_gapo, s.n_gape = p.n_mm, p.n_gapo, p.n_gape
                s.ref_shift = p.n_del - p.n_ins
                s.score = p.score
                s.sa = p.k + int((p.l - p.k + 1) * rng.drand48())
            cnt += p.l - p.k + 1
            i += 1
        s.c1 = cnt
        while i < len(alns):
            cnt += alns[i].l - alns[i].k + 1
            i += 1
        s.c2 = cnt - s.c1
        s.type = BWA_TYPE_REPEAT if s.c1 > 1 else BWA_TYPE_UNIQUE

    if n_multi:
        n_occ = sum(q.l - q.k + 1 for q in alns)
        s.multi = []
        s.n_multi = 0
        if n_occ > n_multi + 1:  # too many hits: generate none
            return
        rest = n_occ if n_occ <= n_multi + 1 else n_multi + 1
        for q in alns:
            if q.l - q.k + 1 <= rest:
                for l in range(q.k, q.l + 1):
                    s.multi.append(Multi1(pos=l, gap=q.n_gapo + q.n_gape,
                                          ref_shift=q.n_del - q.n_ins,
                                          mm=q.n_mm))
                rest -= q.l - q.k + 1
            else:  # random sampling; "in fact, we never come here"
                i = q.l - q.k + 1
                for j in range(rest, 0, -1):
                    p_, x = 1.0, rng.drand48()
                    while x < p_:
                        p_ -= p_ * j / i
                        i -= 1
                    s.multi.append(Multi1(pos=q.l - i,
                                          gap=q.n_gapo + q.n_gape,
                                          ref_shift=q.n_del - q.n_ins,
                                          mm=q.n_mm))
                rest = 0
                break
        s.n_multi = len(s.multi)


def approx_mapQ(s: AlnState, mm: int) -> int:
    """bwa_approx_mapQ (software/bwase.c:100-108)."""
    if s.c1 == 0:
        return 23
    if s.c1 > 1:
        return 0
    if s.n_mm == mm:
        return 25
    if s.c2 == 0:
        return 37
    n = 255 if s.c2 >= 255 else s.c2
    return 0 if 23 < G_LOG_N[n] else 23 - G_LOG_N[n]


def sa2pos(bns, fm, sapos: int, ref_len: int):
    """bwa_sa2pos (software/bwase.c:111-121): returns (pos, strand) with
    pos == -1 on a forward-reverse bridge."""
    pos_f = fm.sa_lookup(sapos)
    if pos_f < bns.l_pac < pos_f + ref_len:
        return -1, 0
    pos_f, is_rev = bns.depos(pos_f)
    strand = 0 if is_rev else 1
    if is_rev:
        pos_f = 0 if pos_f + 1 < ref_len else pos_f - ref_len + 1
    return pos_f, strand


def cal_pac_pos(bns, fm, reads: List[LegacyRead], states: List[AlnState],
                max_mm: int, fnr: float) -> None:
    """bwa_cal_pac_pos (software/bwase.c:129-168)."""
    for p, s in zip(reads, states):
        if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            max_diff = cal_maxdiff(p.len, BWA_AVG_ERR, fnr) \
                if fnr > 0.0 else max_mm
            s.seQ = s.mapQ = approx_mapQ(s, max_diff)
            s.pos, s.strand = sa2pos(bns, fm, s.sa, p.len + s.ref_shift)
            s.seQ = s.mapQ = approx_mapQ(s, max_diff)
            if s.pos == -1:
                s.type = BWA_TYPE_NO_MATCH
        kept = []
        for q in s.multi:
            q.pos, q.strand = sa2pos(bns, fm, q.pos, p.len + q.ref_shift)
            if q.pos != s.pos and q.pos != -1:
                kept.append(q)
        s.multi = kept
        s.n_multi = len(kept)


def refine_gapped_core(l_pac: int, pac, length: int, seq: np.ndarray,
                       ref_shift: int, rb: int):
    """bwa_refine_gapped_core (software/bwase.c:172-200): returns
    (cigar_list, new_rb)."""
    from ..config import fill_scmat
    mat = np.asarray(fill_scmat(1, 3), dtype=np.int64)
    re = rb + length + ref_shift
    rseq = get_seq(l_pac, pac, rb, re)
    w = SW_BW if SW_BW > abs((re - rb) - length) * 1.5 \
        else int(abs((re - rb) - length) * 1.5)
    _sc, cigar32 = ksw_global2(seq[:length], rseq, mat, 5, 1, 5, 1, w)
    n = len(cigar32)
    assert n > 0
    if (cigar32[-1] & 0xF) == 1:
        cigar32[-1] = (cigar32[-1] >> 4 << 4) | 3
    if (cigar32[0] & 0xF) == 1:
        cigar32[0] = (cigar32[0] >> 4 << 4) | 3
    if (cigar32[-1] & 0xF) == 2:
        cigar32 = cigar32[:-1]
    if cigar32 and (cigar32[0] & 0xF) == 2:
        rb += cigar32[0] >> 4
        cigar32 = cigar32[1:]
    return [cig_make(c & 0xF, c >> 4) for c in cigar32], rb


def cal_md1(cigar, length: int, pos: int, seq: np.ndarray, l_pac: int,
            pac) -> (str, int):
    """bwa_cal_md1 (software/bwase.c:199-245)."""
    out = []
    x, y, u, nm = pos, 0, 0, 0

    def ref_base(i):
        return int(pac[i >> 2] >> ((~i & 3) << 1) & 3)

    if cigar:
        for c in cigar:
            l = cig_len(c)
            op = cig_op(c)
            if op == FROM_M:
                for z in range(l):
                    if x + z >= l_pac:
                        break
                    cb = ref_base(x + z)
                    if cb > 3 or seq[y + z] > 3 or cb != seq[y + z]:
                        out.append(str(u))
                        out.append("ACGTN"[cb])
                        nm += 1
                        u = 0
                    else:
                        u += 1
                x += l
                y += l
            elif op in (FROM_I, FROM_S):
                y += l
                if op == FROM_I:
                    nm += l
            elif op == FROM_D:
                out.append(str(u))
                out.append("^")
                for z in range(l):
                    if x + z >= l_pac:
                        break
                    out.append("ACGT"[ref_base(x + z)])
                u = 0
                x += l
                nm += l
    else:
        for z in range(length):
            if x + z >= l_pac:
                break
            cb = ref_base(x + z)
            if cb > 3 or seq[z] > 3 or cb != seq[z]:
                out.append(str(u))
                out.append("ACGTN"[cb])
                nm += 1
                u = 0
            else:
                u += 1
    out.append(str(u))
    return "".join(out), nm


def correct_trimmed(p: LegacyRead, s: AlnState) -> None:
    """bwa_correct_trimmed (software/bwase.c:248-280)."""
    if p.len == p.full_len:
        return
    d = p.full_len - p.len
    if s.strand == 0:
        if s.cigar and cig_op(s.cigar[-1]) == FROM_S:
            s.cigar[-1] += d
        else:
            if s.cigar is None:
                s.cigar = [cig_make(0, p.len)]
            s.cigar = s.cigar + [cig_make(3, d)]
    else:
        if s.cigar and cig_op(s.cigar[0]) == FROM_S:
            s.cigar[0] += d
        else:
            if s.cigar is None:
                s.cigar = [cig_make(0, p.len)]
            s.cigar = [cig_make(3, d)] + s.cigar
    p.len = p.full_len


def refine_gapped(bns, fm, reads: List[LegacyRead],
                  states: List[AlnState]) -> None:
    """bwa_refine_gapped (software/bwase.c:283-329)."""
    pac = bns.pac
    for p, s in zip(reads, states):
        for q in list(s.multi):
            if q.gap:
                seq = p.rseq if q.strand else p.seq_fwd
                q.cigar, q.pos = refine_gapped_core(
                    bns.l_pac, pac, p.len, seq, q.ref_shift, q.pos)
        if s.type in (BWA_TYPE_NO_MATCH, BWA_TYPE_MATESW) or s.n_gapo == 0:
            continue
        seq = p.rseq if s.strand else p.seq_fwd
        s.cigar, s.pos = refine_gapped_core(bns.l_pac, pac, p.len, seq,
                                            s.ref_shift, s.pos)
    for p, s in zip(reads, states):
        if s.type != BWA_TYPE_NO_MATCH:
            seq = p.rseq if s.strand else p.seq_fwd
            s.md, s.nm = cal_md1(s.cigar, p.len, s.pos, seq, bns.l_pac,
                                 pac)
    for p, s in zip(reads, states):
        correct_trimmed(p, s)


def pos_end(s: AlnState, length: int) -> int:
    if s.cigar:
        x = s.pos
        for c in s.cigar:
            if cig_op(c) in (0, 2):
                x += cig_len(c)
        return x
    return s.pos + length


def pos_end_multi(q: Multi1, length: int) -> int:
    if q.cigar:
        x = q.pos
        for c in q.cigar:
            if cig_op(c) in (0, 2):
                x += cig_len(c)
        return x
    return q.pos + length


def _pos_5(s: AlnState, length: int) -> int:
    if s.type != BWA_TYPE_NO_MATCH:
        return pos_end(s, length) if s.strand else s.pos
    return -1


def print_seq(p: LegacyRead, strand: int) -> str:
    if strand == 0:
        return "".join("ACGTN"[c] for c in p.nt4[:p.full_len])
    return "".join("TGCAN"[c] for c in p.nt4[:p.full_len][::-1])


def print_sam1(bns, p: LegacyRead, s: AlnState, mate, mate_len: int,
               mode: int, max_top2: int, rg_id: str, out) -> None:
    """bwa_print_sam1 (software/bwase.c:389-495).  `mate` is the mate's
    AlnState or None."""
    w = out.write
    if s.type != BWA_TYPE_NO_MATCH or \
            (mate is not None and mate.type != BWA_TYPE_NO_MATCH):
        flag = p.extra_flag
        am = 0
        if s.type == BWA_TYPE_NO_MATCH:
            s.pos = mate.pos
            s.strand = mate.strand
            flag |= SAM_FSU
            j = 1
        else:
            j = pos_end(s, p.len) - s.pos
        seqid = bns.pos2rid(s.pos)
        nn = bns.cnt_ambi(s.pos, j)
        if s.type != BWA_TYPE_NO_MATCH \
                and s.pos + j - bns.anns[seqid].offset > bns.anns[seqid].length:
            flag |= SAM_FSU
        if s.strand:
            flag |= SAM_FSR
        if mate is not None:
            if mate.type != BWA_TYPE_NO_MATCH:
                if mate.strand:
                    flag |= SAM_FMR
            else:
                flag |= SAM_FMU
        w("%s\t%d\t%s\t" % (p.name, flag, bns.anns[seqid].name))
        w("%d\t%d\t" % (s.pos - bns.anns[seqid].offset + 1, s.mapQ))
        if s.cigar:
            for c in s.cigar:
                w("%d%c" % (cig_len(c), "MIDS"[cig_op(c)]))
        elif s.type == BWA_TYPE_NO_MATCH:
            w("*")
        else:
            w("%dM" % p.len)
        if mate is not None and mate.type != BWA_TYPE_NO_MATCH:
            am = min(mate.seQ, s.seQ)
            m_seqid = bns.pos2rid(mate.pos)
            w("\t%s\t" % ("=" if seqid == m_seqid
                          else bns.anns[m_seqid].name))
            isize = (_pos_5(mate, mate_len) - _pos_5(s, p.len)) \
                if seqid == m_seqid else 0
            if s.type == BWA_TYPE_NO_MATCH:
                isize = 0
            w("%d\t%d\t" % (mate.pos - bns.anns[m_seqid].offset + 1,
                            isize))
        elif mate is not None:
            w("\t=\t%d\t0\t" % (s.pos - bns.anns[seqid].offset + 1))
        else:
            w("\t*\t0\t0\t")
        w(print_seq(p, s.strand))
        w("\t")
        if p.qual is not None:
            q = bytes(p.qual[:p.len])
            if s.strand:
                q = q[::-1]
            w(q.decode("latin1"))
        else:
            w("*")
        if rg_id:
            w("\tRG:Z:%s" % rg_id)
        if p.bc:
            w("\tBC:Z:%s" % p.bc)
        if p.clip_len < p.full_len:
            w("\tXC:i:%d" % p.clip_len)
        if s.type != BWA_TYPE_NO_MATCH:
            XT = "NURM"[s.type]
            if nn > 10:
                XT = "N"
            w("\tXT:A:%c\t%s:i:%d" % (XT, "NM" if (mode & 0x02) else "CM",
                                      s.nm))
            if nn:
                w("\tXN:i:%d" % nn)
            if mate is not None:
                w("\tSM:i:%d\tAM:i:%d" % (s.seQ, am))
            if s.type != BWA_TYPE_MATESW:
                w("\tX0:i:%d" % s.c1)
                if s.c1 <= max_top2:
                    w("\tX1:i:%d" % s.c2)
            w("\tXM:i:%d\tXO:i:%d\tXG:i:%d" % (s.n_mm, s.n_gapo,
                                               s.n_gapo + s.n_gape))
            if s.md is not None:
                w("\tMD:Z:%s" % s.md)
            if s.n_multi:
                w("\tXA:Z:")
                for q in s.multi:
                    j = pos_end_multi(q, p.len) - q.pos
                    sid = bns.pos2rid(q.pos)
                    w("%s,%c%d," % (bns.anns[sid].name,
                                    "-" if q.strand else "+",
                                    q.pos - bns.anns[sid].offset + 1))
                    if q.cigar:
                        for c in q.cigar:
                            w("%d%c" % (cig_len(c), "MIDS"[cig_op(c)]))
                    else:
                        w("%dM" % p.len)
                    w(",%d;" % (q.gap + q.mm))
        w("\n")
    else:
        flag = p.extra_flag | SAM_FSU
        if mate is not None and mate.type == BWA_TYPE_NO_MATCH:
            flag |= SAM_FMU
        w("%s\t%d\t*\t0\t0\t*\t*\t0\t0\t" % (p.name, flag))
        w(print_seq(p, s.strand))
        w("\t")
        if p.qual is not None:
            q = bytes(p.qual[:p.len])
            if s.strand:
                q = q[::-1]
            w(q.decode("latin1"))
        else:
            w("*")
        if rg_id:
            w("\tRG:Z:%s" % rg_id)
        if p.bc:
            w("\tBC:Z:%s" % p.bc)
        if p.clip_len < p.full_len:
            w("\tXC:i:%d" % p.clip_len)
        w("\n")


def read_sai_header(fp):
    magic = fp.read(4)
    if magic != SAI_MAGIC:
        sys.stderr.write("[E::bwa_sai2sam_se] Unmatched SAI magic.\n")
        raise SystemExit(1)
    return GapOpt.unpack(fp.read(64))


def read_sai_records(fp) -> List[Aln1]:
    raw = fp.read(4)
    n = struct.unpack("<i", raw)[0]
    return [Aln1.unpack(fp.read(24)) for _ in range(n)]


def main_samse(argv) -> int:
    import getopt as _getopt
    from ..index.bntseq import bns_restore
    from ..index.fmindex import FmIndex
    from ..core.sam import sam_header
    n_occ = 3
    rg_line = rg_id = None
    out_path = None
    try:
        opts, args = _getopt.getopt(argv, "hn:f:r:")
    except _getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n")
        return 1
    for c, v in opts:
        if c == "-n":
            n_occ = int(v)
        elif c == "-f":
            out_path = v
        elif c == "-r":
            from ..cli import set_rg
            rg_line, rg_id = set_rg(v)
            if rg_line is None:
                return 1
    if len(args) < 3:
        sys.stderr.write("Usage: bwa samse [-n max_occ] [-f out.sam] "
                         "[-r RG_line] <prefix> <in.sai> <in.fq>\n")
        return 1
    prefix, fn_sa, fn_fa = args[0], args[1], args[2]
    bns = bns_restore(prefix, load_pac_file=True)
    rng = Rand48(bns.seed)
    fm = FmIndex.restore(prefix + ".bwt", prefix + ".sa")
    out = open(out_path, "w") if out_path else sys.stdout
    fp_sa = open(fn_sa, "rb")
    opt = read_sai_header(fp_sa)
    out.write(sam_header(bns, rg_line, None))
    from .seqio import open_reads
    reader = open_reads(fn_fa, opt.mode)
    tot = 0
    while True:
        reads = reader(0x40000, opt.trim_qual)
        if not reads:
            break
        tot += len(reads)
        states = []
        for p in reads:
            alns = read_sai_records(fp_sa)
            s = AlnState()
            aln2seq_core(alns, s, True, n_occ, rng)
            states.append(s)
        sys.stderr.write("[bwa_aln_core] convert to sequence "
                         "coordinate... ")
        cal_pac_pos(bns, fm, reads, states, opt.max_diff, opt.fnr)
        sys.stderr.write("0.00 sec\n")
        sys.stderr.write("[bwa_aln_core] refine gapped alignments... ")
        refine_gapped(bns, fm, reads, states)
        sys.stderr.write("0.00 sec\n")
        sys.stderr.write("[bwa_aln_core] print alignments... ")
        for p, s in zip(reads, states):
            print_sam1(bns, p, s, None, 0, opt.mode, opt.max_top2,
                       rg_id or "", out)
        sys.stderr.write("0.00 sec\n")
        sys.stderr.write("[bwa_aln_core] %d sequences have been "
                         "processed.\n" % tot)
    fp_sa.close()
    if out_path:
        out.close()
    return 0
