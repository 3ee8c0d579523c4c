"""SAM record formatting (mem_aln2sam, software/bwamem.c:1214-1327) and
header emission (bwa_print_sam_hdr, software/bwa.c:349-357).

Formatting fidelity is byte-level: flag arithmetic, mate copying, CIGAR
hard-clipping for supplementary records, reverse-complemented SEQ/QUAL,
and the NM/MD/AS/XS/RG/SA tag set all mirror the reference."""

from typing import List, Optional

from .align import MemAln, get_rlen

CIGAR_CHARS = "MIDSH"
SEQ_F = "ACGTN"
SEQ_R = "TGCAN"
_SEQ_F_TBL = bytes(ord(SEQ_F[i]) if i < len(SEQ_F) else 0
                   for i in range(256))
_SEQ_R_TBL = bytes(ord(SEQ_R[i]) if i < len(SEQ_R) else 0
                   for i in range(256))


def aln2sam(bns, read, n: int, alns: List[MemAln], which: int,
            m_: Optional[MemAln], rg_id: str, out: List[str]) -> None:
    p = _copy(alns[which])
    m = _copy(m_) if m_ is not None else None

    p.flag |= 0x1 if m else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m and m.rid < 0) else 0
    if p.rid < 0 and m and m.rid >= 0:  # copy mate to alignment
        p.rid, p.pos, p.is_rev, p.cigar = m.rid, m.pos, m.is_rev, []
    if m and m.rid < 0 and p.rid >= 0:  # copy alignment to mate
        m.rid, m.pos, m.is_rev, m.cigar = p.rid, p.pos, p.is_rev, []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m and m.is_rev) else 0

    buf = [read.name, "\t"]
    buf.append(str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0)))
    buf.append("\t")
    if p.rid >= 0:
        buf.append(bns.anns[p.rid].name)
        buf.append("\t")
        buf.append(str(p.pos + 1))
        buf.append("\t")
        buf.append(str(p.mapq))
        buf.append("\t")
        if p.cigar:
            for cg in p.cigar:
                c = cg & 0xF
                if c == 3 or c == 4:
                    c = 4 if which else 3  # hard clip supplementary
                buf.append(str(cg >> 4))
                buf.append(CIGAR_CHARS[c])
        else:
            buf.append("*")
    else:
        buf.append("*\t0\t0\t*")
    buf.append("\t")

    if m and m.rid >= 0:
        buf.append("=" if p.rid == m.rid else bns.anns[m.rid].name)
        buf.append("\t")
        buf.append(str(m.pos + 1))
        buf.append("\t")
        if p.rid == m.rid:
            p0 = p.pos + (get_rlen(p.cigar) - 1 if p.is_rev else 0)
            p1 = m.pos + (get_rlen(m.cigar) - 1 if m.is_rev else 0)
            if not m.cigar or not p.cigar:
                buf.append("0")
            else:
                sign = 1 if p0 > p1 else (-1 if p0 < p1 else 0)
                buf.append(str(-(p0 - p1 + sign)))
        else:
            buf.append("0")
    else:
        buf.append("*\t0\t0")
    buf.append("\t")

    # SEQ and QUAL (read.seq_nt4 is the nt4-encoded array)
    seq = read.seq_nt4
    l_seq = len(seq)
    if p.flag & 0x100:
        buf.append("*\t*")
    elif not p.is_rev:
        qb, qe = 0, l_seq
        if p.cigar and which:
            if (p.cigar[0] & 0xF) in (3, 4):
                qb += p.cigar[0] >> 4
            if (p.cigar[-1] & 0xF) in (3, 4):
                qe -= p.cigar[-1] >> 4
        buf.append(seq[qb:qe].astype("u1").tobytes()
                   .translate(_SEQ_F_TBL).decode("latin1"))
        buf.append("\t")
        buf.append(read.qual[qb:qe] if read.qual else "*")
    else:
        qb, qe = 0, l_seq
        if p.cigar and which:
            if (p.cigar[0] & 0xF) in (3, 4):
                qe -= p.cigar[0] >> 4
            if (p.cigar[-1] & 0xF) in (3, 4):
                qb += p.cigar[-1] >> 4
        buf.append(seq[qb:qe][::-1].astype("u1").tobytes()
                   .translate(_SEQ_R_TBL).decode("latin1"))
        buf.append("\t")
        buf.append(read.qual[qb:qe][::-1] if read.qual else "*")

    if p.cigar:
        buf.append("\tNM:i:")
        buf.append(str(p.NM))
        buf.append("\tMD:Z:")
        buf.append(p.MD)
    if p.score >= 0:
        buf.append("\tAS:i:")
        buf.append(str(p.score))
    if p.sub >= 0:
        buf.append("\tXS:i:")
        buf.append(str(p.sub))
    if rg_id:
        buf.append("\tRG:Z:")
        buf.append(rg_id)
    if not (p.flag & 0x100):
        others = [i for i in range(n)
                  if i != which and not (alns[i].flag & 0x100)]
        if others:
            buf.append("\tSA:Z:")
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                buf.append(bns.anns[r.rid].name)
                buf.append(",")
                buf.append(str(r.pos + 1))
                buf.append(",")
                buf.append("+-"[r.is_rev])
                buf.append(",")
                for cg in r.cigar:
                    buf.append(str(cg >> 4))
                    buf.append(CIGAR_CHARS[cg & 0xF])
                buf.append(",")
                buf.append(str(r.mapq))
                buf.append(",")
                buf.append(str(r.NM))
                buf.append(";")
    if read.comment:
        buf.append("\t")
        buf.append(read.comment)
    buf.append("\n")
    out.append("".join(buf))


def _copy(a: MemAln) -> MemAln:
    b = MemAln()
    b.__dict__.update(a.__dict__)
    b.cigar = list(a.cigar)
    return b


def sam_header(bns, rg_line: Optional[str], pg_line: Optional[str]) -> str:
    lines = []
    for ann in bns.anns:
        lines.append(f"@SQ\tSN:{ann.name}\tLN:{ann.length}\n")
    if rg_line:
        lines.append(rg_line + "\n")
    if pg_line:
        lines.append(pg_line + "\n")
    return "".join(lines)
