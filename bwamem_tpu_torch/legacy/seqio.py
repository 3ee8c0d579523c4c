"""bwa-aln read preparation (software/bwaseqio.c).

bwa_read_seq stores the nt4 sequence REVERSED in bwa_seq_t.seq (the
search stage wants it that way; bwa_refine_gapped un-reverses it) and
the reverse complement in rseq; only the first `len` (post-trim) bases
participate, but SAM printing emits all full_len bases.  This port
keeps the full forward-orientation nt4 array and derives the reversed /
reverse-complemented views where the C mutates in place.
"""

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..index.bntseq import NT4_TABLE
from .aln import (BWA_MODE_CFY, BWA_MODE_IL13, BWA_MIN_RDLEN, BWA_MODE_BAM,
                  BWA_MODE_BAM_SE, BWA_MODE_BAM_READ1, BWA_MODE_BAM_READ2)

BARCODE_LOW_QUAL = 13


@dataclass
class LegacyRead:
    name: str
    nt4: np.ndarray            # full_len forward-orientation nt4 codes
    qual: Optional[bytearray]  # phred+33, forward orientation
    len: int                   # post-trim length
    full_len: int
    clip_len: int
    bc: str = ""
    extra_flag: int = 0

    @property
    def seq_rev(self) -> np.ndarray:
        """bwa_seq_t.seq as the aln search sees it: reversed read."""
        return self.nt4[:self.len][::-1].copy()

    @property
    def seq_fwd(self) -> np.ndarray:
        return self.nt4[:self.len]

    @property
    def rseq(self) -> np.ndarray:
        """bwa_seq_t.rseq: reverse complement of the (trimmed) read."""
        f = self.nt4[:self.len][::-1]
        return np.where(f >= 4, f, 3 - f).astype(np.uint8)


def trim_read(trim_qual: int, qual: bytes, length: int) -> int:
    """bwa_trim_read (software/bwaseqio.c:81-92): returns new length."""
    if trim_qual < 1 or qual is None:
        return length
    s, max_, max_l = 0, 0, length
    for l in range(length - 1, BWA_MIN_RDLEN - 1, -1):
        s += trim_qual - (qual[l] - 33)
        if s < 0:
            break
        if s > max_:
            max_, max_l = s, l
    return max_l


def read_seqs(parser_iter, n_needed: int, mode: int, trim_qual: int
              ) -> List[LegacyRead]:
    """bwa_read_seq (software/bwaseqio.c:150-225) over a parse_fastx
    iterator."""
    is_64 = bool(mode & BWA_MODE_IL13)
    l_bc = mode >> 24
    out: List[LegacyRead] = []
    for rec in parser_iter:
        if (mode & BWA_MODE_CFY) and rec.comment:
            i = rec.comment.find(":")
            if i >= 0 and i + 1 < len(rec.comment) \
                    and rec.comment[i + 1] == "Y":
                continue
        seq_s = rec.seq
        qual_s = rec.qual
        if is_64 and qual_s:
            qual_s = "".join(chr(ord(c) - 31) for c in qual_s)
        if len(seq_s) <= l_bc:
            continue
        bc = ""
        if l_bc:
            bcs = []
            for i in range(l_bc):
                low = qual_s and (ord(qual_s[i]) - 33 < BARCODE_LOW_QUAL)
                bcs.append(seq_s[i].lower() if low else seq_s[i].upper())
            bc = "".join(bcs)
            seq_s = seq_s[l_bc:]
            if qual_s:
                qual_s = qual_s[l_bc:]
        full_len = len(seq_s)
        nt4 = NT4_TABLE[np.frombuffer(seq_s.encode("latin1"),
                                      np.uint8)].copy()
        qual = bytearray(qual_s.encode("latin1")) if qual_s else None
        length = full_len
        if qual is not None and trim_qual >= 1:
            length = trim_read(trim_qual, qual, length)
        name = rec.name
        if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
            name = name[:-2]
        out.append(LegacyRead(name=name, nt4=nt4, qual=qual, len=length,
                              full_len=full_len, clip_len=length, bc=bc))
        if len(out) == n_needed:
            break
    return out


def open_reads(path: str, mode: int):
    """bwa_open_reads (software/bwtaln.c:152-161): returns a chunked
    reader callable(n_needed, trim_qual) honoring the BAM mode bits."""
    if mode & BWA_MODE_BAM:
        from .bamlite import read_bam_records, read_bam_seqs
        which = 0
        if mode & BWA_MODE_BAM_SE:
            which |= 4
        if mode & BWA_MODE_BAM_READ1:
            which |= 1
        if mode & BWA_MODE_BAM_READ2:
            which |= 2
        if which == 0:
            which = 7
        it = read_bam_records(path)
        return lambda n, tq: read_bam_seqs(it, n, which, tq)
    from ..io.fastq import parse_fastx
    it = parse_fastx(path)
    return lambda n, tq: read_seqs(it, n, mode, tq)
