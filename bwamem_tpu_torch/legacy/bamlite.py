"""Minimal BAM reader (software/bamlite.c) for bwa-aln's -b input.

bamlite reads BAM through plain zlib (gzopen), so any gzip-framed BAM
stream works; this port uses Python's gzip the same way.  Only the
fields bwa_read_bam consumes are surfaced (software/bwaseqio.c:95-147):
qname, flag, sequence nybbles, quality.
"""

import gzip
import struct
from typing import Iterator, Optional, Tuple

BAM_FPAIRED = 1
BAM_FREAD1 = 0x40
BAM_FREAD2 = 0x80
BAM_FREVERSE = 0x10

# bam_nt16_nt4_table (software/bwaseqio.c:15)
NT16_NT4 = [4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4]


def read_bam_records(path: str) -> Iterator[Tuple[str, int, list,
                                                  Optional[bytes]]]:
    """Yields (qname, flag, nt4_codes, qual_phred_bytes_or_None)."""
    with gzip.open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file (bad magic)")
        l_text = struct.unpack("<i", f.read(4))[0]
        f.read(l_text)
        n_ref = struct.unpack("<i", f.read(4))[0]
        for _ in range(n_ref):
            l_name = struct.unpack("<i", f.read(4))[0]
            f.read(l_name + 4)
        while True:
            raw = f.read(4)
            if len(raw) < 4:
                break
            block_size = struct.unpack("<i", raw)[0]
            data = f.read(block_size)
            if len(data) < block_size:
                break
            (_refid, _pos, bin_mq_nl, flag_nc, l_qseq, _nrefid, _npos,
             _tlen) = struct.unpack_from("<iiIIiiii", data, 0)
            l_qname = bin_mq_nl & 0xFF
            n_cigar = flag_nc & 0xFFFF
            flag = flag_nc >> 16
            off = 32
            qname = data[off:off + l_qname - 1].decode("latin1")
            off += l_qname + 4 * n_cigar
            n_seq_bytes = (l_qseq + 1) // 2
            seq_bytes = data[off:off + n_seq_bytes]
            off += n_seq_bytes
            qual = data[off:off + l_qseq]
            nt4 = []
            for i in range(l_qseq):
                nyb = (seq_bytes[i >> 1] >> (4 if (i & 1) == 0 else 0)) & 0xF
                nt4.append(NT16_NT4[nyb])
            yield qname, flag, nt4, qual


def read_bam_seqs(it, n_needed: int, which: int, trim_qual: int):
    """bwa_read_bam (software/bwaseqio.c:95-147): filter by read-pair
    flags, reverse-complement reverse-strand records, optional quality
    trimming.  Returns LegacyRead records."""
    import numpy as np
    from .seqio import LegacyRead, trim_read
    out = []
    for qname, flag, nt4, qual in it:
        go = False
        if (which & 1) and (flag & BAM_FREAD1):
            go = True
        if (which & 2) and (flag & BAM_FREAD2):
            go = True
        if (which & 4) and not (flag & (BAM_FREAD1 | BAM_FREAD2)):
            go = True
        if not go:
            continue
        arr = np.asarray(nt4, dtype=np.uint8)
        q = bytearray(min(b + 33, 126) for b in qual)
        if flag & BAM_FREVERSE:
            arr = np.where(arr >= 4, arr, 3 - arr)[::-1].copy()
            q = bytearray(reversed(q))
        full_len = len(arr)
        length = full_len
        if trim_qual >= 1 and q:
            length = trim_read(trim_qual, q, length)
        out.append(LegacyRead(name=qname, nt4=arr, qual=q or None,
                              len=length, full_len=full_len,
                              clip_len=length))
        if len(out) == n_needed:
            break
    return out
