"""Streaming FASTA/FASTQ reader with bwa's chunking semantics.

Equivalent of kseq.h parsing plus bseq_read's chunk accumulation
(reference: software/bwa.c:47-78, software/kseq.h): records carry
(name, comment, seq, qual); paired files are interleaved 1:1; trailing
"/1" and "/2" read-number suffixes are trimmed from names; a chunk ends
once total bases >= chunk_size with an even number of reads.
"""

import gzip
from dataclasses import dataclass
from typing import Iterator, List, Optional


@dataclass
class Read:
    name: str
    comment: Optional[str]
    seq: str
    qual: Optional[str]
    sam: Optional[str] = None

    @property
    def l_seq(self) -> int:
        return len(self.seq)


def _open(path: str):
    """xzopen/kopen semantics (software/kopen.c): '-' is stdin,
    http:// and ftp:// URLs stream over the network, .gz is transparent."""
    if path == "-":
        import sys
        return sys.stdin
    if path.startswith(("http://", "ftp://")):
        import io as _io
        import urllib.request
        raw = urllib.request.urlopen(path)
        buf = _io.BufferedReader(raw)
        if buf.peek(2)[:2] == b"\x1f\x8b":
            return _io.TextIOWrapper(gzip.GzipFile(fileobj=buf))
        return _io.TextIOWrapper(buf)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def parse_fastx(path: str) -> Iterator[Read]:
    """kseq-style record iterator over FASTA or FASTQ (possibly mixed)."""
    f = _open(path)
    name = comment = None
    seq_parts: List[str] = []
    line = f.readline()
    while line:
        line = line.rstrip("\n").rstrip("\r")
        if not line:
            line = f.readline()
            continue
        if line[0] in ">@":
            hdr = line[1:]
            parts = hdr.split(None, 1)
            name = parts[0] if parts else ""
            comment = parts[1] if len(parts) > 1 else None
            is_fastq = line[0] == "@"
            seq_parts = []
            line = f.readline()
            while line and line[0] not in ">@+":
                seq_parts.append(line.strip())
                line = f.readline()
            seq = "".join(seq_parts)
            qual = None
            if is_fastq and line and line[0] == "+":
                qual_parts: List[str] = []
                got = 0
                while got < len(seq):
                    ql = f.readline()
                    if not ql:
                        break
                    ql = ql.rstrip("\n").rstrip("\r")
                    qual_parts.append(ql)
                    got += len(ql)
                qual = "".join(qual_parts)
                line = f.readline()
            yield Read(name=name, comment=comment, seq=seq, qual=qual)
        else:
            line = f.readline()
    if f is not None and path != "-":
        f.close()


def trim_readno(name: str) -> str:
    """Drop a trailing /<digit> read-number suffix (bwa.c:32-36)."""
    if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name


class ChunkReader:
    """bseq_read: accumulate reads until >= chunk_size total bases,
    interleaving a second file's records when paired."""

    def __init__(self, path1: str, path2: Optional[str] = None):
        self.it1 = parse_fastx(path1)
        self.it2 = parse_fastx(path2) if path2 else None

    def read_chunk(self, chunk_size: int) -> List[Read]:
        out: List[Read] = []
        size = 0
        for r1 in self.it1:
            if self.it2 is not None:
                r2 = next(self.it2, None)
                if r2 is None:
                    import sys
                    print("[W::bseq_read] the 2nd file has fewer sequences.",
                          file=sys.stderr)
                    break
            r1.name = trim_readno(r1.name)
            out.append(r1)
            size += r1.l_seq
            if self.it2 is not None:
                r2.name = trim_readno(r2.name)
                out.append(r2)
                size += r2.l_seq
            if size >= chunk_size and len(out) % 2 == 0:
                break
        return out
