"""Reference metadata + 2-bit packed sequence (.pac/.ann/.amb layer).

Functional equivalent of the reference's bntseq.c: FASTA parsing into a
2-bit pack with N->random-base substitution (seeded lrand48, seed 11),
the .ann/.amb/.pac on-disk formats (byte-identical to bwa 0.7.8), and the
coordinate utilities bns_depos / bns_pos2rid / bns_get_seq
(reference: software/bntseq.c:63-295,316-376).

The pack is held as a NumPy uint8 array with 4 bases per byte, MSB-first
within a byte (base i lives at bits (3-i%4)*2 of byte i//4), matching
bwa's _set_pac/_get_pac layout.
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple
import numpy as np

from ..utils.rand48 import Rand48

# nst_nt4_table: ASCII -> {A:0,C:1,G:2,T:3, '-':5, else 4}
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i
NT4_TABLE[ord('-')] = 5


@dataclass
class ContigAnn:
    """One reference contig's annotation (bntann1_t)."""
    offset: int
    length: int
    n_ambs: int
    gi: int
    name: str
    anno: str


@dataclass
class AmbHole:
    """One run of ambiguous bases (bntamb1_t)."""
    offset: int
    length: int
    amb: str


@dataclass
class BntSeq:
    """bntseq_t: contig table + ambiguity holes + packed sequence length."""
    l_pac: int = 0
    seed: int = 0
    anns: List[ContigAnn] = field(default_factory=list)
    ambs: List[AmbHole] = field(default_factory=list)
    pac: Optional[np.ndarray] = None  # uint8 pack, forward strand only

    # ---- coordinate helpers -------------------------------------------------

    def depos(self, pos: int) -> Tuple[int, bool]:
        """Map a position on the doubled (forward+reverse) reference to the
        forward strand (bns_depos, bntseq.h:83-86)."""
        is_rev = pos >= self.l_pac
        return ((self.l_pac << 1) - 1 - pos, True) if is_rev else (pos, False)

    def pos2rid(self, pos_f: int) -> int:
        """Forward position -> contig id by binary search (bntseq.c:316-330)."""
        if pos_f >= self.l_pac:
            return -1
        left, mid, right = 0, 0, len(self.anns)
        while left < right:
            mid = (left + right) >> 1
            if pos_f >= self.anns[mid].offset:
                if mid == len(self.anns) - 1:
                    break
                if pos_f < self.anns[mid + 1].offset:
                    break
                left = mid + 1
            else:
                right = mid
        return mid

    def cnt_ambi(self, pos_f: int, length: int) -> int:
        """Count ambiguous reference bases overlapping [pos_f, pos_f+length)
        (bntseq.c:332-353)."""
        left, right, nn = 0, len(self.ambs), 0
        while left < right:
            mid = (left + right) >> 1
            amb = self.ambs[mid]
            if pos_f >= amb.offset + amb.length:
                left = mid + 1
            elif pos_f + length <= amb.offset:
                right = mid
            else:
                if pos_f >= amb.offset:
                    nn += (amb.offset + amb.length - pos_f
                           if amb.offset + amb.length < pos_f + length else length)
                else:
                    nn += (amb.length if amb.offset + amb.length < pos_f + length
                           else length - (amb.offset - pos_f))
                break
        return nn


# ---- pack primitives --------------------------------------------------------

def pac_get(pac: np.ndarray, l) -> np.ndarray:
    """_get_pac, vectorized: base(s) at position(s) l."""
    l = np.asarray(l, dtype=np.int64)
    return (pac[l >> 2] >> ((~l & 3) << 1).astype(np.uint8)) & 3


# one-time unpacked forward bases per pac (get_seq is called ~3x per
# read in the hot finalize path; 2-bit decode + arange per call was
# ~0.5 s per bench).  Gated by size: 1 byte/base, so a human-scale pac
# (3 Gbp) stays packed and uses the slow path.
_UNPACK_MAX = int(__import__("os").environ.get(
    "BWAMEM_TPU_UNPACK_MAX", str(1 << 28)))
_unpack_cache = {}


def _unpacked(pac: np.ndarray, l_pac: int):
    ent = _unpack_cache.get(id(pac))
    if ent is not None and ent[0] is pac:
        return ent[1]
    if l_pac > _UNPACK_MAX:
        return None
    bases = np.empty(len(pac) * 4, dtype=np.uint8)
    for sh in range(4):
        bases[sh::4] = (pac >> ((3 - sh) << 1)) & 3
    bases = bases[:l_pac]
    _unpack_cache.clear()  # one live genome per process
    _unpack_cache[id(pac)] = (pac, bases)
    return bases


def get_seq(l_pac: int, pac: np.ndarray, beg: int, end: int) -> np.ndarray:
    """bns_get_seq: fetch [beg,end) from the logical doubled reference.
    Reverse-strand requests return the complement in ascending logical
    order; bridging requests return an empty array (bntseq.c:355-376)."""
    if end < beg:
        beg, end = end, beg
    if end > l_pac << 1:
        end = l_pac << 1
    if beg < 0:
        beg = 0
    if beg >= l_pac or end <= l_pac:
        fwdu = _unpacked(pac, l_pac)
        if beg >= l_pac:  # reverse strand
            beg_f = (l_pac << 1) - end
            end_f = (l_pac << 1) - beg
            if fwdu is not None:
                return (3 - fwdu[beg_f:end_f][::-1]).astype(np.uint8)
            fwd = pac_get(pac, np.arange(beg_f, end_f, dtype=np.int64))
            return (3 - fwd[::-1]).astype(np.uint8)
        if fwdu is not None:
            return fwdu[beg:end].copy()
        return pac_get(pac, np.arange(beg, end, dtype=np.int64)).astype(np.uint8)
    return np.empty(0, dtype=np.uint8)


# ---- FASTA -> pack ----------------------------------------------------------

def _read_fasta(path: str):
    """Minimal FASTA reader with kseq field semantics: name is the first
    whitespace-delimited token of the header, comment is the remainder."""
    name = comment = None
    chunks: List[str] = []
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">") or line.startswith("@"):
                if name is not None:
                    yield name, comment, "".join(chunks)
                hdr = line[1:]
                parts = hdr.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                chunks = []
            elif line.startswith("+") and name is not None and chunks:
                # FASTQ quality section: skip one line (not used for refs)
                next(f, None)
            else:
                chunks.append(line.strip())
    if name is not None:
        yield name, comment, "".join(chunks)


def fasta2bntseq(fasta_path: str, for_only: bool = False) -> Tuple[BntSeq, np.ndarray]:
    """Pack a FASTA reference: returns (BntSeq, pac-with-4-bases-per-byte).

    When for_only is False the returned pack has the reverse complement
    appended and l_pac is doubled, exactly like the first
    bns_fasta2bntseq() pass used for BWT construction
    (bntseq.c:242-295).  N bases become lrand48()&3 with seed 11.
    """
    bns = BntSeq(seed=11)
    rng = Rand48(11)
    bases: List[np.ndarray] = []
    for name, comment, seq in _read_fasta(fasta_path):
        codes = NT4_TABLE[np.frombuffer(seq.encode("latin1"), dtype=np.uint8)]
        n_ambs = 0
        # identify runs of identical ambiguity characters (holes)
        if np.any(codes >= 4):
            amb_pos = np.nonzero(codes >= 4)[0]
            raw = np.frombuffer(seq.encode("latin1"), dtype=np.uint8)[amb_pos]
            run_start = 0
            for j in range(1, len(amb_pos) + 1):
                if (j == len(amb_pos) or amb_pos[j] != amb_pos[j - 1] + 1
                        or raw[j] != raw[j - 1]):
                    bns.ambs.append(AmbHole(
                        offset=bns.l_pac + int(amb_pos[run_start]),
                        length=int(j - run_start),
                        amb=chr(raw[run_start])))
                    n_ambs += 1
                    run_start = j
        offset = bns.l_pac
        bns.anns.append(ContigAnn(offset=offset, length=len(seq), n_ambs=n_ambs,
                                  gi=0, name=name,
                                  anno=comment if comment else "(null)"))
        # N -> random base, drawn in sequence order (bntseq.c:229)
        out = codes.copy()
        for p in np.nonzero(codes >= 4)[0]:
            out[p] = rng.lrand48() & 3
        bases.append(out)
        bns.l_pac += len(seq)

    all_bases = (np.concatenate(bases) if bases
                 else np.empty(0, dtype=np.uint8)).astype(np.uint8)
    if not for_only:
        all_bases = np.concatenate([all_bases, (3 - all_bases)[::-1]])
        bns.l_pac *= 2
    return bns, pack_bases(all_bases)


def pack_bases(bases: np.ndarray) -> np.ndarray:
    """2-bit pack, 4 bases/byte MSB-first."""
    n = len(bases)
    padded = np.zeros(((n + 3) >> 2) << 2, dtype=np.uint8)
    padded[:n] = bases
    quads = padded.reshape(-1, 4)
    return (quads[:, 0] << 6 | quads[:, 1] << 4
            | quads[:, 2] << 2 | quads[:, 3]).astype(np.uint8)


def unpack_bases(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_bases for the first n bases."""
    b = np.empty((len(pac), 4), dtype=np.uint8)
    b[:, 0] = pac >> 6
    b[:, 1] = (pac >> 4) & 3
    b[:, 2] = (pac >> 2) & 3
    b[:, 3] = pac & 3
    return b.reshape(-1)[:n]


# ---- on-disk formats (byte-identical to bwa 0.7.8) --------------------------

def dump_pac(pac: np.ndarray, l_pac: int, path: str) -> None:
    """Write .pac: packed bytes + trailing l_pac%4 byte, padded so the file
    is always l_pac/4+2 bytes when l_pac%4==0 (bntseq.c:276-289)."""
    with open(path, "wb") as f:
        n_bytes = (l_pac >> 2) + (0 if (l_pac & 3) == 0 else 1)
        f.write(pac[:n_bytes].tobytes())
        if l_pac % 4 == 0:
            f.write(bytes([0]))
        f.write(bytes([l_pac % 4]))


def load_pac(path: str) -> Tuple[np.ndarray, int]:
    """Read a .pac file; returns (packed bytes, l_pac).  l_pac recovery
    matches bwa_seq_len (bwtindex.c:49-60): the final byte holds l_pac%4
    and the file is always l_pac/4+2 bytes when l_pac%4==0, +1 otherwise."""
    raw = np.fromfile(path, dtype=np.uint8)
    tail = int(raw[-1])
    l_pac = (len(raw) - 2) * 4 + tail
    n_bytes = (l_pac >> 2) + (0 if (l_pac & 3) == 0 else 1)
    return raw[:n_bytes], l_pac


def dump_ann_amb(bns: BntSeq, prefix: str) -> None:
    """Write .ann and .amb in bwa's text format (bntseq.c:63-93)."""
    with open(prefix + ".ann", "w") as f:
        f.write(f"{bns.l_pac} {len(bns.anns)} {bns.seed}\n")
        for p in bns.anns:
            f.write(f"{p.gi} {p.name}")
            f.write(f" {p.anno}\n" if p.anno else "\n")
            f.write(f"{p.offset} {p.length} {p.n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{bns.l_pac} {len(bns.anns)} {len(bns.ambs)}\n")
        for p in bns.ambs:
            f.write(f"{p.offset} {p.length} {p.amb}\n")


def bns_restore(prefix: str, load_pac_file: bool = True) -> BntSeq:
    """Load .ann/.amb (+ .pac) written by bwa or by this module
    (bntseq.c:95-173)."""
    bns = BntSeq()
    with open(prefix + ".ann") as f:
        tokens = f.read().split("\n")
    first = tokens[0].split()
    bns.l_pac, n_seqs, bns.seed = int(first[0]), int(first[1]), int(first[2])
    li = 1
    for _ in range(n_seqs):
        head = tokens[li].split(None, 2)
        gi, name = int(head[0]), head[1]
        anno = head[2] if len(head) > 2 else ""
        body = tokens[li + 1].split()
        bns.anns.append(ContigAnn(offset=int(body[0]), length=int(body[1]),
                                  n_ambs=int(body[2]), gi=gi, name=name,
                                  anno=anno))
        li += 2
    with open(prefix + ".amb") as f:
        lines = f.read().split("\n")
    first = lines[0].split()
    n_holes = int(first[2])
    for i in range(n_holes):
        parts = lines[1 + i].split()
        bns.ambs.append(AmbHole(offset=int(parts[0]), length=int(parts[1]),
                                amb=parts[2]))
    if load_pac_file:
        pac, _ = load_pac(prefix + ".pac")
        bns.pac = pac
    return bns
