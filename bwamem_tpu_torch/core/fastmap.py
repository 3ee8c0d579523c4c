"""`fastmap` command: print super-maximal exact matches per read
(reference: software/fastmap.c:254-318).  Output is byte-identical to
the reference, including its quirk of writing the trailing "//" without
a newline so the next SQ record concatenates onto it."""

from typing import Iterable, TextIO

from ..index.bntseq import NT4_TABLE


def run_fastmap(fm, bns, reads: Iterable, out: TextIO,
                min_iwidth: int = 20, min_len: int = 17,
                split_width: int = 0, print_seq: bool = False,
                engine=None) -> None:
    from ..oracle.smem import SmemIterator
    for name, seq, _qual in reads:
        out.write(f"SQ\t{name}\t{len(seq)}")
        if print_seq:
            out.write(f"\t{seq}")
        out.write("\n")
        q = NT4_TABLE[memoryview(seq.encode("latin1"))]
        itr = SmemIterator(fm, q)
        while True:
            a = itr.next(min_len << 1, split_width, 1)
            if a is None:
                break
            for p in a:
                beg, end = p[3] >> 32, p[3] & 0xFFFFFFFF
                length = end - beg
                if length < min_len:
                    continue
                out.write(f"EM\t{beg}\t{end}\t{p[2]}")
                if p[2] <= min_iwidth:
                    for k in range(p[2]):
                        pos = fm.sa_lookup(p[0] + k)
                        pos_f, is_rev = bns.depos(pos)
                        if is_rev:
                            pos_f -= length - 1
                        rid = bns.pos2rid(pos_f)
                        out.write("\t%s:%c%d" % (
                            bns.anns[rid].name, "+-"[is_rev],
                            pos_f - bns.anns[rid].offset + 1))
                else:
                    out.write("\t*")
                out.write("\n")
        out.write("//")
