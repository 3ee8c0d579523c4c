"""`aln` command driver (software/bwtaln.c:155-320): search every read,
stream bwt_aln1_t records to the .sai file."""

import struct
import sys
import time

from .aln import (GapOpt, cal_maxdiff, cal_sa_reg_gap, BWA_AVG_ERR,
                  BWA_MODE_GAPE, BWA_MODE_LOGGAP, BWA_MODE_NONSTOP,
                  BWA_MODE_CFY, BWA_MODE_IL13, BWA_MODE_BAM,
                  BWA_MODE_BAM_SE, BWA_MODE_BAM_READ1, BWA_MODE_BAM_READ2,
                  SAI_MAGIC, BWA_MIN_RDLEN)
from .seqio import open_reads


def main_aln(argv) -> int:
    import getopt as _getopt
    opt = GapOpt()
    opte = -1
    out_path = None
    try:
        opts, args = _getopt.getopt(argv, "n:o:e:i:d:l:k:LR:m:t:NM:O:E:q:f:b012IYB:")
    except _getopt.GetoptError as e:
        sys.stderr.write(str(e) + "\n")
        return 1
    for c, v in opts:
        c = c[1:]
        if c == "n":
            if "." in v:
                opt.fnr = float(v)
                opt.max_diff = -1
            else:
                opt.max_diff = int(v)
                opt.fnr = -1.0
        elif c == "o":
            opt.max_gapo = int(v)
        elif c == "e":
            opte = int(v)
        elif c == "M":
            opt.s_mm = int(v)
        elif c == "O":
            opt.s_gapo = int(v)
        elif c == "E":
            opt.s_gape = int(v)
        elif c == "d":
            opt.max_del_occ = int(v)
        elif c == "i":
            opt.indel_end_skip = int(v)
        elif c == "l":
            opt.seed_len = int(v)
        elif c == "k":
            opt.max_seed_diff = int(v)
        elif c == "m":
            opt.max_entries = int(v)
        elif c == "t":
            opt.n_threads = int(v)
        elif c == "L":
            opt.mode |= BWA_MODE_LOGGAP
        elif c == "R":
            opt.max_top2 = int(v)
        elif c == "q":
            opt.trim_qual = int(v)
        elif c == "N":
            opt.mode |= BWA_MODE_NONSTOP
            opt.max_top2 = 0x7FFFFFFF
        elif c == "f":
            out_path = v
        elif c == "I":
            opt.mode |= BWA_MODE_IL13
        elif c == "Y":
            opt.mode |= BWA_MODE_CFY
        elif c == "B":
            opt.mode |= int(v) << 24
        elif c == "b":
            opt.mode |= BWA_MODE_BAM
        elif c == "0":
            opt.mode |= BWA_MODE_BAM_SE
        elif c == "1":
            opt.mode |= BWA_MODE_BAM_READ1
        elif c == "2":
            opt.mode |= BWA_MODE_BAM_READ2
    if opte > 0:
        opt.max_gape = opte
        opt.mode &= ~BWA_MODE_GAPE

    if len(args) < 2:
        sys.stderr.write("Usage: bwa aln [options] <prefix> <in.fq>\n")
        return 1
    if opt.fnr > 0.0:
        k = 0
        for i in range(17, 251):
            l = cal_maxdiff(i, BWA_AVG_ERR, opt.fnr)
            if l != k:
                sys.stderr.write("[bwa_aln] %dbp reads: max_diff = %d\n"
                                 % (i, l))
            k = l

    from ..index.fmindex import FmIndex
    fm = FmIndex.restore(args[0] + ".bwt")

    out = open(out_path, "wb") if out_path else sys.stdout.buffer
    out.write(SAI_MAGIC)
    out.write(opt.pack())
    reader = open_reads(args[1], opt.mode)
    tot = 0
    while True:
        reads = reader(0x40000, opt.trim_qual)
        if not reads:
            break
        tot += len(reads)
        t = time.process_time()
        sys.stderr.write("[bwa_aln_core] calculate SA coordinate... ")
        alns = cal_sa_reg_gap(fm, reads, opt)
        sys.stderr.write("%.2f sec\n" % (time.process_time() - t))
        t = time.process_time()
        sys.stderr.write("[bwa_aln_core] write to the disk... ")
        for a in alns:
            out.write(struct.pack("<i", len(a)))
            for x in a:
                out.write(x.pack())
        sys.stderr.write("%.2f sec\n" % (time.process_time() - t))
        sys.stderr.write("[bwa_aln_core] %d sequences have been "
                         "processed.\n" % tot)
    if out_path:
        out.close()
    return 0
