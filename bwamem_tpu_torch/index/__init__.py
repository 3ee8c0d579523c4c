from .bntseq import (BntSeq, ContigAnn, AmbHole, NT4_TABLE, fasta2bntseq,
                     bns_restore, get_seq, pac_get, unpack_bases, pack_bases)
from .fmindex import FmIndex, OCC_INTERVAL, CNT_TABLE
from .build import build_index, load_index

__all__ = [
    "BntSeq", "ContigAnn", "AmbHole", "NT4_TABLE", "fasta2bntseq",
    "bns_restore", "get_seq", "pac_get", "unpack_bases", "pack_bases",
    "FmIndex", "OCC_INTERVAL", "CNT_TABLE", "build_index", "load_index",
]
