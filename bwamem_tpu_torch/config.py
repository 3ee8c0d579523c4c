"""Alignment options (mem_opt_t equivalent).

Defaults and the -A rescaling rule affect output bytes, so they mirror
the reference exactly (software/bwamem.c:45-75, software/fastmap.c:159-170).
"""

import math
from dataclasses import dataclass, field
from typing import List

MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_NO_EXACT = 0x40

MEM_MAPQ_COEF = 30.0
MEM_MAPQ_MAX = 60


def fill_scmat(a: int, b: int) -> List[int]:
    """bwa_fill_scmat (software/bwa.c:84-93): 5x5 matrix, -1 vs N."""
    mat = [0] * 25
    k = 0
    for i in range(4):
        for j in range(4):
            mat[k] = a if i == j else -b
            k += 1
        mat[k] = -1
        k += 1
    for _ in range(5):
        mat[k] = -1
        k += 1
    return mat


@dataclass
class MemOptions:
    a: int = 1                    # match score
    b: int = 4                    # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100                  # band width
    zdrop: int = 100
    T: int = 30                   # output score threshold
    flag: int = 0
    min_seed_len: int = 19
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 10000
    max_chain_gap: int = 10000
    n_threads: int = 1
    batch_size: int = 1
    chunk_size: int = 10000000
    mask_level: float = 0.50
    chain_drop_ratio: float = 0.50
    mask_level_redun: float = 0.95
    mapQ_coef_len: float = 50.0
    mapQ_coef_fac: float = field(default_factory=lambda: math.log(50))
    max_ins: int = 10000
    max_matesw: int = 100
    mat: List[int] = field(default_factory=lambda: fill_scmat(1, 4))

    # which flags were explicitly set on the command line (for -A rescale)
    _explicit: set = field(default_factory=set)

    def rescale_for_a(self) -> None:
        """When -A changes and a dependent penalty wasn't set explicitly,
        scale it by a (software/fastmap.c:159-170)."""
        if "a" not in self._explicit:
            return
        if "b" not in self._explicit:
            self.b *= self.a
        if "T" not in self._explicit:
            self.T *= self.a
        if "o_del" not in self._explicit:
            self.o_del *= self.a
        if "e_del" not in self._explicit:
            self.e_del *= self.a
        if "o_ins" not in self._explicit:
            self.o_ins *= self.a
        if "e_ins" not in self._explicit:
            self.e_ins *= self.a
        if "zdrop" not in self._explicit:
            self.zdrop *= self.a
        if "pen_clip5" not in self._explicit:
            self.pen_clip5 *= self.a
        if "pen_clip3" not in self._explicit:
            self.pen_clip3 *= self.a
        if "pen_unpaired" not in self._explicit:
            self.pen_unpaired *= self.a
