"""Exact emulation of glibc's srand48/lrand48 48-bit LCG.

bwa index converts each ambiguous reference base (N) to a random base via
`lrand48() & 3` with a fixed seed of 11 (reference: software/bntseq.c:229,
257-258), so the .pac bytes — and every downstream alignment score near an
N hole — depend on reproducing this generator exactly.
"""

_A = 0x5DEECE66D
_C = 0xB
_M48 = (1 << 48) - 1


class Rand48:
    def __init__(self, seed: int):
        # srand48: X0 = seed<<16 | 0x330E
        self._x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self._x = (_A * self._x + _C) & _M48
        return self._x >> 17  # non-negative 31-bit result

    def drand48(self) -> float:
        """glibc drand48: the full 48-bit state scaled to [0, 1)
        (bwa-aln samples hits with it, software/bwase.c:36-40)."""
        self._x = (_A * self._x + _C) & _M48
        return self._x / float(1 << 48)
