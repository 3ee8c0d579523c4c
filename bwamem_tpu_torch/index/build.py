"""`index` command driver: FASTA -> .pac/.ann/.amb/.bwt/.sa artifacts,
byte-identical to bwa 0.7.8's `bwa index`
(reference: software/bwtindex.c:187-287).

The reference writes a doubled (forward+reverse-complement) .pac first,
builds the BWT from it, then overwrites .pac/.ann/.amb with forward-only
versions; the surviving artifacts are forward-only, so we produce those
directly and feed the doubled base string straight to the FM-index
builder.
"""

import os
import sys
import numpy as np

from .bntseq import (BntSeq, fasta2bntseq, dump_ann_amb, dump_pac,
                     unpack_bases, bns_restore)
from .fmindex import FmIndex

# streaming (bounded-memory) construction engages automatically past
# this doubled-text size: the whole-text SA-IS path peaks at ~11 B/char
# there (int64 SA), the streaming path at ~1.7 B/char + the sa8 sample
_STREAM_AUTO_CHARS = 1 << 31


def _pac_base_counts(pac: np.ndarray, l_pac: int) -> np.ndarray:
    """Per-base counts of the forward pac without unpacking (a 1 B/char
    temporary at Gbp scale)."""
    tbl = np.zeros((256, 4), dtype=np.int64)
    for b in range(256):
        for s in (6, 4, 2, 0):
            tbl[b, (b >> s) & 3] += 1
    counts = np.zeros(4, dtype=np.int64)
    full = l_pac >> 2
    for lo in range(0, full, 1 << 26):
        chunk = pac[lo:min(lo + (1 << 26), full)]
        counts += np.bincount(chunk, minlength=256) @ tbl
    for i in range(full << 2, l_pac):
        counts[(pac[i >> 2] >> ((~i & 3) << 1)) & 3] += 1
    return counts


def _build_streaming(pac_fwd: np.ndarray, l_pac: int, sa_intv: int,
                     log) -> FmIndex:
    """Bounded-memory FmIndex construction (the software/bwt_gen.c
    role, selected at software/bwtindex.c:239): incremental BWT merge
    straight from the pac (native/bwtinc.cpp), then the inverse-Psi
    walk for the SA samples.  Byte-identical artifacts to
    FmIndex.build (tests/test_bwtinc.py)."""
    from . import nsa
    assert sa_intv % 8 == 0, "streaming path samples SA via intv-8 walk"
    n = 2 * l_pac
    fm = FmIndex()
    fm.seq_len = n
    cf = _pac_base_counts(pac_fwd, l_pac)
    counts = cf + cf[::-1]          # revcomp half: base c appears as 3-c
    fm.L2 = np.zeros(5, dtype=np.int64)
    fm.L2[1:] = np.cumsum(counts)

    block = int(os.environ.get("BWAMEM_TPU_STREAM_BLOCK",
                               str(1 << 27)))
    log("[bwa_index] Streaming BWT merge (block=%d chars)..." % block)
    fm.bwt, fm.primary = nsa.build_bwt_streaming(pac_fwd, l_pac, block)

    log("[bwa_index] SA sample walk...")
    sa8 = nsa.sa_walk_streaming(fm.bwt, n, fm.primary, fm.L2)
    n_sa = (n + sa_intv) // sa_intv
    fm.sa_intv = sa_intv
    fm.sa = sa8[::sa_intv // 8][:n_sa].copy()
    fm.sa[0] = -1
    if sa_intv > 8:
        fm.sa8_intv = 8
        fm.sa8 = sa8
    return fm


def build_index(fasta_path: str, prefix: str = None, sa_intv: int = 32,
                verbose: bool = True, streaming: bool = None) -> None:
    if prefix is None:
        prefix = fasta_path

    def log(msg):
        if verbose:
            print(msg, file=sys.stderr)

    log("[bwa_index] Pack FASTA... ")
    bns, pac_fwd = fasta2bntseq(fasta_path, for_only=True)
    dump_pac(pac_fwd, bns.l_pac, prefix + ".pac")
    dump_ann_amb(bns, prefix)

    if streaming is None:
        env = os.environ.get("BWAMEM_TPU_STREAM_INDEX", "auto")
        if env == "auto":
            streaming = 2 * bns.l_pac >= _STREAM_AUTO_CHARS
        else:
            streaming = env != "0"
    if streaming:
        from . import nsa
        if not (nsa.streaming_available() and sa_intv % 8 == 0):
            streaming = False

    if streaming:
        fm = _build_streaming(pac_fwd, bns.l_pac, sa_intv, log)
    else:
        # doubled sequence for BWT: forward bases + reverse complement
        fwd = unpack_bases(pac_fwd, bns.l_pac)
        doubled = np.concatenate([fwd, (3 - fwd)[::-1]])
        del fwd  # at Gbp scale every live n-sized temporary counts
        log("[bwa_index] Construct BWT + occ + sampled SA...")
        fm = FmIndex.build(doubled, sa_intv=sa_intv)
        del doubled
    fm.dump_bwt(prefix + ".bwt")
    fm.dump_sa(prefix + ".sa")
    if fm.sa8 is not None:
        fm.dump_sa8(prefix + ".sa8")   # device-speed sidecar (ours)
    log("[bwa_index] done")


def load_index(prefix: str, load_sa8: bool = True):
    """bwa_idx_load(BWA_IDX_ALL) equivalent: returns (FmIndex, BntSeq with
    pac loaded) (reference: software/bwa.c:312-334).  load_sa8=False
    skips the dense-SA device sidecar (used only by ops.fm device
    upload) — host-only consumers like spawn workers save its ~1 GB/Gbp
    of RSS and disk I/O."""
    fm = FmIndex.restore(prefix + ".bwt", prefix + ".sa")
    if load_sa8:
        fm.restore_sa8(prefix + ".sa8")
    bns = bns_restore(prefix, load_pac_file=True)
    return fm, bns
