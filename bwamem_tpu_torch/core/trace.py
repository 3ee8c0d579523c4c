"""Per-read `-v 4` algorithm tracing (SURVEY.md §5 observability).

The reference prints its bwa_verbose>=4 diagnostics inline from the
worker threads via printf/err_printf — BOTH of which write to stdout
(err_printf is an error-*checked* printf, software/utils.c:176-185),
interleaving with the SAM stream.  Our pipeline batches extension work
across reads in device waves, so the lines are instead *collected* per
read into a TraceLog
and replayed in the reference's -t1 order after each stage: for every
batch of `-b` reads, the per-read chain/extension traces followed by
the "=====> Processing read" headers (the reference's worker1_batched
prints the headers after the batch returns, software/bwamem.c:1589-1594),
then per read/pair the "=====> Finalizing" header followed by the
finalization traces (worker2, software/bwamem.c:1598-1611).

The result is byte-identical to the reference at -t1 on each stream;
with -t>1 the reference interleaves nondeterministically, so we emit
the deterministic -t1 ordering for every thread count.
"""

import sys
from typing import List


class TraceLog:
    """Collects the trace lines for one read (all destined for stdout —
    bwa's err_printf also writes to stdout, software/utils.c:181)."""

    __slots__ = ("entries",)

    def __init__(self):
        self.entries: List[str] = []

    def append(self, text: str) -> None:
        self.entries.append(text)

    err = append  # the reference's err_printf lines (also stdout)

    def __bool__(self):
        return True


def print_chain(bns, chains, trace: TraceLog) -> None:
    """mem_print_chain (software/bwamem.c:523-539): one line per chain
    listing every seed as len;qbeg,rbeg(contig:±pos1)."""
    from .chain import chain_weight
    for i, c in enumerate(chains):
        parts = ["* Found CHAIN(%d): n=%d; weight=%d"
                 % (i, c.n, chain_weight(c))]
        for rbeg, qbeg, ln in c.seeds:
            pos, is_rev = bns.depos(rbeg)
            if is_rev:
                pos -= ln - 1
            rid = bns.pos2rid(pos)
            parts.append("\t%d;%d,%d(%s:%c%d)"
                         % (ln, qbeg, rbeg, bns.anns[rid].name,
                            "+-"[int(is_rev)],
                            pos - bns.anns[rid].offset + 1))
        parts.append("\n")
        trace.err("".join(parts))


def emit(traces, out=None) -> None:
    """Replay collected traces to stdout in order."""
    out = sys.stdout if out is None else out
    for t in traces:
        if t is None:
            continue
        for text in t.entries:
            out.write(text)
    out.flush()
