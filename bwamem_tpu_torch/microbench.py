"""Microbenchmarks of the occ-row fetch on the card: the Hopper
counterparts of tools/microbench_gather.py, microbench_dmawave.py,
microbench_bigsmem.py (gw, gwk), microbench_palloop.py and
probe_mosaic_features.py.

    python -m bwamem_tpu_torch.microbench <variant> [options]

variants:
  gather  one gather of --ids rows (default 16,384 = 2 x LANES and
          262,144 = 2 x LANES x M, the backward pass's rows per
          iteration) from each table: fwd_gather (ids (2, n/2)),
          flat_gather, take (index_select) and bwd_gather (ids
          (2, LANES, n/(2 LANES))) through PyTorch indexing; kernel
          (bm_gather_rows) and occ4 (bm_occ4, keys over the table)
  chain   bm_row_chain: for each of --lanes C, --chains K chains of
          --steps T dependent fetches; `dep` at every K, the other
          --modes at K=1; ns per dependent fetch, fetched rows/s and GB/s
  loop    bm_affine_loop: --iters steps in one kernel, against --iters
          launches of one step
  probe   tools/probe_mosaic_features.py's gathers: 256 rows of an int32
          (4096, 128) table, transposed (a+b) and not (c), OK or WRONG
          RESULT against the numpy gather
  all     each of the above
  launch  the host cost of one gather_rows call of --ids rows from a
          64 MiB table of 16-word rows (not in `all`): each step of the
          call timed alone over LAUNCH_CALLS calls by
          time.perf_counter_ns (the checks; the stream handle; the input
          conversions, which are no-ops here; torch.empty; the ctypes
          call, which launches, and the same for no ids, which does not;
          the count), then the whole call by the host clock and by CUDA
          events, its device time, and index_select's

Tables are made on the device from --seed with a torch.Generator:
--tables gives their sizes in bytes (suffix K, M, G: powers of 1024),
--widths their row widths in int32 words (16: one 64-byte occ block;
128: the TPU's 512-byte row); --index PREFIX adds the occ table of a
real index.  Every line is one JSON object naming the device, the card
and its power limit, the table's size and whether it is above the 50 MB
L2.  The variants run on the card unless --device cpu is given; on the
CPU the plain versions run at the size asked for and their times are
`cpu_ms`, host times that say nothing of the card.

An occ table split by rows (ops/fm.py SplitTable, the tables of `mem
--shard-tables`) may be handed to Bench.gather in place of a tensor: it
runs the occ4 variant only, the others being gathers of a tensor.

run() takes a check callback, check(kernel, line, out, args, library),
called once for each kernel call the variants make: the kernel's name,
the line printed for the call, the call's output and the arguments it
was given (`library`: the line of `take`, for the row gather).
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .ops import occ
from .ops.fm import SplitTable

L2_BYTES = 50 * 10 ** 6       # the H100's L2
LANES, M = 8192, 16           # the main path's lanes and SMEM width
LAUNCH_CALLS = 1000           # calls each step of `launch` is timed over
_UNITS = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def parse_bytes(s: str) -> int:
    s = s.strip().upper()
    if s and s[-1] in _UNITS:
        return int(float(s[:-1]) * _UNITS[s[-1]])
    return int(s)


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def card_info(device: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi's line), or the CPU."""
    if device.type != "cuda":
        return {"device": "cpu", "card": "cpu", "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[device.index or 0]
        limit = smi.rsplit(",", 1)[1].strip()
    except (OSError, IndexError, subprocess.CalledProcessError):
        limit = "not measured"
    return {"device": "cuda", "card": torch.cuda.get_device_name(device),
            "power_limit": limit}


def make_table(n_rows: int, W: int, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """A random int32 (n_rows, W) table made on the device."""
    return torch.randint(-(1 << 31), 1 << 31, (n_rows, W), dtype=torch.int32,
                         generator=gen, device=device)


def timed(fn, device: torch.device, reps: int):
    """(milliseconds per call, last result): CUDA events over reps calls
    after one warm-up on the card; the host clock on the CPU."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            out = fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def device_ms(fn, reps: int) -> float:
    """Milliseconds per call on the card without the host's launch cost
    (which CUDA events around a loop of small calls include): reps calls
    captured in one CUDA graph, one replay timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


class Bench:
    """Runs the variants on one device and collects their lines."""

    def __init__(self, device, seed: int = 0, reps: int = 20, emit=None,
                 check=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (use --device cpu for the "
                               "plain versions)")
        self.info = card_info(self.device)
        self.seed = seed
        self.reps = reps
        self.emit = emit or (lambda line: print(json.dumps(line),
                                                flush=True))
        self.check = check or (lambda *a, **kv: None)
        self.lines = []

    def gen(self, salt: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed * 1000003 + salt)
        return g

    def line(self, variant: str, table=None, ms=None, **kv) -> dict:
        d = {"variant": variant, **self.info}
        if table is not None:
            nbytes = table.shape[0] * table.shape[1] * table.element_size()
            d.update(table_rows=int(table.shape[0]),
                     width=int(table.shape[1]), table_bytes=int(nbytes),
                     above_l2=nbytes > L2_BYTES)
            if isinstance(table, SplitTable):
                d["parts"] = [str(p.device) for p in table.parts]
        if ms is not None:
            d["ms" if self.device.type == "cuda" else "cpu_ms"] = ms
        d.update(kv)
        self.lines.append(d)
        self.emit(d)
        return d

    def _device(self, fn) -> dict:
        """device_ms of fn on the card; nothing on the CPU."""
        if self.device.type != "cuda":
            return {}
        return {"device_ms": device_ms(fn, self.reps)}

    def _rates(self, ms: float, rows: int, W: int) -> dict:
        """Rows/s and GB/s of a call: card numbers only."""
        if self.device.type != "cuda" or ms <= 0:
            return {}
        per_s = rows / (ms * 1e-3)
        return {"rows_per_s": per_s, "gb_per_s": per_s * W * 4 / 1e9}

    # -- gather ------------------------------------------------------------
    def gather(self, table, ids_counts, name: str, primary=None,
               seq_len=None):
        """Each gather variant at each id count over one table.  For occ4
        the table is an occ table; a synthetic one holds 128 x n_rows
        positions with primary at the middle.  The first occ4 keys are
        -1, 0, primary - 1, primary and seq_len - 1.  A SplitTable runs
        occ4 only."""
        n_rows, W = table.shape
        if seq_len is None:
            seq_len = n_rows * 128
            primary = seq_len // 2
        edges = torch.tensor([-1, 0, primary - 1, primary, seq_len - 1],
                             device=self.device)
        for n in ids_counts:
            g = self.gen(n)
            ids = torch.randint(0, n_rows, (n,), generator=g,
                                device=self.device, dtype=torch.int64)
            keys = torch.randint(-1, seq_len, (n,), generator=g,
                                 device=self.device, dtype=torch.int64)
            keys[:len(edges)] = edges[:n]
            m = max(n // (2 * LANES), 1)
            variants = {} if isinstance(table, SplitTable) else {
                "fwd_gather": lambda: table[ids.view(2, -1)],
                "flat_gather": lambda: table[ids],
                "take": lambda: torch.index_select(table, 0, ids),
                "bwd_gather": lambda: table[ids[:2 * LANES * m].view(
                    2, -1, m)] if n >= 2 * LANES else table[ids.view(2, -1)],
                "kernel": lambda: occ.gather_rows(table, ids),
            }
            if W == 16:
                variants["occ4"] = lambda: occ.occ4(table, primary, keys)
            lines = {}
            for v, fn in variants.items():
                ms, out = timed(fn, self.device, self.reps)
                extra = {}
                if v == "kernel":
                    extra["equal_to_index_select"] = bool(torch.equal(
                        out, torch.index_select(table, 0, ids)))
                dv = self._device(fn)
                lines[v] = ln = self.line(
                    "gather", table, ms, table_name=name, sub=v, ids=n, **dv,
                    **self._rates(dv.get("device_ms") or ms, n,
                                  16 if v == "occ4" else W), **extra)
                if v == "kernel":
                    self.check("gather_rows", ln, out, (table, ids, False),
                               library=lines["take"])
                elif v == "occ4":
                    self.check("occ4", ln, out, (table, primary, keys))

    # -- chain -------------------------------------------------------------
    def chain(self, table, name: str, lanes, steps: int, chains, modes):
        n_rows, W = table.shape
        runs = [("dep", k) for k in chains]
        runs += [(m, 1) for m in modes if m != "dep"
                 and not (m == "full" and W < 16)]
        for C in lanes:
            for mode, K in runs:
                idx0 = torch.randint(0, n_rows, (K, C), generator=self.gen(K),
                                     device=self.device, dtype=torch.int32)

                def fn():
                    return occ.row_chain(table, idx0, steps, mode)
                ms, out = timed(fn, self.device, self.reps)
                kv = self._device(fn)
                if self.device.type == "cuda":
                    t = kv["device_ms"]
                    kv.update({"ns_per_dependent_fetch": t * 1e6 / steps,
                               **self._rates(t, K * C * steps,
                                             W if mode != "null" else 0)})
                ln = self.line("chain", table, ms, table_name=name,
                               mode=mode, K=K, lanes=C, steps=steps, **kv)
                self.check("row_chain", ln, out, (table, idx0, steps, mode))

    # -- loop --------------------------------------------------------------
    def loop(self, iters: int):
        g = self.gen(iters)
        x = torch.rand((64, 128), generator=g, device=self.device)

        def in_kernel():
            return occ.affine_loop(x, iters)
        ms_in, a = timed(in_kernel, self.device, self.reps)

        def steps():
            c = x
            for _ in range(iters):
                c = occ.affine_loop(c, 1)
            return c
        ms_steps, b = timed(steps, self.device, max(self.reps // 4, 1))
        dev = {}
        if self.device.type == "cuda":
            dev = {"device_ms_in_kernel": device_ms(in_kernel, self.reps),
                   "device_ms_launch_per_step": device_ms(steps, 2)}
        ln = self.line("loop", None, None, shape=[64, 128], iters=iters,
                       **dev, **{("ms_in_kernel" if self.device.type == "cuda"
                                  else "cpu_ms_in_kernel"): ms_in,
                                 ("ms_launch_per_step"
                                  if self.device.type == "cuda"
                                  else "cpu_ms_launch_per_step"): ms_steps},
                       max_abs_diff=float((a - b).abs().max()))
        self.check("affine_loop", ln, a, (x, iters))

    # -- probe -------------------------------------------------------------
    def probe(self):
        C, NR = 256, 4096
        g = self.gen(NR)
        table = make_table(NR, 128, g, self.device)
        ids = torch.randint(0, NR, (C,), generator=g, device=self.device,
                            dtype=torch.int64)
        tb, ix = table.cpu().numpy(), ids.cpu().numpy()
        for sub, transpose, want in (
                ("a+b: index vector + gather + transpose", True, tb[ix].T),
                ("c: gather by loop-issued copies", False, tb[ix])):
            def fn():
                return occ.gather_rows(table, ids, transpose)
            ms, out = timed(fn, self.device, self.reps)
            ln = self.line("probe", table, ms, table_name=f"probe_{NR}x128",
                           sub=sub, rows=C, **self._device(fn),
                           result="OK" if np.array_equal(out.cpu().numpy(),
                                                         want)
                           else "WRONG RESULT")
            self.check("gather_rows", ln, out, (table, ids, transpose))


def launch_cost(table: torch.Tensor, n: int, seed: int = 0) -> dict:
    """The host cost of ``occ.gather_rows`` at n ids of table, step by
    step: each step alone over LAUNCH_CALLS calls, ns per call by
    time.perf_counter_ns; then the whole call (enqueue, by the host
    clock; and by CUDA events over LAUNCH_CALLS calls, with its device
    time by CUDA-graph replay) beside index_select.  Launches made here
    are not counted: the ctypes step calls the entry point directly."""
    from .ops import _kernels
    dev = table.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ids = torch.randint(0, table.shape[0], (n,), generator=g, device=dev,
                        dtype=torch.int64)
    idx = _kernels.card_of(ids, "launch_cost")
    lib = _kernels.library()
    out = torch.empty((n, table.shape[1]), dtype=torch.int32, device=dev)
    args = (table.data_ptr(), table.shape[0], table.shape[1], ids.data_ptr(),
            n, 0, out.data_ptr())
    entry = lib.bm_gather_rows
    scratch = _kernels.Kernel("launch_cost", "", "", "bm_gather_rows")

    def per_call(fn):
        fn()
        t0 = time.perf_counter_ns()
        for _ in range(LAUNCH_CALLS):
            fn()
        dt = time.perf_counter_ns() - t0
        torch.cuda.synchronize(dev)
        return dt / LAUNCH_CALLS

    def checks():
        occ._table_on_card(table)
        if ids.get_device() != idx:
            raise ValueError("another card")

    raw = _kernels._raw_stream
    steps = {
        "checks": checks,
        "device_guard": lambda: _kernels._current_card() == idx,
        "stream": lambda: raw(idx),
        "convert": lambda: ids.dtype is torch.int64 and ids.is_contiguous(),
        "empty": lambda: torch.empty(n, table.shape[1], dtype=torch.int32,
                                     device=dev),
        "ctypes_call": lambda: entry(*args, raw(idx)),
        # the same call for no ids: ctypes and cudaGetLastError, no launch
        "ctypes_no_launch": lambda: entry(*args[:4], 0, *args[5:], raw(idx)),
        "count": lambda: scratch.count(idx),
    }
    res = {"ids": n, "calls": LAUNCH_CALLS,
           "steps_ns": {k: per_call(fn) for k, fn in steps.items()}}

    def call():
        return occ.gather_rows(table, ids)

    def take():
        return torch.index_select(table, 0, ids)
    for name, fn in (("call", call), ("index_select", take)):
        res[f"{name}_host_ns"] = per_call(fn)
        res[f"{name}_ms"] = timed(fn, dev, LAUNCH_CALLS)[0]
        res[f"{name}_device_ms"] = device_ms(fn, 20)
    if not torch.equal(call(), take()):
        raise RuntimeError("gather_rows differs from index_select")
    return res


def load_occ_table(prefix: str, device, parts: int = 1):
    """(blocks, primary, seq_len) of an index's occ table, on the device:
    whole, or with parts > 1 a SplitTable of that many parts there."""
    from .index import load_index
    from .ops.fm import DeviceFmIndex
    fm, _ = load_index(prefix)
    d = DeviceFmIndex.from_host(fm)
    blocks = d.blocks.to(device) if parts == 1 \
        else SplitTable.cut(d.blocks, [device] * parts)
    return blocks, d.primary_int, d.seq_len_int


def run(args, emit=None, check=None) -> list:
    """The variants that args ask for; returns their lines (each also
    passed to emit, by default printed as JSON).  check: see the module's
    docstring."""
    b = Bench(args.device, args.seed, args.reps, emit, check)
    if args.variant == "launch":
        if b.device.type != "cuda":
            raise ValueError("launch measures the card's launch path: it "
                             "has no CPU version")
        table = make_table((64 << 20) // 64, 16, b.gen(1), b.device)
        for n in _ints(args.ids):
            b.line("launch", table, None,
                   **launch_cost(table, n, args.seed))
        return b.lines
    variants = (("gather", "chain", "loop", "probe") if args.variant == "all"
                else (args.variant,))
    sizes = [parse_bytes(s) for s in args.tables.split(",") if s]
    widths = _ints(args.widths)
    modes = [occ.MODE_ALIASES.get(m, m) for m in args.modes.split(",") if m]
    if "gather" in variants or "chain" in variants:
        tables = [(nb, w) for w in widths for nb in sizes]
        if args.index:
            tables.append((None, 16))
        for nb, w in tables:
            if nb is None:
                table, primary, seq_len = load_occ_table(args.index,
                                                         b.device)
                name = f"index:{args.index}"
            else:
                rows = max(nb // (4 * w), 1)
                table = make_table(rows, w, b.gen(rows * w), b.device)
                primary = seq_len = None
                name = f"random_{nb}B_w{w}"
            if "gather" in variants and w == 16:
                b.gather(table, _ints(args.ids), name, primary, seq_len)
            if "chain" in variants:
                b.chain(table, name, _ints(args.lanes), args.steps,
                        _ints(args.chains), modes)
            del table
            if b.device.type == "cuda":
                torch.cuda.empty_cache()
    if "loop" in variants:
        b.loop(args.iters)
    if "probe" in variants:
        b.probe()
    return b.lines


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m bwamem_tpu_torch.microbench",
        description=__doc__.split("\n\n")[0])
    p.add_argument("variant", choices=("gather", "chain", "loop", "probe",
                                       "all", "launch"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--tables", default="4M,64M,4G",
                   help="table sizes in bytes (K, M, G suffixes)")
    p.add_argument("--widths", default="16,128",
                   help="row widths in int32 words")
    p.add_argument("--index", default=None,
                   help="also the occ table of this index prefix")
    p.add_argument("--ids", default=f"{2 * LANES},{2 * LANES * M}")
    p.add_argument("--lanes", default=str(LANES),
                   help="lanes C of the chains, comma-separated")
    p.add_argument("--steps", type=int, default=256)
    p.add_argument("--chains", default="1,2,4,8")
    p.add_argument("--modes", default=",".join(occ.CHAIN_MODES))
    p.add_argument("--iters", type=int, default=256)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("microbench: no CUDA device (--device cpu runs the "
                         "plain versions)\n")
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
