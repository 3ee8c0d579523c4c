"""Reads-axis data parallelism over several devices (port of
bwamem_tpu/parallel/mesh.py).

The JAX package shards every device dispatch of ``mem`` over a 1-D
``reads`` mesh with shard_map: the FM index replicated on every chip and
each per-lane array split across the chips.  Here a mesh is an ordered
tuple of ``torch.device``s (``make_mesh``).  A device may repeat: the
shards then share it, as the JAX tests' shards share one CPU through 8
virtual devices.

``ShardedKernels`` holds the index on each distinct device and is
the engine's one way to its seeding (fused, or the superstep alone on the
unfused route), SA-walk and SW kernels: over a
mesh, or over the engine's one device.  Each call splits the lane axis
into one contiguous block per shard, moves each block from the host
straight to its shard's device, and calls the single-device wrapper
there: the CUDA kernel for a card, the plain version on the CPU.  It
launches every shard before it reads anything back, so distinct cards
run at once, and reads no device value on the host
(tests/test_torch_launch.py walks its methods).  Outputs come back in
lane order as ``Lanes``, whose ``cpu()`` fetches the shards and
concatenates them.  The fused seeding call is the exception: its compact
wire is per lane group, so ``superstep`` returns each shard's lane
bounds and result, and the seeder takes each as a group of its own.  A
kernel's launches per card are counted where it launches
(``_kernels.Kernel.by_card``), not here.

``pestat_histograms``, ``sharded_smem1`` and ``sharded_sa_lookup`` are
ports of the JAX module's functions that ``mem`` does not call (the
insert-size statistics are computed per chunk on the host, and the
iterator steps of ``BWAMEM_TPU_SUPERSTEP=0`` run on the mesh's first
device, as in the JAX engine); the sharded dry run of graft_entry.py
calls them, as the JAX ``__graft_entry__.py`` does.  ``pad_to_shards``
and ``READS_AXIS`` are ported for parity.  The tests hold them to the
JAX functions.

Row-split tables (``ShardedKernels(..., shard_tables=True)``, ``mem
--shard-tables``, the JAX package's ``shard_tables=True``): the occ
table and the sampled SA are cut into one contiguous part per shard, in
mesh order, each part on its shard's device (ops/fm.py
``DeviceFmIndex.split``), so each card holds 1/n of them.  The lanes
split as before; each shard's kernels read every part in place, a peer
card's rows over NVLink, with peer access enabled for every ordered pair
of distinct cards.  The JAX package turns every table gather into an
all_gather of the indices, a local gather and a psum_scatter, because a
TPU core cannot load another chip's memory; an H100 can, so there is no
collective here, and nothing like its ``global_any`` to keep the shards'
loop trips in step.
"""

from typing import Optional

import numpy as np
import torch

from ..ops import _kernels
from ..ops.fm import DeviceFmIndex, sa_lookup
from ..ops.ksw import (ksw_extend2_batched, ksw_extend_lr_batched,
                       ksw_global2_batched)
from ..ops.smem import smem_iter_step, smem_superstep_sa, superstep

READS_AXIS = "reads"
MAX_ISIZE = 65536   # insert sizes past this are clamped into the tail


def _device(d) -> torch.device:
    """d as a torch.device, a card always with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda"):
    """The first n_devices cards, every card when None (as
    ``jax.devices()[:n]``); with device "cpu", n_devices CPU shards (one
    when None).  A tuple of torch.devices."""
    if torch.device(device).type == "cpu":
        return (torch.device("cpu"),) * (n_devices or 1)
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device")
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    return devs if n_devices is None else devs[:n_devices]


def shard_bounds(n_lanes: int, n_shards: int):
    """(lo, hi) of each shard's contiguous block of lanes, in order; the
    blocks differ by at most one lane."""
    return [(s * n_lanes // n_shards, (s + 1) * n_lanes // n_shards)
            for s in range(n_shards)]


def pad_to_shards(arr: np.ndarray, n_shards: int, fill) -> np.ndarray:
    """Pad the leading dim to a multiple of the shard count."""
    n = arr.shape[0]
    rem = (-n) % n_shards
    if rem == 0:
        return arr
    pad = np.full((rem,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def local_pestat(isize: torch.Tensor, orient: torch.Tensor):
    """Per-orientation counts int64[4] and the insert-size histogram
    int32[4, MAX_ISIZE] of one shard's observations (orient -1: none;
    sizes clamped to [0, MAX_ISIZE))."""
    valid = orient >= 0
    o = torch.where(valid, orient, torch.zeros_like(orient)).to(torch.int64)
    v = torch.where(valid, isize, torch.zeros_like(isize)).to(
        torch.int64).clamp(0, MAX_ISIZE - 1)
    hist = torch.zeros(4 * MAX_ISIZE, dtype=torch.int32, device=isize.device)
    hist.index_add_(0, o * MAX_ISIZE + v, valid.to(torch.int32))
    counts = torch.zeros(4, dtype=torch.int64, device=isize.device)
    counts.index_add_(0, o, valid.to(torch.int64))
    return counts, hist.view(4, MAX_ISIZE)


def pestat_histograms(mesh):
    """The JAX mesh's reduction across shards (graft_entry's dry run):
    insert-size observations (isize int64[B], orientation int32[B], -1 =
    none) split over the mesh, each shard's counts and histogram
    (local_pestat) on its device, summed over the shards on the mesh's
    first device.  Returns
    fn(isize, orient) -> (counts int64[4], hist int32[4, MAX_ISIZE])."""
    devs = tuple(_device(d) for d in mesh)

    def fn(isize, orient):
        isize, orient = torch.as_tensor(isize), torch.as_tensor(orient)
        parts = [local_pestat(isize[lo:hi].to(d), orient[lo:hi].to(d))
                 for d, (lo, hi) in zip(devs, shard_bounds(len(isize),
                                                           len(devs)))]
        counts = sum(c.to(devs[0]) for c, _ in parts)
        hist = sum(h.to(devs[0]) for _, h in parts)
        return counts, hist
    return fn


class Lanes:
    """One output of a sharded call: each shard's part on its device, in
    lane order.  ``cpu()`` fetches the parts and concatenates them, so a
    caller that fetches with ``t.cpu()`` takes it as it takes a
    tensor."""

    def __init__(self, parts):
        self.parts = parts

    def cpu(self) -> torch.Tensor:
        if len(self.parts) == 1:
            return self.parts[0].cpu()
        return torch.cat([p.cpu() for p in self.parts])


def _lanes_of(outs):
    """((lo, hi), output tuple) per shard -> one Lanes per output."""
    return tuple(Lanes([o[j] for _, o in outs])
                 for j in range(len(outs[0][1])))


def _host(a) -> torch.Tensor:
    """A lane array held on the host, as a tensor (no copy)."""
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


class ShardedKernels:
    """Reads-axis wrappers of every device call the engine makes: the
    fused seeding call, the SA walk, the iterator step and the three SW
    waves.  The index and the scoring matrix are replicated per device
    (with shard_tables, the index's occ table and sampled SA are split
    over the shards instead); every per-lane array is split across the
    mesh (JAX parallel/mesh.py:114).  A one-device mesh is the
    single-device call."""

    def __init__(self, mesh, dfm: DeviceFmIndex, shard_tables: bool = False):
        self.mesh = tuple(_device(d) for d in mesh)
        self.n = len(self.mesh)
        self.shard_tables = shard_tables
        self._index = {}
        if shard_tables:
            split = dfm.split(self.mesh)
            cards = sorted({d.index for d in self.mesh if d.type == "cuda"})
            for a in cards:
                for b in cards:
                    _kernels.enable_peer(a, b)
        for d in self.mesh:
            if d not in self._index:
                self._index[d] = split.on(d) if shard_tables \
                    else dfm.replica(d)
        self._copies = {}   # (id(t), device) -> (t, its copy there)

    def index_on(self, device):
        """The index on one of the mesh's devices: its replica there, or
        with shard_tables a view over every part (SplitFmIndex)."""
        return self._index[_device(device)]

    def _replica(self, t: torch.Tensor, d: torch.device) -> torch.Tensor:
        """t's copy on d, made once per tensor and device."""
        key = (id(t), d)
        got = self._copies.get(key)
        if got is None or got[0] is not t:
            got = self._copies[key] = (t, t.to(d))
        return got[1]

    def _run(self, fn, args, lanes, index: bool = False, **kw):
        """fn on every shard: the args at positions `lanes` split into
        the shards' blocks on their devices, every other tensor
        replicated, the rest passed as they are; with `index` the shard's
        index goes first.  Every shard is launched before any
        output is touched.  Returns ((lo, hi), output) per shard, in
        order."""
        bounds = shard_bounds(len(args[lanes[0]]), self.n)
        outs = []
        for d, (lo, hi) in zip(self.mesh, bounds):
            shard = [self._index[d]] if index else []
            for i, a in enumerate(args):
                if i in lanes:
                    a = _host(a)[lo:hi].to(d)
                elif isinstance(a, torch.Tensor):
                    a = self._replica(a, d)
                shard.append(a)
            outs.append(((lo, hi), fn(*shard, **kw)))
        return outs

    def superstep(self, q_pk, qlen, min_intv, active, split_len,
                  split_width, min_seed_len: int, max_occ: int, *, L: int,
                  M: int, OUT_CAP: int, GCAP: int, KEY_CAP: int,
                  SA_STEPS: int):
        """ops.smem.smem_superstep_sa per shard (GCAP and KEY_CAP are a
        shard's); returns ((lo, hi), result) per shard in lane order, one
        compact wire each."""
        return self._run(
            smem_superstep_sa,
            (q_pk, qlen, min_intv, active, split_len, split_width,
             min_seed_len, max_occ), _SUPERSTEP_LANES, index=True, L=L,
            M=M, OUT_CAP=OUT_CAP, GCAP=GCAP, KEY_CAP=KEY_CAP,
            SA_STEPS=SA_STEPS)

    def superstep_unfused(self, q_pk, qlen, min_intv, active, split_len,
                          split_width, *, L: int, M: int, OUT_CAP: int):
        """ops.smem.superstep (the superstep alone, per-lane streams of
        OUT_CAP slots, no compact wire) over the mesh; Lanes outputs (o0,
        os, oqb, oqe, n_out, over), the unfused route's (JAX
        parallel/mesh.py superstep with GCAP=0)."""
        return _lanes_of(self._run(
            superstep, (q_pk, qlen, min_intv, active, split_len,
                        split_width), _SUPERSTEP_LANES, index=True, L=L,
            M=M, OUT_CAP=OUT_CAP))

    def smem1(self, q_pk, qlen, x, min_intv, active, split_len, split_width,
              *, L: int, M: int, M_OUT: int):
        """ops.smem.smem_iter_step (one iterator step: the smem1 pass, the
        re-seeding test and pass 2) over the mesh; Lanes outputs."""
        return _lanes_of(self._run(
            smem_iter_step,
            (q_pk, qlen, x, min_intv, active, split_len, split_width),
            _SMEM1_LANES, index=True, L=L, M=M, M_OUT=M_OUT))

    def sa_lookup(self, k, max_steps: int):
        """ops.fm.sa_lookup over the mesh: (vals, over) as Lanes."""
        return _lanes_of(self._run(sa_lookup, (k, max_steps), _SA_LANES,
                                   index=True))

    def extend_lr(self, *args, LQ: int, LT: int):
        """ksw_extend_lr_batched over the mesh (its arguments: eight lane
        arrays, mat, eight scalars, six lane arrays)."""
        return _lanes_of(self._run(ksw_extend_lr_batched, args,
                                   _EXTEND_LR_LANES, LQ=LQ, LT=LT))

    def extend2(self, *args, LQ: int, LT: int):
        """ksw_extend2_batched over the mesh (query, target, qlen, tlen,
        mat, four gap scalars, w, end_bonus, zdrop, h0)."""
        return _lanes_of(self._run(ksw_extend2_batched, args,
                                   _EXTEND2_LANES, LQ=LQ, LT=LT))

    def global2(self, *args, LQ: int, LT: int):
        """ksw_global2_batched over the mesh (query, target, qlen, tlen,
        mat, four gap scalars, w)."""
        return _lanes_of(self._run(ksw_global2_batched, args,
                                   _GLOBAL2_LANES, LQ=LQ, LT=LT))


# the lane arguments of each wrapper, by position
_SUPERSTEP_LANES = (0, 1, 2, 3, 4, 5)
_SMEM1_LANES = (0, 1, 2, 3, 4, 5, 6)
_SA_LANES = (0,)
_EXTEND_LR_LANES = tuple(range(8)) + tuple(range(17, 23))
_EXTEND2_LANES = (0, 1, 2, 3, 9, 10, 12)
_GLOBAL2_LANES = (0, 1, 2, 3, 9)


def sharded_smem1(mesh, dfm: DeviceFmIndex, L: int, M: int,
                  M_OUT: Optional[int] = None):
    """One SMEM iterator step sharded over the reads axis, the index
    replicated (JAX parallel/mesh.py:39; graft_entry's dry run): returns
    fn(q_pk, qlen, x, min_intv, active, split_len, split_width) with
    Lanes outputs, those of ops.smem.smem_iter_step."""
    sk = ShardedKernels(mesh, dfm)

    def run(q_pk, qlen, x, min_intv, active, split_len, split_width):
        return sk.smem1(q_pk, qlen, x, min_intv, active, split_len,
                        split_width, L=L, M=M, M_OUT=M_OUT or M)
    return run


def sharded_sa_lookup(mesh, dfm: DeviceFmIndex, max_steps: int = 128):
    """The batched SA walk sharded over the reads axis (JAX
    parallel/mesh.py:64; graft_entry's dry run; ``mem`` calls
    ShardedKernels.sa_lookup instead):
    returns fn(k) -> (vals, over) as Lanes."""
    sk = ShardedKernels(mesh, dfm)

    def run(k):
        return sk.sa_lookup(k, max_steps)
    return run
