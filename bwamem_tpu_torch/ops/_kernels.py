"""Build, load, launch and count the hand-written CUDA kernels.

The kernels live in ``bwamem_tpu_torch/csrc`` as plain-C entry points
(no PyTorch headers), built with nvcc for ``sm_90a`` into one shared
library under ``bwamem_tpu_torch/_build`` at first use, keyed by a hash
of the sources, and loaded with ctypes.  Each source compiles in its own
nvcc process, all started together, and one more links them.  Every
entry returns ``cudaGetLastError()``.

Each kernel has a ``Kernel`` record holding its entry point and its
launch count.  ``Kernel.launch`` is the one launch path of every wrapper:
the entry point is resolved once, every argument is a plain int (a
pointer from ``data_ptr()``, a size), the stream is the current stream's
raw handle, read without building a ``torch.cuda.Stream``, and the call
raises when the entry returns an error.  A ``<<<...>>>`` launch goes to
the current card, so the call runs with the tensors' card current: where
another card is current (a shard of a mesh, a process on ``cuda:1``) it
is made current around the call and the previous one restored, and
where it is current already nothing is set.  It adds one to the count, to
the count of the card it launched on (``by_card``), and to that of the
launch's shape bucket where the kernel has several (``L256``,
``LQ512``), so a run can show which cards and buckets it went through.  A launch
never synchronises: no wrapper reads a device value on the host.  A
length that a caller holds on the host (a CPU tensor) is checked there
(``check_host_lengths``); a length on the card is not read, and each
kernel bounds its reads by its bucket instead.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("smem.cu", "sa.cu", "extend.cu", "global.cu", "align.cu",
           "extbuild.cu", "occ.cu", "microbench.cu")
HEADERS = ("fm.cuh", "team.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Kernel:
    """A kernel's identity, its entry point and its launch counts: in
    all, per card and per shape bucket."""

    def __init__(self, name: str, source: str, replaces: str, entry: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.entry = entry
        self.by_card = {}   # card index -> launches
        self.buckets = {}   # "<name>_<bucket>" -> launches
        self._lock = threading.Lock()
        self._fn = None

    @property
    def launches(self) -> int:
        """Launches on every card."""
        with self._lock:
            return sum(self.by_card.values())

    def count(self, card: int, bucket: str = "") -> None:
        with self._lock:
            self.by_card[card] = self.by_card.get(card, 0) + 1
            if bucket:
                key = f"{self.name}_{bucket}"
                self.buckets[key] = self.buckets.get(key, 0) + 1

    def launch(self, device_index: int, *args, bucket: str = "") -> None:
        """Call the entry point with args (plain ints) and the current
        stream of card device_index, with that card current, raise if the
        launch was refused, and count it."""
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(library(), self.entry)
        if _current_card() == device_index:
            rc = fn(*args, _raw_stream(device_index))
        else:
            prev = _enter_card(device_index)
            try:
                rc = fn(*args, _raw_stream(device_index))
            finally:
                _leave_card(prev)
        if rc:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc}")
        self.count(device_index, bucket)


SMEM = Kernel("smem_superstep", "bwamem_tpu_torch/csrc/smem.cu",
              "bwamem_tpu/ops/pallas_smem.py:1405", "bm_smem_superstep")
SA = Kernel("sa_walk", "bwamem_tpu_torch/csrc/sa.cu",
            "bwamem_tpu/ops/pallas_smem.py:1626", "bm_sa_walk")
EXTEND = Kernel("extend_lr", "bwamem_tpu_torch/csrc/extend.cu",
                "bwamem_tpu/ops/pallas_extend.py:285", "bm_extend_lr")
EXTEND2 = Kernel("extend2", "bwamem_tpu_torch/csrc/extend.cu",
                 "bwamem_tpu/ops/pallas_extend.py:285", "bm_extend2")
GLOBAL2 = Kernel("global2", "bwamem_tpu_torch/csrc/global.cu",
                 "bwamem_tpu/ops/pallas_global.py:266", "bm_global2")
ALIGN2 = Kernel("align2", "bwamem_tpu_torch/csrc/align.cu",
                "bwamem_tpu/ops/pallas_align.py:180", "bm_align2")
SMEM1 = Kernel("smem1_step", "bwamem_tpu_torch/csrc/smem.cu",
               "bwamem_tpu/ops/pallas_smem.py:1350 and "
               "bwamem_tpu/ops/pallas_bigsmem.py:612", "bm_smem_iter_step")
BUILD = Kernel("build_rows", "bwamem_tpu_torch/csrc/extbuild.cu",
               "bwamem_tpu/ops/pallas_extbuild.py:245", "bm_build_rows")
GATHER = Kernel("gather_rows", "bwamem_tpu_torch/csrc/occ.cu",
                "bwamem_tpu/ops/pallas_occ.py:90, "
                "bwamem_tpu/ops/pallas_onehot.py:68 and "
                "tools/probe_mosaic_features.py:62,114", "bm_gather_rows")
OCC4 = Kernel("occ4", "bwamem_tpu_torch/csrc/occ.cu",
              "bwamem_tpu/ops/pallas_occ.py:90 (occ4_via_pallas)", "bm_occ4")
CHAIN = Kernel("row_chain", "bwamem_tpu_torch/csrc/microbench.cu",
               "tools/microbench_dmawave.py:109 and "
               "tools/microbench_bigsmem.py:165,179,261", "bm_row_chain")
LOOP = Kernel("affine_loop", "bwamem_tpu_torch/csrc/microbench.cu",
              "tools/microbench_palloop.py:51", "bm_affine_loop")
KERNELS = (SMEM, SA, EXTEND, EXTEND2, GLOBAL2, ALIGN2, SMEM1, BUILD, GATHER,
           OCC4, CHAIN, LOOP)


def reset_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.by_card = {}
            k.buckets = {}


_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "bm_smem_superstep": [_VP, _I64, _I64, _VP, _VP, _I, _VP, _VP, _VP,
                          _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                          _VP, _VP],
    "bm_sa_walk": [_VP, _I64, _I64, _VP, _VP, _I, _I64, _VP, _I, _I, _VP,
                   _I, _VP, _VP],
    "bm_extend_lr": [_I, _I, _I] + [_VP] * 9 + [_I] * 8 + [_VP] * 14,
    "bm_extend2": [_I, _I, _I] + [_VP] * 5 + [_I] * 4 + [_VP] * 2 + [_I]
                  + [_VP] * 8,
    "bm_global2": [_I, _I, _I] + [_VP] * 6 + [_I] * 4 + [_VP] * 6,
    "bm_align2": [_I, _I, _I, _I] + [_VP] * 6 + [_I] * 5 + [_VP] * 7,
    "bm_smem_iter_step": [_VP, _I64, _I64, _VP, _VP, _I] + [_VP] * 6
                         + [_I, _I, _I, _VP, _VP, _VP, _VP],
    "bm_build_rows": [_VP, _I, _I, _VP, _I64, _I64] + [_VP] * 7
                     + [_I, _I, _I] + [_VP] * 5,
    "bm_gather_rows": [_VP, _I64, _I, _VP, _I64, _I, _VP, _VP],
    "bm_occ4": [_VP, _I64, _I64, _VP, _I64, _VP, _VP],
    "bm_row_chain": [_VP, _I64, _I, _VP, _I64, _I, _I, _I, _VP, _VP],
    "bm_affine_loop": [_VP, _I64, _I, _VP, _VP],
}

_lib = None
_lib_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_log() -> str:
    """nvcc's output of the last build (registers, spills per kernel)."""
    p = BUILD_DIR / "build.log"
    return p.read_text() if p.exists() else ""


def _build(so: Path) -> None:
    """One nvcc per source, all at once, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                               str(CSRC / s)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    log, failed = [], False
    for s, p in zip(SOURCES, procs):
        log.append(f"== {s}\n{p.communicate()[0]}")
        failed |= p.returncode != 0
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp)] + [str(o) for o in objs],
                             capture_output=True, text=True)
        log.append(f"== link\n{res.stdout}{res.stderr}")
        failed = res.returncode != 0
    for o in objs:
        o.unlink(missing_ok=True)
    (BUILD_DIR / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(log))
    os.replace(tmp, so)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / f"libbwamem_torch_{_digest()}.so"
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def _raw_stream(device_index: int) -> int:
    """The current stream's handle on card device_index as an int, read
    without building a torch.cuda.Stream."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _current_card() -> int:
    """The calling thread's current card."""
    return torch._C._cuda_getDevice()


def _enter_card(idx: int) -> int:
    """Make card idx current for the calling thread; returns the card
    that was."""
    return torch.cuda._exchange_device(idx)


def _leave_card(prev: int) -> None:
    """Make card prev current again, as torch.cuda.device does on exit
    (without creating a context on a card that has none)."""
    torch.cuda._maybe_exchange_device(prev)


def card_of(t: torch.Tensor, what: str) -> int:
    """The index of the card that t lies on; ValueError for a CPU
    tensor."""
    idx = t.get_device()
    if idx < 0:
        raise ValueError(f"{what} expects CUDA tensors, got one on the CPU")
    return idx


def on_card(t: torch.Tensor, dtype: torch.dtype, idx: int) -> torch.Tensor:
    """t as a contiguous dtype tensor on card idx, converted only where it
    is not one already (a bool tensor is taken as its uint8 bytes)."""
    if dtype is torch.uint8 and t.dtype is torch.bool:
        t = t.view(torch.uint8)
    if t.dtype is dtype and t.get_device() == idx and t.is_contiguous():
        return t
    return t.to(device=torch.device("cuda", idx), dtype=dtype).contiguous()


def on_card_all(idx: int, *pairs) -> list:
    """on_card of each (tensor, dtype) pair."""
    return [on_card(t, dt, idx) for t, dt in pairs]


def check_host_lengths(what: str, *checks) -> None:
    """ValueError where a length held on the host exceeds its bucket:
    checks are (name, lengths, bucket), lengths a tensor or array.
    Lengths on the card are not read (that would synchronise); the
    kernel bounds its reads by the bucket."""
    for name, t, cap in checks:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            continue
        if len(t) and int(t.max()) > cap:
            raise ValueError(f"{what}: a {name} exceeds its bucket {cap}")

