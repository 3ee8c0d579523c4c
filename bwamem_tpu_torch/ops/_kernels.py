"""Build, load and count the hand-written CUDA kernels.

The kernels live in ``bwamem_tpu_torch/csrc`` as plain-C entry points
(no PyTorch headers), built with nvcc for ``sm_90a`` into one shared
library under ``bwamem_tpu_torch/_build`` at first use, keyed by a hash
of the sources, and loaded with ctypes.  Each source compiles in its own
nvcc process, all started together, and one more links them.  Every pointer and the CUDA
stream are passed as ``c_void_p``; every entry returns
``cudaGetLastError()`` and the caller raises when it is not 0.

Each kernel has a ``Kernel`` record holding its launch count: the
wrapper adds one where it launches the kernel, and nowhere else, with
the launch's shape bucket where the kernel has several (``L256``,
``LQ512``), so a run can show which buckets it went through.
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
HEADERS = ("fm.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Kernel:
    """A kernel's identity and its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.buckets = {}   # "<name>_<bucket>" -> launches
        self._lock = threading.Lock()

    def count(self, bucket: str = "") -> None:
        with self._lock:
            self.launches += 1
            if bucket:
                key = f"{self.name}_{bucket}"
                self.buckets[key] = self.buckets.get(key, 0) + 1


SMEM = Kernel("smem_superstep", "bwamem_tpu_torch/csrc/smem.cu",
              "bwamem_tpu/ops/pallas_smem.py:1405")
SA = Kernel("sa_walk", "bwamem_tpu_torch/csrc/sa.cu",
            "bwamem_tpu/ops/pallas_smem.py:1626")
EXTEND = Kernel("extend_lr", "bwamem_tpu_torch/csrc/extend.cu",
                "bwamem_tpu/ops/pallas_extend.py:285")
EXTEND2 = Kernel("extend2", "bwamem_tpu_torch/csrc/extend.cu",
                 "bwamem_tpu/ops/pallas_extend.py:285")
GLOBAL2 = Kernel("global2", "bwamem_tpu_torch/csrc/global.cu",
                 "bwamem_tpu/ops/pallas_global.py:266")
ALIGN2 = Kernel("align2", "bwamem_tpu_torch/csrc/align.cu",
                "bwamem_tpu/ops/pallas_align.py:180")
SMEM1 = Kernel("smem1_step", "bwamem_tpu_torch/csrc/smem.cu",
               "bwamem_tpu/ops/pallas_smem.py:1350 and "
               "bwamem_tpu/ops/pallas_bigsmem.py:612")
BUILD = Kernel("build_rows", "bwamem_tpu_torch/csrc/extbuild.cu",
               "bwamem_tpu/ops/pallas_extbuild.py:245")
GATHER = Kernel("gather_rows", "bwamem_tpu_torch/csrc/occ.cu",
                "bwamem_tpu/ops/pallas_occ.py:90, "
                "bwamem_tpu/ops/pallas_onehot.py:68 and "
                "tools/probe_mosaic_features.py:62,114")
OCC4 = Kernel("occ4", "bwamem_tpu_torch/csrc/occ.cu",
              "bwamem_tpu/ops/pallas_occ.py:90 (occ4_via_pallas)")
CHAIN = Kernel("row_chain", "bwamem_tpu_torch/csrc/microbench.cu",
               "tools/microbench_dmawave.py:109 and "
               "tools/microbench_bigsmem.py:165,179,261")
LOOP = Kernel("affine_loop", "bwamem_tpu_torch/csrc/microbench.cu",
              "tools/microbench_palloop.py:51")
KERNELS = (SMEM, SA, EXTEND, EXTEND2, GLOBAL2, ALIGN2, SMEM1, BUILD, GATHER,
           OCC4, CHAIN, LOOP)


def reset_counts() -> None:
    for k in KERNELS:
        with k._lock:
            k.launches = 0
            k.buckets = {}


_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "bm_smem_superstep": [_VP, _I64, _I64, _VP, _VP, _I, _VP, _VP, _VP,
                          _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP,
                          _VP, _VP],
    "bm_sa_walk": [_VP, _I64, _I64, _VP, _VP, _I, _I64, _VP, _I, _I, _VP,
                   _VP, _VP],
    "bm_extend_lr": [_I, _I, _I] + [_VP] * 9 + [_I] * 8 + [_VP] * 14,
    "bm_extend2": [_I, _I, _I] + [_VP] * 5 + [_I] * 4 + [_VP] * 2 + [_I]
                  + [_VP] * 8,
    "bm_global2": [_I, _I, _I] + [_VP] * 6 + [_I] * 4 + [_VP] * 7,
    "bm_align2": [_I, _I, _I, _I] + [_VP] * 6 + [_I] * 5 + [_VP] * 7,
    "bm_smem_iter_step": [_VP, _I64, _I64, _VP, _VP, _I] + [_VP] * 6
                         + [_I, _I, _I, _VP, _VP, _VP, _VP],
    "bm_build_rows": [_VP, _I, _VP, _I64] + [_VP] * 7 + [_I, _I, _I]
                     + [_VP] * 5,
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


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
