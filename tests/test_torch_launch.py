"""The port's launch path (bwamem_tpu_torch/ops/_kernels.py): no CUDA
wrapper reads a device value on the host before its launch, lengths held
on the host are still checked, and ``Kernel.launch`` counts, passes the
stream and raises.

Statically: an ``ast`` walk of every ``*_cuda`` function in
``bwamem_tpu_torch/ops/`` and of every function it calls (at any depth:
by name in its module, through ``self``, and the shared helpers through
``_kernels.<name>``) finds no ``.any()``, ``.all()``, ``.item()``,
``.cpu()``, ``.tolist()`` or ``.numpy()``, and no ``bool()``, ``int()``
or ``float()`` of an expression that calls or indexes
(``int(x.max())``): each of those copies a device value to the host,
which waits for the stream.  The host-only checks (HOST_CHECKS) may read
lengths, but only after an ``if`` on ``.is_cuda`` that returns or skips
the tensor; the tests below hold them to that on CPU tensors."""

import ast
import os

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops import _kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = os.path.join(ROOT, "bwamem_tpu_torch", "ops")
SYNC_METHODS = ("any", "all", "item", "cpu", "tolist", "numpy")
SYNC_CASTS = ("bool", "int", "float")
# (module, function) of the checks that read lengths held on the host
HOST_CHECKS = {("_kernels", "check_host_lengths"),
               ("extbuild", "check_host_windows")}


def _ops_modules():
    return sorted(f for f in os.listdir(OPS) if f.endswith(".py"))


def _ops_trees():
    trees = {}
    for f in _ops_modules():
        with open(os.path.join(OPS, f)) as fh:
            trees[f[:-3]] = ast.parse(fh.read(), f)
    return trees


def _syncs(fn):
    """(line, text) of every call in fn that reads a device value on the
    host."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
            yield node.lineno, ast.unparse(node)
        elif (isinstance(f, ast.Name) and f.id in SYNC_CASTS and node.args
              and any(isinstance(n, (ast.Call, ast.Subscript))
                      for n in ast.walk(node.args[0]))):
            yield node.lineno, ast.unparse(node)


def _callee(call, here: str):
    """(module, name) of the function a call reaches: a bare name in the
    module `here`, a method through ``self``, a helper through
    ``_kernels`` (``_kernels.card_of``, ``_kernels.SMEM.launch``)."""
    f = call.func
    if isinstance(f, ast.Name):
        return here, f.id
    if isinstance(f, ast.Attribute):
        root = f.value
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id == "self":
            return here, f.attr
        if isinstance(root, ast.Name) and root.id == "_kernels":
            return "_kernels", f.attr
    return None


def _cuda_guard(fn):
    """The line of fn's first ``if`` on ``.is_cuda`` whose body returns or
    continues, or None."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.If)
                and any(isinstance(n, ast.Attribute) and n.attr == "is_cuda"
                        for n in ast.walk(node.test))
                and any(isinstance(n, (ast.Return, ast.Continue))
                        for n in node.body)):
            return node.lineno
    return None


def wrapper_syncs(trees, module, roots=None):
    """The syncing calls (function, line, text) of every *_cuda function
    of trees[module] (or of the functions named in roots) and of the
    functions it calls, transitively; a host check's reads after its
    is_cuda guard do not count."""
    defs = {m: {n.name: n for n in ast.walk(t)
                if isinstance(n, ast.FunctionDef)}
            for m, t in trees.items()}
    todo = [(module, name) for name in defs[module]
            if (name in roots if roots is not None
                else name.endswith("_cuda"))]
    seen = set()
    while todo:
        key = todo.pop()
        if key in seen or key[1] not in defs.get(key[0], {}):
            continue
        seen.add(key)
        for node in ast.walk(defs[key[0]][key[1]]):
            if isinstance(node, ast.Call):
                callee = _callee(node, key[0])
                if callee:
                    todo.append(callee)
    bad = []
    for m, name in seen:
        fn = defs[m][name]
        guard = _cuda_guard(fn) if (m, name) in HOST_CHECKS else None
        bad += [(f"{m}.{name}", line, text) for line, text in _syncs(fn)
                if guard is None or line <= guard]
    return sorted(bad)


_SYNTHETIC = {
    "_kernels": (
        "def helper(q):\n    return q.item()\n"
        "def check_host_lengths(what, *checks):\n"
        "    for name, t, cap in checks:\n"
        "        if t.is_cuda:\n            continue\n"
        "        if int(t.max()) > cap:\n            raise V\n"),
    "mod": (
        "def _check(q, L):\n    if int(q.max()) > L:\n        raise V\n"
        "def f_cuda(q, n, L):\n    _check(q, L)\n    k = int(n)\n"
        "    _kernels.check_host_lengths('f', ('q', q, L))\n"
        "    _kernels.helper(q)\n"
        "    if bool((q > 1).any()):\n        pass\n    return q.cpu()\n"
        "def f_plain(q):\n    return q.tolist()\n"),
}


def test_the_walk_sees_a_sync():
    """Syncs in the wrapper, in a same-module helper and in a _kernels
    helper are found; a host check's reads past its guard are not."""
    trees = {m: ast.parse(src) for m, src in _SYNTHETIC.items()}
    got = [(name, text) for name, _, text in wrapper_syncs(trees, "mod")]
    assert got == [("_kernels.helper", "q.item()"),
                   ("mod._check", "int(q.max())"),
                   ("mod.f_cuda", "(q > 1).any()"),
                   ("mod.f_cuda", "bool((q > 1).any())"),
                   ("mod.f_cuda", "q.cpu()")]


def test_a_host_check_without_its_guard_is_a_sync():
    """The allow-list holds a host check only while it returns or skips
    first on a tensor on the card."""
    src = dict(_SYNTHETIC)
    src["_kernels"] = src["_kernels"].replace(
        "        if t.is_cuda:\n            continue\n", "")
    trees = {m: ast.parse(s) for m, s in src.items()}
    got = [(name, text) for name, _, text in wrapper_syncs(trees, "mod")]
    assert ("_kernels.check_host_lengths", "int(t.max())") in got


@pytest.mark.parametrize("module", _ops_modules())
def test_no_cuda_wrapper_syncs(module):
    bad = wrapper_syncs(_ops_trees(), module[:-3])
    assert not bad, f"{module}: a CUDA wrapper reads the device: {bad}"


MESH = os.path.join(ROOT, "bwamem_tpu_torch", "parallel", "mesh.py")
# the sharded entry points: every method of ShardedKernels and the
# functions that return sharded callables
SHARDED_ROOTS = ("sharded_smem1", "sharded_sa_lookup")


def test_no_sharded_wrapper_syncs():
    """The reads mesh's wrappers (bwamem_tpu_torch/parallel/mesh.py) read
    no device value on the host before or between their shards'
    launches, at any depth of what they call in their module."""
    with open(MESH) as fh:
        tree = ast.parse(fh.read(), MESH)
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
               and n.name == "ShardedKernels")
    roots = [f.name for f in cls.body if isinstance(f, ast.FunctionDef)]
    roots += list(SHARDED_ROOTS)
    assert {"superstep", "sa_lookup", "extend_lr", "extend2",
            "global2"} <= set(roots)
    bad = wrapper_syncs({"mesh": tree, "_kernels": _ops_trees()["_kernels"]},
                        "mesh", roots=roots)
    assert not bad, f"a sharded wrapper reads the device: {bad}"


def test_the_host_checks_are_reached():
    """Every allow-listed host check exists and some wrapper calls it, so
    the allow-list names nothing stale."""
    trees = _ops_trees()
    reached = set()
    for m, t in trees.items():
        for node in ast.walk(t):
            if isinstance(node, ast.Call):
                callee = _callee(node, m)
                if callee in HOST_CHECKS:
                    reached.add(callee)
    assert reached == HOST_CHECKS


# ---- lengths held on the host ----

def _i32(*v):
    return torch.tensor(v, dtype=torch.int32)


def _ext_lanes(LQ, LT, llq=(5, 7), rlq=(3, 4), llt=(9, 9), rlt=(6, 2)):
    B = len(llq)
    z8 = lambda w: torch.zeros(B, w // 2, dtype=torch.int8)  # noqa: E731
    z64 = torch.zeros(B, dtype=torch.int64)
    return (z8(LQ), z8(LT), _i32(*llq), _i32(*llt), z8(LQ), z8(LT),
            _i32(*rlq), _i32(*rlt), torch.zeros(25, dtype=torch.int8),
            6, 1, 6, 1, 100, 5, 5, 100, _i32(1, 1), _i32(0, 0), z64, z64,
            _i32(40, 40), _i32(19, 19), LQ, LT)


def _extend_lr(over):
    from bwamem_tpu_torch.ops.ksw import extend_lr_cuda
    LQ, LT = 128, 544
    return extend_lr_cuda, (_ext_lanes(LQ, LT, rlt=(6, LT + 1)) if over
                            else _ext_lanes(LQ, LT))


def _rows(B, LQ, LT, qlen, tlen):
    z8 = lambda w: torch.zeros(B, w // 2, dtype=torch.int8)  # noqa: E731
    return z8(LQ), z8(LT), _i32(*qlen), _i32(*tlen)


def _extend2(over):
    from bwamem_tpu_torch.ops.ksw import extend2_cuda
    q, t, ql, tl = _rows(2, 256, 800, (3, 257 if over else 256), (5, 5))
    return extend2_cuda, (q, t, ql, tl, torch.zeros(25, dtype=torch.int8),
                          6, 1, 6, 1, _i32(5, 5), _i32(5, 5), 100,
                          _i32(1, 1), 256, 800)


def _global2(over):
    from bwamem_tpu_torch.ops.ksw import global_cuda
    q, t, ql, tl = _rows(2, 128, 160, (3, 3), (5, 161 if over else 160))
    return global_cuda, (q, t, ql, tl, torch.zeros(25, dtype=torch.int8), 6,
                         1, 6, 1, _i32(5, 5), 128, 160)


def _align2(over):
    from bwamem_tpu_torch.ops.ksw_align import align_cuda
    q = torch.zeros(2, 128, dtype=torch.int8)
    t = torch.zeros(2, 544, dtype=torch.int8)
    return align_cuda, (q, t, _i32(129 if over else 128, 3), _i32(5, 5),
                        torch.zeros(25, dtype=torch.int8), 6, 1, 6, 1,
                        _i32(0x10000, 0x10000), 1, 1, 128, 544)


def _fm_index():
    """A small index of random occ blocks (the SMEM wrappers' checks
    read only its tables' place and alignment)."""
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    rng = np.random.default_rng(0)
    return DeviceFmIndex(rng.integers(0, 1 << 32, (4, 16), dtype=np.uint32),
                         np.array([0, 100, 200, 300, 400]), 3, 400,
                         np.zeros(50, np.int32), 8)


def _superstep(over):
    from bwamem_tpu_torch.ops.smem import superstep_cuda
    L = 256
    one = torch.ones(2, dtype=torch.int64)
    return superstep_cuda, (_fm_index(), torch.zeros(2, L // 2,
                                                     dtype=torch.int8),
                            _i32(L + 1 if over else L, 3), one, one.bool(),
                            _i32(9, 9), _i32(9, 9), L, 16, 48)


def _iter_step(over):
    from bwamem_tpu_torch.ops.smem import smem_iter_step_cuda
    L = 128
    one = torch.ones(2, dtype=torch.int64)
    return smem_iter_step_cuda, (_fm_index(), torch.zeros(2, L // 2,
                                                          dtype=torch.int8),
                                 _i32(L + 1 if over else L, 3), _i32(0, 0),
                                 one, one.bool(), _i32(9, 9), _i32(9, 9), L,
                                 16, 12)


def _build_rows(over):
    from bwamem_tpu_torch.ops.extbuild import build_rows_cuda
    reads = torch.zeros(3, 150, dtype=torch.int8)
    pac = torch.zeros(100, dtype=torch.uint8)
    I64 = lambda *v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    return build_rows_cuda, (reads, pac, 400, _i32(0, 2), _i32(3, 0),
                             _i32(20, 20), I64(30, 500), I64(0, 450),
                             I64(100, 790), _i32(151 if over else 150, 40),
                             128, 544)


# the CUDA wrappers, each with its arguments (CPU tensors) for two lanes,
# one past its bucket when `over`
WRAPPERS = {"extend_lr": _extend_lr, "extend2": _extend2,
            "global2": _global2, "align2": _align2, "superstep": _superstep,
            "iter_step": _iter_step, "build_rows": _build_rows}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_lane_past_its_bucket_on_the_host_raises(wrapper):
    """A CUDA wrapper given lengths on the host (CPU tensors) still
    refuses a lane past its bucket, before it reaches a card; lanes inside
    it pass the check and are refused only for lying on the CPU."""
    fn, args = WRAPPERS[wrapper](True)
    with pytest.raises(ValueError, match="exceeds"):
        fn(*args)
    fn, args = WRAPPERS[wrapper](False)
    with pytest.raises(ValueError, match="expects CUDA tensors"):
        fn(*args)


def test_host_checks_read_host_lengths_only():
    """check_host_lengths reads CPU tensors and numpy arrays (an empty one
    too), and refuses only a value past the bucket."""
    _kernels.check_host_lengths("t", ("q", _i32(3, 128), 128),
                                ("t", np.array([544]), 544),
                                ("e", _i32(), 1))
    with pytest.raises(ValueError, match="a t exceeds its bucket 544"):
        _kernels.check_host_lengths("w", ("t", np.array([1, 545]), 544))


def test_edge_lanes_pass_the_window_check(data_dir):
    """The row builder's edge lanes (tests/test_torch_extbuild_host.py)
    pass check_host_windows, and the lanes out of range do not."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops.extbuild import check_host_windows
    from tests.test_torch_extbuild_host import EDGES, edge_lanes
    bns = load_index(os.path.join(data_dir, "genome.fa"))[1]
    for kind in EDGES:
        reads, *lanes = edge_lanes(bns.l_pac, kind, 257, 150, 544, 0)
        args = (len(reads), 150, bns.l_pac, *lanes)
        if kind == "out_of_range":
            with pytest.raises(ValueError, match="exceeds"):
                check_host_windows(*args)
        else:
            check_host_windows(*args)


# ---- Kernel.launch ----

def test_launch_counts_passes_the_stream_and_raises(monkeypatch):
    """The launch path calls the entry once with the plain ints and the
    card's stream handle, counts the launch (on its card, and its bucket)
    only when the entry returns 0, and raises otherwise."""
    k = _kernels.Kernel("probe", "src", "tpu", "bm_probe")
    calls = []

    def entry(*args):
        calls.append(args)
        return args[0]
    k._fn = entry
    monkeypatch.setattr(_kernels, "_raw_stream", lambda idx: 1000 + idx)
    monkeypatch.setattr(_kernels, "_current_card", lambda: 3)
    k.launch(3, 0, 11, bucket="LQ128")
    assert calls == [(0, 11, 1003)]
    assert k.launches == 1 and k.buckets == {"probe_LQ128": 1}
    assert k.by_card == {3: 1}
    with pytest.raises(RuntimeError, match="probe launch failed: CUDA "
                                           "error 700"):
        k.launch(3, 700)
    assert k.launches == 1 and k.by_card == {3: 1}


def test_launch_makes_the_tensors_card_current(monkeypatch):
    """A launch on card k runs its entry with card k current (a
    ``<<<...>>>`` launch goes to the current card), restores the card
    that was current, also when the launch fails, and sets nothing when
    card k is current already."""
    k = _kernels.Kernel("probe", "src", "tpu", "bm_probe")
    current = [0]
    log = []

    def enter(idx):
        log.append(("enter", idx))
        prev, current[0] = current[0], idx
        return prev

    def leave(prev):
        log.append(("leave", prev))
        current[0] = prev

    def entry(*args):
        log.append(("entry", current[0], args[-1]))
        return args[0]
    k._fn = entry
    monkeypatch.setattr(_kernels, "_raw_stream", lambda idx: 1000 + idx)
    monkeypatch.setattr(_kernels, "_current_card", lambda: current[0])
    monkeypatch.setattr(_kernels, "_enter_card", enter)
    monkeypatch.setattr(_kernels, "_leave_card", leave)
    k.launch(3, 0)
    assert log == [("enter", 3), ("entry", 3, 1003), ("leave", 0)]
    assert current[0] == 0 and k.launches == 1
    log.clear()
    k.launch(0, 0)
    assert log == [("entry", 0, 1000)]
    log.clear()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        k.launch(1, 700)
    assert log == [("enter", 1), ("entry", 1, 1001), ("leave", 0)]
    assert current[0] == 0 and k.launches == 2
    assert k.by_card == {3: 1, 0: 1}


def test_card_of_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="gather_rows expects CUDA"):
        _kernels.card_of(torch.zeros(3), "gather_rows")


def test_every_kernel_names_a_signed_entry():
    """Each kernel's entry point has its ctypes signature."""
    for k in _kernels.KERNELS:
        assert k.entry in _kernels._SIGNATURES, k.name
