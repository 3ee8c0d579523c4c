"""The PyTorch port imports nothing of JAX and nothing of the JAX package.

Statically: an ``ast`` walk of every module of ``bwamem_tpu_torch/`` and
of ``chip_smoke.py`` finds no import of ``jax``, ``jaxlib``,
``bwamem_tpu`` or ``bwamem_tpu.*`` at any depth (function bodies
included, and ``__import__``/``importlib.import_module`` of a literal
name).  At run time: ``python -m bwamem_tpu_torch.cli mem --device cpu``
on the bundled SE reads writes the golden SAM with none of them in
``sys.modules`` at exit, and so do the host commands, ``mem --engine
host`` and ``python -m bwamem_tpu_torch.graft_entry``.  ``chip_smoke.py`` may still start
``bwamem_tpu.cli`` in a separate process, for the reference output it
diffs against; that is not an import."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "bwamem_tpu")


def _sources():
    out = []
    for base, _, files in os.walk(os.path.join(ROOT, "bwamem_tpu_torch")):
        out += [os.path.relpath(os.path.join(base, f), ROOT)
                for f in files if f.endswith(".py")]
    return sorted(out) + ["chip_smoke.py"]


def _imported_names(tree):
    """Every absolute module name the tree imports."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.args[0].value


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_the_walk_covers_every_subpackage():
    """The parallel/ sub-package (the reads mesh, the multi-process
    mode) is walked like the rest."""
    got = _sources()
    assert {"bwamem_tpu_torch/parallel/mesh.py",
            "bwamem_tpu_torch/parallel/multihost.py",
            "bwamem_tpu_torch/ops/engine.py", "chip_smoke.py"} <= set(got)


def test_the_walk_covers_the_commands_and_entry_points():
    """The host commands' modules (core/fastmap.py, core/pemerge.py,
    legacy/) and the entry points (graft_entry, bench, run_eval)."""
    got = set(_sources())
    assert {"bwamem_tpu_torch/core/fastmap.py",
            "bwamem_tpu_torch/core/pemerge.py",
            "bwamem_tpu_torch/graft_entry.py", "bwamem_tpu_torch/bench.py",
            "bwamem_tpu_torch/run_eval.py"} <= got
    assert {f"bwamem_tpu_torch/legacy/{m}.py" for m in (
        "seqio", "bamlite", "aln", "aln_cli", "samse", "sampe",
        "bwasw")} <= got


@pytest.mark.parametrize("module,args", [
    ("bwamem_tpu_torch.cli", ["fastmap", "genome.fa", "reads_se1.fq"]),
    ("bwamem_tpu_torch.cli", ["samse", "genome.fa", "golden_se.sai",
                              "reads_se.fq"]),
    ("bwamem_tpu_torch.cli", ["pemerge", "reads_1.fq", "reads_2.fq"]),
    ("bwamem_tpu_torch.cli", ["mem", "--engine", "host", "genome.fa",
                              "reads_se1.fq"]),
    ("bwamem_tpu_torch.graft_entry", ["--device", "cpu", "--shards", "2"]),
], ids=["fastmap", "samse", "pemerge", "mem_host", "graft_entry"])
def test_entry_point_loads_no_jax_module(data_dir, module, args):
    """A command or entry point run as a program (each of its relative
    imports resolved, the lazy ones too) with no JAX module in
    sys.modules at exit."""
    argv = [os.path.join(data_dir, a) if a.endswith((".fa", ".fq", ".sai"))
            else a for a in args]
    code = (
        "import atexit, json, sys, runpy\n"
        "def report():\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in %r)\n"
        "    sys.stderr.write('LOADED ' + json.dumps(bad) + '\\n')\n"
        "atexit.register(report)\n"
        "sys.argv = [%r] + %r\n"
        "runpy.run_module(%r, run_name='__main__', alter_sys=True)\n"
        % (FORBIDDEN, module, argv, module))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = [ln for ln in res.stderr.splitlines() if ln.startswith("LOADED ")]
    assert loaded and json.loads(loaded[-1][len("LOADED "):]) == []


def test_the_walk_sees_nested_imports():
    tree = ast.parse("def f():\n    if 1:\n        from bwamem_tpu.core "
                     "import sam\n    import jax.numpy\n"
                     "__import__('jaxlib')\n")
    assert sorted(n for n in _imported_names(tree) if _forbidden(n)) == [
        "bwamem_tpu.core", "jax.numpy", "jaxlib"]
    assert not _forbidden("bwamem_tpu_torch.core")


@pytest.mark.parametrize("path", _sources())
def test_no_jax_import(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_cli_loads_no_jax_module(data_dir, tmp_path):
    sam = tmp_path / "se.sam"
    code = (
        "import atexit, json, sys, runpy\n"
        "def report():\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in %r)\n"
        "    sys.stderr.write('LOADED ' + json.dumps(bad) + '\\n')\n"
        "atexit.register(report)\n"
        "sys.argv = ['bwamem_tpu_torch.cli', 'mem', '--device', 'cpu',\n"
        "            %r, %r]\n"
        "runpy.run_module('bwamem_tpu_torch.cli', run_name='__main__',\n"
        "                 alter_sys=True)\n"
        % (FORBIDDEN, os.path.join(data_dir, "genome.fa"),
           os.path.join(data_dir, "reads_se.fq")))
    with open(sam, "w") as out:
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             stdout=out, stderr=subprocess.PIPE, text=True,
                             timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = [ln for ln in res.stderr.splitlines() if ln.startswith("LOADED ")]
    assert loaded and json.loads(loaded[-1][len("LOADED "):]) == []

    def body(p):
        with open(p) as f:
            return [ln for ln in f if not ln.startswith("@PG")]
    assert body(sam) == body(os.path.join(data_dir, "golden_se.sam"))
