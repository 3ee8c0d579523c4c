"""The plain versions of the microbenchmark kernels
(bwamem_tpu_torch/ops/occ.py) against numpy transcriptions of the TPU
kernels' step formulas, which live inside the tools' main() and cannot be
imported: tools/microbench_dmawave.py:93-99 (dep, nodep, null) and
tools/microbench_bigsmem.py:238-254 (gw: full, xpose).  Two of the
port's modes are its own per-lane variants, not the TPU's formulas: K > 1
runs K chains of dmawave's `dep` step, and `dma` adds the lane's own row
sum; the TPU's gwk (:106-145) and gw `dma` add the sum of the whole
wave's rows, one scalar a step, which the card could only get through a
grid-wide barrier.  That whole-wave formula is pinned on its own against
a plain reduction, with the cases where the port's variant equals it.
The affine loop against a CPU lax.fori_loop of
tools/microbench_palloop.py's body; ``python -m
bwamem_tpu_torch.microbench --device cpu`` at a tiny size, and its check
callback.  Integer outputs: the tolerance is zero; the float loop:
relative 1e-6 against JAX (XLA may contract the multiply-add into an
FMA), equality between the port's own step-by-step runs."""

import os

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

A, B = np.int32(1103515245), np.int32(12345)


def tpu_chains(tbl, idx0, T, mode):
    """The step formulas in wrapping int32 numpy, K chains of C lanes;
    the output is the port's (csrc/microbench.cu): per lane, the sum over
    chains of the last row id and of every fetched row's sum.  dep,
    nodep, null, full and xpose are the TPU's steps; K > 1 and `dma`
    are the port's per-lane variants (see tpu_wave_chains for the TPU's
    whole-wave step)."""
    n = tbl.shape[0]
    mask = np.int32(n - 1)                  # n is a power of two
    wide = tbl.reshape(-1, 8 * tbl.shape[1])    # the TPU's 512-byte rows
    st = idx0.astype(np.int32).copy()
    acc = np.zeros_like(st)
    with np.errstate(over="ignore"):
        for t in range(T):
            t32 = np.int32(t)
            if mode == "null":
                st = (st * A + B + t32) & mask
                continue
            if mode == "xpose":
                rows = wide[st >> 3][..., :tbl.shape[1]]
            else:
                rows = tbl[st]
            s = rows.sum(-1, dtype=np.int32)
            acc = acc + s
            if mode == "dep":                   # dmawave :96-97
                st = ((st ^ s) * A + B + t32) & mask
            elif mode == "nodep":               # dmawave :99
                st = (st * A + B + t32) & mask
            elif mode == "full":                # bigsmem :243-244
                st = (st + (rows[..., 0] + rows[..., 8]) + t32) % np.int32(n)
            elif mode == "xpose":               # bigsmem :249-250
                st = (st + wide[st >> 3, 0] + t32) % np.int32(n)
            else:                               # dma
                st = (st + s + t32) % np.int32(n)
        return (st + acc).sum(0, dtype=np.int32)


@pytest.mark.parametrize("W", [16, 128])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("mode", ["dep", "nodep", "null", "full", "xpose",
                                  "dma"])
def test_row_chain_plain_matches_tpu_formulas(mode, K, W):
    from bwamem_tpu_torch.ops.occ import row_chain_plain
    rng = np.random.default_rng(K * 100 + W)
    tbl = rng.integers(-2 ** 31, 2 ** 31, (64, W)).astype(np.int32)
    idx0 = rng.integers(0, 64, (K, 8)).astype(np.int32)
    got = row_chain_plain(torch.from_numpy(tbl), torch.from_numpy(idx0), 4,
                          mode)
    assert got.dtype == torch.int32 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), tpu_chains(tbl, idx0, 4, mode))


def tpu_wave_chains(tbl, idx0, T):
    """The TPU's whole-wave step, tools/microbench_bigsmem.py gwk `plain`
    (:126-145) and gw `dma` (:251-254), in wrapping int32 numpy: each
    chain fetches its C lanes' rows, sums the whole wave into one scalar
    s3, and every lane's next row id is (old + s3 + t) % n_rows.
    Returns the last row ids (K, C) and each chain's sum of its s3."""
    n = np.int32(tbl.shape[0])
    st = idx0.astype(np.int32).copy()
    acc = np.zeros(st.shape[0], np.int32)
    with np.errstate(over="ignore"):
        for t in range(T):
            s3 = tbl[st].sum((1, 2), dtype=np.int32)        # (K,)
            acc = acc + s3
            st = (st + s3[:, None] + np.int32(t)) % n
    return st, acc


def test_tpu_whole_wave_formula_and_the_ports_per_lane_variant():
    from bwamem_tpu_torch.ops.occ import row_chain_plain
    rng = np.random.default_rng(11)
    tbl = rng.integers(-2 ** 31, 2 ** 31, (64, 128)).astype(np.int32)
    idx0 = rng.integers(0, 64, (2, 8)).astype(np.int32)
    st, acc = tpu_wave_chains(tbl, idx0, 4)
    # a plain reduction of the same step: int64 masked to 32 bits
    m32, tb = 0xFFFFFFFF, torch.from_numpy(tbl).to(torch.int64) & 0xFFFFFFFF
    pst = torch.from_numpy(idx0).to(torch.int64)
    for t in range(4):
        s3 = tb[pst].sum((1, 2), keepdim=True).squeeze(2) & m32
        pst = ((pst + s3 + t) & m32) % 64
    np.testing.assert_array_equal(pst.numpy(), st)
    # with one lane the wave is the lane's own row: the port's `dma` and
    # K chains give the TPU's values; with 8 lanes they differ
    for K in (1, 2):
        st1, acc1 = tpu_wave_chains(tbl, idx0[:K, :1], 4)
        want = (st1[:, 0] + acc1).sum(dtype=np.int32)
        got = row_chain_plain(torch.from_numpy(tbl),
                              torch.from_numpy(idx0[:K, :1]), 4, "dma")
        assert got.tolist() == [int(want)]
    wide = (st + acc[:, None]).sum(0, dtype=np.int32)
    per_lane = row_chain_plain(torch.from_numpy(tbl), torch.from_numpy(idx0),
                               4, "dma").numpy()
    assert not np.array_equal(per_lane, wide)


def test_row_chain_vdirect_is_dep_and_modes_are_checked():
    from bwamem_tpu_torch.ops.occ import row_chain
    tbl = torch.arange(64 * 16, dtype=torch.int32).reshape(64, 16)
    idx0 = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    assert torch.equal(row_chain(tbl, idx0, 3, "vdirect"),
                       row_chain(tbl, idx0, 3, "dep"))
    # a first id past the table is taken mod n_rows, as every later one
    assert torch.equal(row_chain(tbl, idx0 + 64, 3), row_chain(tbl, idx0, 3))
    with pytest.raises(ValueError):
        row_chain(tbl, idx0.repeat(3, 1), 3)          # K = 3
    with pytest.raises(ValueError):
        row_chain(tbl[:, :8], idx0, 3, "full")        # full needs W >= 16


def test_affine_loop_plain_matches_fori_loop():
    from bwamem_tpu_torch.ops.occ import affine_loop_plain
    x = np.random.default_rng(3).random((64, 128)).astype(np.float32)
    want = lax.fori_loop(0, 256, lambda i, c: c * 1.000001 + 0.5,
                         jnp.asarray(x))
    got = affine_loop_plain(torch.from_numpy(x), 256)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    # 256 steps at once equal 256 runs of one step
    c = torch.from_numpy(x)
    for _ in range(256):
        c = affine_loop_plain(c, 1)
    assert torch.equal(c, got)


def test_microbench_cli_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "bwamem_tpu_torch.microbench", "all",
         "--device", "cpu", "--tables", "4K", "--widths", "16,128",
         "--ids", "64", "--lanes", "16", "--steps", "3", "--chains", "1,2",
         "--iters", "4", "--reps", "1"], capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    kinds = {ln["variant"] for ln in lines}
    assert kinds == {"gather", "chain", "loop", "probe"}
    for ln in lines:
        assert ln["device"] == "cpu" and ln["card"] == "cpu"
        assert not any(k == "ms" or k.startswith("ms_") for k in ln), ln
    subs = {ln["sub"] for ln in lines if ln["variant"] == "gather"}
    assert subs == {"fwd_gather", "flat_gather", "take", "bwd_gather",
                    "kernel", "occ4"}
    assert all(ln["equal_to_index_select"] for ln in lines
               if ln.get("sub") == "kernel")
    assert [ln["result"] for ln in lines if ln["variant"] == "probe"] == [
        "OK", "OK"]
    assert [ln["max_abs_diff"] for ln in lines
            if ln["variant"] == "loop"] == [0.0]
    assert {(ln["width"], ln["mode"], ln["K"]) for ln in lines
            if ln["variant"] == "chain"} == {
        (w, m, k) for w in (16, 128) for m, k in
        [("dep", 1), ("dep", 2), ("nodep", 1), ("null", 1), ("full", 1),
         ("xpose", 1), ("dma", 1)]}
    assert all(not ln["above_l2"] and ln["table_bytes"] == 4096
               for ln in lines if ln["variant"] == "chain")


def test_microbench_needs_a_card_without_device_cpu():
    from bwamem_tpu_torch import microbench
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert microbench.main(["loop"]) == 1


def test_microbench_check_sees_every_kernel_call():
    """run()'s check callback gets each kernel call the variants make,
    once, with its line, output and arguments: what chip_smoke.py holds
    against the plain versions on the card."""
    from bwamem_tpu_torch import microbench
    from bwamem_tpu_torch.ops import occ
    plain = {"gather_rows": occ.gather_rows_plain, "occ4": occ.occ4_plain,
             "row_chain": occ.row_chain_plain,
             "affine_loop": occ.affine_loop_plain}
    calls, keys = [], []

    def check(kernel, line, out, args, library=None):
        assert torch.equal(out, plain[kernel](*args)), (kernel, line)
        if kernel == "gather_rows" and line["variant"] == "gather":
            assert library["sub"] == "take" and library["ids"] == line["ids"]
        else:
            assert library is None
        calls.append((kernel, id(line)))
        if kernel == "occ4" and line["table_name"].startswith("index:"):
            keys.append(args[2][:5].tolist())

    index = os.path.join(os.path.dirname(__file__), "data", "genome.fa")
    args = microbench.parser().parse_args(
        ["all", "--device", "cpu", "--tables", "4K", "--widths", "16,128",
         "--ids", "64", "--lanes", "8,16", "--steps", "3", "--chains", "1,2",
         "--iters", "4", "--reps", "1", "--index", index])
    lines = microbench.run(args, emit=lambda ln: None, check=check)
    launched = [ln for ln in lines if ln.get("sub") in ("kernel", "occ4")
                or ln["variant"] in ("chain", "loop", "probe")]
    assert sorted(i for _, i in calls) == sorted(id(ln) for ln in launched)
    assert {k for k, _ in calls} == set(plain)
    assert {ln["lanes"] for ln in lines if ln["variant"] == "chain"} == {8, 16}
    # occ4's keys start at the edges of the index's table
    _, prim, seq_len = microbench.load_occ_table(index, "cpu")
    assert keys == [[-1, 0, prim - 1, prim, seq_len - 1]]
