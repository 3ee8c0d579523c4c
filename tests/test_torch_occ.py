"""The port's occ-row gather and occ4 by key (bwamem_tpu_torch/ops/occ.py)
against the JAX package's Pallas kernels run in interpret mode on the
CPU: bwamem_tpu/ops/pallas_onehot.py (W = 16 rows),
bwamem_tpu/ops/pallas_occ.py (the wide W = 128 rows and occ4_via_pallas)
and probe a of tools/probe_mosaic_features.py (the transposed gather).
Integer outputs: the tolerance is zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(scope="module")
def tables(ref_index):
    """(JAX index, the port's occ table) of the bundled genome."""
    from bwamem_tpu.ops.fm import DeviceFmIndex as JaxIndex
    from bwamem_tpu_torch.ops.fm import DeviceFmIndex
    fm, _ = ref_index
    return JaxIndex.from_host(fm), DeviceFmIndex.from_host(fm)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(2, 7, 5), (64,), (3, 11)])
def test_gather_w16_matches_onehot_kernel(tables, shape):
    from bwamem_tpu.ops import pallas_onehot as oh
    from bwamem_tpu_torch.ops.occ import gather_rows
    jdfm, tdfm = tables
    rng = np.random.default_rng(sum(shape))
    blk = rng.integers(0, tdfm.n_blocks, shape).astype(np.int64)
    want = oh.gather_rows_onehot(oh.onehot_table(jdfm.blocks),
                                 jnp.asarray(blk), interpret=True)
    got = gather_rows(tdfm.blocks, torch.from_numpy(blk))
    assert got.shape == tuple(shape) + (16,)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("B", [8, 64])
def test_gather_w128_matches_dma_kernel(tables, B):
    from bwamem_tpu.ops import pallas_occ as po
    from bwamem_tpu_torch.ops.occ import gather_rows
    jdfm, tdfm = tables
    wide = po.wide_blocks(jdfm.blocks)
    rng = np.random.default_rng(B)
    rows = rng.integers(0, wide.shape[0], B).astype(np.int32)
    want = po.gather_rows_pallas(wide, jnp.asarray(rows), interpret=True)
    # the port's wide table: the narrow one padded to 8 blocks a row
    narrow = tdfm.blocks
    pad = (-narrow.shape[0]) % 8
    wide_t = torch.cat([narrow, narrow.new_zeros(pad, 16)]).reshape(-1, 128)
    got = gather_rows(wide_t, torch.from_numpy(rows))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_occ4_matches_dma_kernel(tables, ref_index, monkeypatch):
    """occ4 at k = -1, 0, primary, seq_len - 1 and random keys, as
    tests/test_ops.py runs occ4_via_pallas."""
    from bwamem_tpu.ops import pallas_occ as po
    from bwamem_tpu_torch.ops.occ import occ4
    fm, _ = ref_index
    jdfm, tdfm = tables
    rng = np.random.default_rng(7)
    ks = np.concatenate([[-1, 0, int(fm.primary), int(fm.primary) - 1,
                          int(fm.seq_len) - 1],
                         rng.integers(0, int(fm.seq_len), 59)]).astype(np.int64)
    orig = po.gather_rows_pallas
    monkeypatch.setattr(po, "gather_rows_pallas",
                        lambda b, blk: orig(b, blk, interpret=True))
    want = po.occ4_via_pallas(po.wide_blocks(jdfm.blocks), jdfm.primary,
                              jnp.asarray(ks))
    got = occ4(tdfm.blocks, tdfm.primary_int, torch.from_numpy(ks))
    assert got.dtype == torch.int64 and got.shape == (len(ks), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transposed_gather_matches_probe_a():
    """Probe a+b: C = 256 rows of an int32 (4096, 128) table by an index
    vector, the output transposed to (128, C); probe c: the same rows
    as (C, 128)."""
    from bwamem_tpu_torch.ops.occ import gather_rows
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 1 << 31, size=(4096, 128),
                       dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, 4096, size=(1, 256)).astype(np.int32)
    t, i = torch.from_numpy(tbl), torch.from_numpy(idx[0])
    np.testing.assert_array_equal(gather_rows(t, i, transpose=True).numpy(),
                                  tbl[idx[0]].T)
    np.testing.assert_array_equal(gather_rows(t, i).numpy(), tbl[idx[0]])


def test_out_of_range_ids_give_zero_rows():
    from bwamem_tpu_torch.ops.occ import gather_rows
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4) + 1
    got = gather_rows(t, torch.tensor([2, -1, 3, 0]))
    assert got.tolist() == [[9, 10, 11, 12], [0] * 4, [0] * 4, [1, 2, 3, 4]]
