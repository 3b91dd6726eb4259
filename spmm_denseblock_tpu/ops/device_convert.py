"""On-device format conversion (jit-able, static shapes).

The reference converts CSR->BSR on the GPU with cuSPARSE's two-phase
protocol (cusparseXcsr2bsrNnz then cusparseScsr2bsr,
/root/reference/run_bsrmm.cu:121-142). Here it is one fused XLA
program over the COO view — but where cuSPARSE materializes a
data-dependent nnzb, XLA needs static shapes, so the caller passes a
capacity `nnzb_max` (n_rows*avg-degree bound, or exact from the host
phase-1 count) and gets back the padded flat-BSR layout
(formats/bsr.py): unused slots are zero blocks parked on the last
block-row.

Phase 1 (`count_nnzb_device`) is the jit-able nnzb counter — use it to
size capacity when converting many same-shaped matrices (the
benchmark-sweep case, where one compiled program serves every density).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from spmm_denseblock_tpu.formats.bsr import BSR
from spmm_denseblock_tpu.formats.csr import CSR


def _sort_by_block(brow, bcol):
    """Stable order by (brow, bcol) via two int32 radix passes.

    A fused `brow * n_block_cols + bcol` key silently truncates to int32
    under the default jax config (x64 disabled) and wraps once
    n_block_rows * n_block_cols > 2^31 (products-scale grids at small b),
    merging distinct blocks at wrong coordinates.  Two stable argsorts
    need no wide key and are exact at any grid size."""
    o1 = jnp.argsort(bcol, stable=True)
    return o1[jnp.argsort(brow[o1], stable=True)]


def _fresh_mask(br_s, bc_s):
    """1 where sorted element starts a new (brow, bcol) block."""
    change = (br_s[1:] != br_s[:-1]) | (bc_s[1:] != bc_s[:-1])
    return jnp.concatenate(
        [jnp.ones((1,), jnp.int32), change.astype(jnp.int32)]
    )


@functools.partial(jax.jit, static_argnames=("n_block_cols", "block_size"))
def count_nnzb_device(row_ids, col_ids, n_block_cols: int, block_size: int):
    """Phase 1: number of distinct nonzero blocks (device scalar).

    `n_block_cols` is kept for API stability but no longer folds into a
    fused sort key (see _sort_by_block)."""
    del n_block_cols
    if row_ids.shape[0] == 0:  # static shape: empty matrix has 0 blocks
        return jnp.int32(0)
    brow = (row_ids // block_size).astype(jnp.int32)
    bcol = (col_ids // block_size).astype(jnp.int32)
    order = _sort_by_block(brow, bcol)
    return jnp.sum(_fresh_mask(brow[order], bcol[order]))


@functools.partial(
    jax.jit,
    static_argnames=("n_block_rows", "n_block_cols", "block_size", "nnzb_max"),
)
def csr_to_bsr_device(
    row_ids,
    col_ids,
    vals,
    n_block_rows: int,
    n_block_cols: int,
    block_size: int,
    nnzb_max: int,
):
    """Phase 2: scatter element values into (nnzb_max, b, b) flat blocks.

    Returns (block_rows, block_cols, blocks, nnzb) with padding slots on
    the last block-row (col 0, zero block) — directly consumable by the
    BSR SpMM tiers. Overflow beyond nnzb_max drops blocks (caller sizes
    capacity via count_nnzb_device or a host bound).
    """
    b = block_size
    nnz = row_ids.shape[0]
    if nnz == 0:  # static shape: all padding
        return (
            jnp.full((nnzb_max,), n_block_rows - 1, jnp.int32),
            jnp.zeros((nnzb_max,), jnp.int32),
            jnp.zeros((nnzb_max, b, b), jnp.float32),
            jnp.int32(0),
        )
    brow = (row_ids // b).astype(jnp.int32)
    bcol = (col_ids // b).astype(jnp.int32)

    order = _sort_by_block(brow, bcol)  # no fused key: exact at any grid size
    br_s = brow[order]
    bc_s = bcol[order]
    fresh = _fresh_mask(br_s, bc_s)
    # dense rank of each sorted element's block, in block order
    rank = jnp.cumsum(fresh) - 1  # (nnz,) 0-based block index
    nnzb = rank[-1] + 1 if rank.shape[0] else jnp.int32(0)

    # slot tables via first-occurrence positions. scatter-MIN of the
    # sorted position with sentinel nnz: all writes to a real slot share
    # a block, and the minimum position is its first element; overflow
    # writes (clamped to the last slot) have strictly larger positions,
    # so min preserves that slot's real block; untouched slots keep the
    # sentinel and become padding parked on the last block-row.
    slot_pos = jnp.full((nnzb_max,), nnz, jnp.int32)
    slot_pos = slot_pos.at[jnp.minimum(rank, nnzb_max - 1)].min(
        jnp.arange(nnz, dtype=jnp.int32), indices_are_sorted=True
    )
    valid = slot_pos < nnz
    safe_pos = jnp.minimum(slot_pos, max(nnz - 1, 0))
    block_rows = jnp.where(valid, br_s[safe_pos], n_block_rows - 1).astype(
        jnp.int32
    )
    block_cols = jnp.where(valid, bc_s[safe_pos], 0).astype(jnp.int32)

    # scatter values into blocks
    r_in = (row_ids[order] % b).astype(jnp.int32)
    c_in = (col_ids[order] % b).astype(jnp.int32)
    v = vals[order] if vals is not None else jnp.ones((nnz,), jnp.float32)
    blocks = jnp.zeros((nnzb_max, b, b), jnp.float32)
    blocks = blocks.at[jnp.minimum(rank, nnzb_max - 1), r_in, c_in].add(
        jnp.where(rank < nnzb_max, v, 0.0)
    )
    return block_rows, block_cols, blocks, nnzb


def csr_to_bsr_on_device(csr: CSR, block_size: int, nnzb_max=None) -> BSR:
    """Convenience wrapper: device conversion, host BSR container."""
    import numpy as np

    nbr = -(-csr.shape[0] // block_size)
    nbc = -(-csr.shape[1] // block_size)
    row_ids = jnp.asarray(csr.row_ids())
    col_ids = jnp.asarray(np.asarray(csr.indices, dtype=np.int32))
    vals = None if csr.data is None else jnp.asarray(np.asarray(csr.data))
    if nnzb_max is None:
        nnzb_max = int(count_nnzb_device(row_ids, col_ids, nbc, block_size))
    brows, bcols, blocks, nnzb = csr_to_bsr_device(
        row_ids, col_ids, vals, nbr, nbc, block_size, int(nnzb_max)
    )
    return BSR(
        block_rows=brows,
        block_cols=bcols,
        blocks=blocks,
        shape=csr.shape,
        block_size=block_size,
        nnzb=int(nnzb),
    )
