"""BSR SpMM, XLA formulation (batched block matmul + segment-sum).

The compiler-only tier of the BSR path (the Pallas kernel in
bsr_spmm_pallas.py is the hand-scheduled tier):

    Bblk[k]  = B[block_cols[k]*b : +b, :]       (tile gather)
    P[k]     = blocks[k] @ Bblk[k]              (batched matmul)
    Cblk     = segment_sum(P, block_rows)       (sorted scatter-add)

Replaces the rocSPARSE BSR kernel suite's role
(/root/reference/rocsparse_bsrmm.h:102-256) as the portable baseline;
also serves every block size the kernel refuses, and every backend
that is not a GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from spmm_denseblock_tpu.formats.bsr import BSR
from spmm_denseblock_tpu.ops.plan import Plan


def block_products(block_rows, block_cols, blocks, dense_blk, n_block_rows,
                   scales=None):
    """sum_k blocks[k] @ dense_blk[block_cols[k]] into block-row
    block_rows[k]: the (n_block_rows, b, F) f32 result.

    Gather, batched matmul, sorted scatter-add. f32 blocks multiply at
    HIGHEST (IEEE f32 — the GPU default would be TF32), bf16 with f32
    accumulation; int8 blocks run int8 x int8 -> int32 and rescale by
    the per-block `scales`. On the H100 this form compiles in seconds
    at tens of blocks but did not finish compiling at thousands
    (PERF.md); the GPU routes large BSR products to the Pallas kernel."""
    gathered = jnp.take(dense_blk, block_cols, axis=0, mode="clip")
    if blocks.dtype == jnp.int8:
        prod = jax.lax.dot_general(
            blocks, gathered,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32) * scales[:, None, None]
    else:
        prod = jax.lax.dot_general(
            blocks, gathered,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
            precision=(jax.lax.Precision.HIGHEST
                       if blocks.dtype == jnp.float32
                       else jax.lax.Precision.DEFAULT),
        )
    return jax.ops.segment_sum(
        prod, block_rows, num_segments=n_block_rows, indices_are_sorted=True
    )


@functools.partial(jax.jit, static_argnames=("n_block_rows", "n_rows"))
def _bsr_spmm_device(block_rows, block_cols, blocks, dense, n_block_rows, n_rows):
    b = blocks.shape[1]
    dense_blk = dense.reshape(dense.shape[0] // b, b, dense.shape[1])
    out_blk = block_products(block_rows, block_cols, blocks, dense_blk,
                             n_block_rows)
    out = out_blk.reshape(n_block_rows * b, dense.shape[1])
    return out[:n_rows]


def bsr_spmm_xla_plan(bsr: BSR, dtype=None, **_ignored):
    """Host prep once -> jitted C = f(B). B is zero-padded to the block
    grid's column coverage on the fly (cheap, fused by XLA)."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import reject_int8_cast

    reject_int8_cast(dtype, "bsr_xla (use bsr_int8)")
    dev = bsr.device_put(dtype=dtype)
    k_needed = dev.n_block_cols * dev.b
    n_rows, n_cols = bsr.shape
    dtype_key = None if dtype is None else jnp.dtype(dtype).name
    arrays = (dev.block_rows, dev.block_cols, dev.blocks)
    statics = (dev.n_block_rows, n_rows, n_cols, k_needed, dtype_key)
    return Plan(arrays, _bsr_xla_apply, statics)


@functools.partial(jax.jit, static_argnames="statics")
def _bsr_xla_apply(statics, arrays, dense):
    # one fused program: pad + astype + kernel (no eager pre-op
    # dispatches)
    n_block_rows, n_rows, n_cols, k_needed, dtype_key = statics
    block_rows, block_cols, blocks = arrays
    dense = jnp.asarray(dense)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    if k_needed != dense.shape[0]:
        dense = jnp.pad(dense, ((0, k_needed - dense.shape[0]), (0, 0)))
    if dtype_key is not None:
        dense = dense.astype(dtype_key)
    return _bsr_spmm_device(
        block_rows, block_cols, blocks, dense, n_block_rows, n_rows
    )


def bsr_spmm_xla(bsr: BSR, dense) -> jnp.ndarray:
    return bsr_spmm_xla_plan(bsr)(dense)
