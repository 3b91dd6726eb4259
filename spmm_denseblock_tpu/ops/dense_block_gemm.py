"""Standalone dense-block GEMM path.

The analog of the reference's per-block cuBLAS GEMM driver
(/root/reference/block_cublas.cu:118-136, test_block_cublas.cu:273-284,
which round-robins blocks over 32 CUDA streams). In JAX there are no
streams to juggle: the batched dot_general below IS the fused,
scheduler-friendly form — every (b x b) @ (b x F) GEMM is a batch element
and XLA hands the batch to one batched GEMM.

Exposed separately from bsr_spmm_xla because it accepts *unsorted* block
lists and scatter-adds into C (the cuBLAS path's semantics), whereas the
BSR paths require row-sorted blocks for the monotonic segment-sum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n_block_rows",))
def dense_block_gemm(block_rows, block_cols, blocks, dense_blk, n_block_rows: int):
    """blocks: (nnzb, b, b); dense_blk: (n_block_cols, b, F) blocked dense
    operand; returns (n_block_rows, b, F) blocked output."""
    gathered = jnp.take(dense_blk, block_cols, axis=0)
    prod = jax.lax.dot_general(
        blocks,
        gathered,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    out = jnp.zeros((n_block_rows, blocks.shape[1], dense_blk.shape[2]), jnp.float32)
    return out.at[block_rows].add(prod)
