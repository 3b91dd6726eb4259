"""SDDMM — sampled dense-dense matmul: out_e = <x[row_e], y[col_e]>.

The companion op to SpMM for attention-style GNNs (GAT/transformer-conv):
SpMM aggregates neighbor features; SDDMM computes per-edge scores from
endpoint features. The reference stops at SpMM; a complete sparse
framework for the same workloads needs both (they are adjoints: SDDMM is
the VJP of SpMM's values, and vice versa).

Two tiers:
- element tier (any CSR): gather both endpoint rows, rowwise dot on the
  vector units — one fused XLA program.
- block tier (BSR structure): per nonzero block, a (b,d)@(d,b) batched
  matmul producing the full (b,b) score block — for densified graphs
  this turns edge scoring into matrix-unit work.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR


@functools.partial(jax.jit, static_argnames=())
def _sddmm_element(row_ids, col_ids, x, y):
    xg = jnp.take(x, row_ids, axis=0)  # (nnz, d)
    yg = jnp.take(y, col_ids, axis=0)  # (nnz, d)
    return jnp.sum(xg * yg, axis=-1)


def sddmm_plan(csr: CSR):
    """Host prep once -> jitted e = f(x, y) with e[k] matching the csr's
    k-th stored nonzero position (row-major order)."""
    row_ids = jnp.asarray(csr.row_ids())
    col_ids = jnp.asarray(np.asarray(csr.indices, dtype=np.int32))

    def run(x, y):
        return _sddmm_element(row_ids, col_ids, jnp.asarray(x), jnp.asarray(y))

    return run


def sddmm(csr: CSR, x, y) -> jax.Array:
    return sddmm_plan(csr)(x, y)


@functools.partial(jax.jit, static_argnames=())
def _sddmm_block(block_rows, block_cols, x_blocked, y_blocked):
    xg = jnp.take(x_blocked, block_rows, axis=0)  # (nnzb, b, d)
    yg = jnp.take(y_blocked, block_cols, axis=0)  # (nnzb, b, d)
    prec = (
        jax.lax.Precision.HIGHEST
        if x_blocked.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    return jax.lax.dot_general(
        xg,
        yg,
        dimension_numbers=(((2,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
        precision=prec,
    )  # (nnzb, b, b)


@functools.partial(jax.jit, static_argnames=("b", "r_pad", "c_pad"))
def _sddmm_block_run(br, bc, x, y, b, r_pad, c_pad):
    # one fused program: pads + gathers + batched matmul (the eager pads
    # each cost a dispatch round-trip — the plan-family fuse-pass rule);
    # br/bc are jit ARGS, never HLO constants (ops/plan.py rule)
    x = jnp.pad(x, ((0, r_pad - x.shape[0]), (0, 0)))
    y = jnp.pad(y, ((0, c_pad - y.shape[0]), (0, 0)))
    xb = x.reshape(r_pad // b, b, x.shape[1])
    yb = y.reshape(c_pad // b, b, y.shape[1])
    return _sddmm_block(br, bc, xb, yb)


def sddmm_block_plan(block_rows, block_cols, block_size: int, n_rows: int, n_cols: int):
    """Block tier: returns f(x, y) -> (nnzb, b, b) score blocks for the
    given block coordinate lists (e.g. a BSR sparsity pattern). x: (n_rows,
    d), y: (n_cols, d); rows/cols are padded up to the block grid."""
    b = block_size
    br = jnp.asarray(np.asarray(block_rows, dtype=np.int32))
    bc = jnp.asarray(np.asarray(block_cols, dtype=np.int32))
    r_pad = -(-n_rows // b) * b
    c_pad = -(-n_cols // b) * b

    def run(x, y):
        return _sddmm_block_run(
            br, bc, jnp.asarray(x), jnp.asarray(y), b, r_pad, c_pad
        )

    return run
