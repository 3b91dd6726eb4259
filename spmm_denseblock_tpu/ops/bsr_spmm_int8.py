"""int8 quantized BSR SpMM — the serving-efficiency tier.

Scheme (symmetric, zero-point-free — the integer-unit-friendly choice):
- A blocks quantized once at plan time, PER BLOCK: q_k = round(block_k /
  s_k), s_k = max|block_k| / 127. Block granularity keeps the community
  structure's magnitude variation out of the error.
- B quantized per call, PER COLUMN: s_col[f] = max|B[:, f]| / 127 — a
  cheap VPU reduction, and separable with the per-block scale so the
  int32 accumulator rescales exactly: C = sum_k (q_k @ q_B) * s_k *
  s_col.
- The matmul runs int8 x int8 -> int32 (XLA hands it to the integer
  tensor cores; H100's published int8 rate is 2x bf16), scaled to f32
  before the segment-sum.

Inference-only tier (no VJP); expected elementwise relative error ~1e-2
(quantization noise), far outside the f32 1e-4 gate — tests use a
dedicated tolerance, and the tier is opt-in (impl='bsr_int8').
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spmm_denseblock_tpu.formats.bsr import BSR


def quantize_blocks(blocks: np.ndarray):
    """(nnzb, b, b) f32 -> int8 values + (nnzb,) f32 scales.

    Reciprocal-multiply + in-place rint/clip instead of a broadcast
    divide: 5x fewer host seconds on GB-scale block arrays (the dist
    plan-time budget). vs the divide formulation
    this flips ~5e-7 of entries by one quantum at rint midpoints —
    far inside the tier's ~1e-2 quantization-noise tolerance."""
    blocks = np.asarray(blocks, dtype=np.float32)
    absmax = np.abs(blocks).max(axis=(1, 2))
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = blocks * (np.float32(1.0) / scales)[:, None, None]
    np.rint(q, out=q)
    np.clip(q, -127, 127, out=q)
    return q.astype(np.int8), scales


def static_col_scale(calibration) -> np.ndarray:
    """Per-column operand scales from a calibration batch (host, once).

    The serving fix for small graphs, where dynamic per-call
    quantization can make int8 slower than f32 (the per-column absmax
    reduction dominates at small sizes). With a
    representative batch the scales become plan constants; the per-call
    cost drops to one scale-round-cast pass. A safety margin keeps
    later batches with slightly larger activations from clipping."""
    cal = np.asarray(calibration, dtype=np.float32)
    absmax = np.abs(cal).max(axis=0) * 1.05
    return np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)


def quantize_per_column(dense, col_scale=None):
    """Symmetric per-column int8 quantization of an operand (the scheme
    every int8 tier shares — BSR, ELL, windowed, dist ELL). col_scale
    None = dynamic per-call scales (one VPU absmax reduction); returns
    (q_int8, col_scale). Traceable (used inside jitted tier bodies)."""
    if col_scale is None:
        col_absmax = jnp.max(jnp.abs(dense), axis=0)
        col_scale = jnp.where(col_absmax > 0, col_absmax / 127.0, 1.0)
    q = jnp.clip(jnp.round(dense / col_scale[None, :]), -127, 127).astype(
        jnp.int8
    )
    return q, col_scale


def reject_int8_cast(dtype, tier: str) -> None:
    """The cast-based tiers implement dtype= as a plain astype of the
    operand; astype(int8) TRUNCATES without scaling and returns silently
    wrong results. int8 needs the quantized tiers (per-column scales)."""
    if dtype is not None and jnp.dtype(dtype) == jnp.int8:
        raise ValueError(
            f"{tier} casts the operand with astype — int8 would truncate "
            "silently; use the quantized tier (csr_ell_int8 / bsr_int8 / "
            "hybrid_int8 / windowed_int8, or spmm_plan(dtype=int8) via "
            "auto) instead"
        )


def reject_grad_request(kw: dict, tier: str) -> None:
    """int8 tiers are inference-only: under jax.grad the quantization
    round() has zero derivative a.e., so a silently-built plan would
    train with all-zero operand gradients (a behavior cliff vs the bf16
    tiers, which carry a real VJP). Explicit grad=True is an error."""
    if kw.get("grad"):
        raise ValueError(
            f"{tier} is inference-only (int8 quantization has zero "
            "gradient); build the f32/bf16 plan for training or pass "
            "grad=False explicitly"
        )


@functools.partial(jax.jit, static_argnames=("n_block_rows", "n_rows"))
def _int8_spmm(
    block_rows, block_cols, qblocks, scales, dense, n_block_rows, n_rows,
    col_scale=None,
):
    from spmm_denseblock_tpu.ops.bsr_spmm_xla import block_products

    b = qblocks.shape[1]
    qdense, col_scale = quantize_per_column(dense, col_scale)
    qblk = qdense.reshape(dense.shape[0] // b, b, dense.shape[1])
    out_blk = block_products(block_rows, block_cols, qblocks, qblk,
                             n_block_rows, scales=scales)
    out_blk = out_blk * col_scale[None, None, :]
    return out_blk.reshape(n_block_rows * b, dense.shape[1])[:n_rows]


def bsr_spmm_int8_plan(bsr: BSR, calibration=None, **_ignored):
    """Host quantization once -> jitted C = f(B). Inference only.

    calibration: optional representative operand batch; fixes the
    per-column scales at plan time (static-scale serving — skips the
    per-call absmax reduction that dominates at small graph sizes)."""
    reject_grad_request(_ignored, "bsr_int8")
    qblocks, scales = quantize_blocks(
        np.asarray(bsr.blocks[: bsr.nnzb], dtype=np.float32)
    )
    br = jnp.asarray(np.asarray(bsr.block_rows[: bsr.nnzb]))
    bc = jnp.asarray(np.asarray(bsr.block_cols[: bsr.nnzb]))
    qb = jnp.asarray(qblocks)
    sc = jnp.asarray(scales)
    n_rows, n_cols = bsr.shape
    k_needed = bsr.n_block_cols * bsr.b
    cs = None if calibration is None else jnp.asarray(static_col_scale(calibration))
    from spmm_denseblock_tpu.ops.plan import Plan

    arrays = (br, bc, qb, sc, cs)
    statics = (bsr.n_block_rows, n_rows, n_cols, k_needed)
    return Plan(arrays, _int8_xla_apply, statics)


@functools.partial(jax.jit, static_argnames="statics")
def _int8_xla_apply(statics, arrays, dense):
    # one fused program: astype + pad + quantize + kernel (no eager
    # pre-op dispatches)
    n_block_rows, n_rows, n_cols, k_needed = statics
    br, bc, qb, sc, cs = arrays
    dense = jnp.asarray(dense, dtype=jnp.float32)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    if k_needed != dense.shape[0]:
        dense = jnp.pad(dense, ((0, k_needed - dense.shape[0]), (0, 0)))
    return _int8_spmm(
        br, bc, qb, sc, dense, n_block_rows, n_rows, col_scale=cs
    )


def bsr_spmm_int8(bsr: BSR, dense) -> jax.Array:
    return bsr_spmm_int8_plan(bsr)(dense)
