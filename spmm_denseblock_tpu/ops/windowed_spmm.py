"""SpMM over the windowed dense-tile format (formats/windowed.py).

One jitted program: a batched matmul over the window tiles (each
tile's B window is ONE contiguous (W, F) slice — streaming HBM reads,
no scattered row gathers) plus the remainder CSR segment-sum, summed.
Output rows of tile t are exactly rows [t*R, (t+1)*R): no scatter on
the output either.

This is where the reordering investment pays: the CSR gather path is
latency-bound on scattered row gathers, while the windowed path turns
the same nonzeros into dense (R, W) @ (W, F) matmuls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from spmm_denseblock_tpu.formats.windowed import Windowed
from spmm_denseblock_tpu.ops.csr_spmm_ell import csr_spmm_ell_plan
from spmm_denseblock_tpu.ops.plan import Plan, sum_plan


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _windowed_matmul(tiles, win_idx, dense_blocked, n_rows: int):
    # tiles: (T, K, R, W); dense_blocked: (n_win, W, F); gather one
    # contiguous window per (tile, slot), matmul, sum the K slots
    wins = jnp.take(dense_blocked, win_idx, axis=0)  # (T, K, W, F)
    prec = (
        jax.lax.Precision.HIGHEST
        if tiles.dtype == jnp.float32
        else jax.lax.Precision.DEFAULT
    )
    out_tiles = jax.lax.dot_general(
        tiles,
        wins,
        dimension_numbers=(((3,), (2,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.float32,
        precision=prec,
    )  # (T, K, R, F)
    out = jnp.sum(out_tiles, axis=1).reshape(-1, out_tiles.shape[-1])
    return out[:n_rows]


@functools.partial(jax.jit, static_argnames="statics")
def _windowed_apply(statics, arrays, dense):
    # one fused program: pad + cast + blocked matmul (fuse-pass rule —
    # eager pre-ops would each be a dispatch of their own)
    n_rows, n_cols, k_padded, W, dtype_key = statics
    tiles, win_idx = arrays
    dense = jnp.asarray(dense)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    d = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    if dtype_key is not None:
        d = d.astype(dtype_key)
    blocked = d.reshape(k_padded // W, W, d.shape[1])
    return _windowed_matmul(tiles, win_idx, blocked, n_rows)


def windowed_spmm_plan(wt: Windowed, dtype=None, grad: bool = True):
    """Host prep once -> Plan C = f(B) (callable pytree; see ops/plan.py)."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import reject_int8_cast

    reject_int8_cast(dtype, "windowed (use windowed_int8)")
    R, W = wt.tile_rows, wt.window
    n_rows, n_cols = wt.shape
    k_padded = -(-n_cols // W) * W
    tiles = jnp.asarray(wt.tiles)
    if dtype is not None:
        tiles = tiles.astype(dtype)
    win_idx = jnp.asarray(wt.win_idx)
    dtype_key = None if dtype is None else jnp.dtype(dtype).name
    win_plan = Plan(
        (tiles, win_idx),
        _windowed_apply,
        (n_rows, n_cols, k_padded, W, dtype_key),
    )
    if not wt.remainder.nnz:
        return win_plan
    return sum_plan((win_plan, csr_spmm_ell_plan(wt.remainder, grad=grad)))


def windowed_spmm(wt: Windowed, dense, **kw) -> jax.Array:
    return windowed_spmm_plan(wt, **kw)(dense)


def windowed_spmm_int8_plan(wt: Windowed, calibration=None, **_ignored):
    """Quantized windowed tier: per-(tile,slot) int8 weight scales x
    per-column operand scales, int32 accumulation — the serving
    path for reordered real graphs (inference-only). calibration:
    optional representative operand batch; fixes the per-column scales
    at plan time (static-scale serving, same contract as the other
    int8 tiers)."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import reject_grad_request

    reject_grad_request(_ignored, "windowed_int8")
    import numpy as np

    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import (
        quantize_blocks,
        static_col_scale,
    )

    R, W = wt.tile_rows, wt.window
    n_rows, n_cols = wt.shape
    k_padded = -(-n_cols // W) * W
    T, K = wt.n_tiles, wt.n_windows_per_tile

    flat = np.asarray(wt.tiles, dtype=np.float32).reshape(T * K, R, W)
    q, scales = quantize_blocks(flat)
    q_tiles = jnp.asarray(q.reshape(T, K, R, W))
    sc = jnp.asarray(scales.reshape(T, K).astype(np.float32))
    win_idx = jnp.asarray(wt.win_idx)
    cs = (
        None if calibration is None
        else jnp.asarray(static_col_scale(calibration))
    )
    # inference-only tier: no VJP layout copies for the remainder
    rem_plan = (
        csr_spmm_ell_plan(wt.remainder, grad=False)
        if wt.remainder.nnz else None
    )

    win_plan = Plan(
        (q_tiles, sc, win_idx, cs),
        _windowed_int8_apply,
        (n_rows, n_cols, k_padded, W),
    )
    if rem_plan is None:
        return win_plan
    return sum_plan((win_plan, rem_plan))


@functools.partial(jax.jit, static_argnames="statics")
def _windowed_int8_apply(statics, arrays, dense):
    # module-level fused apply (was a per-plan closure: retraces were
    # not shared across plans of the family, and the eager f32 cast
    # dispatched separately — the fuse-pass rule)
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import quantize_per_column

    n_rows, n_cols, k_padded, W = statics
    q_tiles, sc, win_idx, cs = arrays
    dense = jnp.asarray(dense, jnp.float32)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    d = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    qd, col_scale = quantize_per_column(d, cs)
    blocked = qd.reshape(k_padded // W, W, qd.shape[1])
    wins = jnp.take(blocked, win_idx, axis=0)  # (T, K, W, F) int8
    prod = jax.lax.dot_general(
        q_tiles,
        wins,
        dimension_numbers=(((3,), (2,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.int32,
    )  # (T, K, R, F) int32
    scaled = prod.astype(jnp.float32) * sc[:, :, None, None]
    out = jnp.sum(scaled, axis=1).reshape(-1, qd.shape[1])[:n_rows]
    return out * col_scale[None, :]


def tiered_spmm_plan(
    csr,
    tile_rows: int = 256,
    window: int = 1024,
    block_size: int = 128,
    density_threshold=None,
    dtype=None,
    grad: bool = True,
):
    """Three-tier executor: row-band window tiles (dense streaming) +
    square dense blocks mined from the windowed remainder (the hybrid
    splitter) + the final CSR tail — summed in one jitted program. The
    full composition of the framework's densification ladder."""
    from spmm_denseblock_tpu.convert.divide import auto_threshold, divide
    from spmm_denseblock_tpu.formats.windowed import divide_windowed
    from spmm_denseblock_tpu.ops.bsr_spmm_xla import bsr_spmm_xla_plan

    wt = divide_windowed(csr, tile_rows=tile_rows, window=window)
    # windows-only plan (remainder handled by the next tiers)
    wt_only = Windowed(
        tiles=wt.tiles,
        win_idx=wt.win_idx,
        remainder=type(wt.remainder).from_coo([], [], None, csr.shape),
        shape=wt.shape,
        tile_rows=wt.tile_rows,
        window=wt.window,
    )
    win_run = windowed_spmm_plan(wt_only, dtype=dtype, grad=grad)

    rem = wt.remainder
    if density_threshold is None:
        density_threshold = auto_threshold(rem, block_size)
    hyb = divide(rem, block_size, density_threshold)
    runs = [win_run]
    if hyb.dense.nnzb:
        runs.append(bsr_spmm_xla_plan(hyb.dense, dtype=dtype))
    if hyb.remainder.nnz:
        runs.append(csr_spmm_ell_plan(hyb.remainder, grad=grad))
    # Plan composition: sub-plan arrays stay jit ARGUMENTS (never HLO
    # constants) even when a training step jits through the whole tier
    return runs[0] if len(runs) == 1 else sum_plan(runs)
