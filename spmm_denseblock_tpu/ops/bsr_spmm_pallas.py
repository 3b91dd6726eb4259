"""BSR SpMM as a Pallas kernel for Hopper, through Pallas' Triton route.

A re-design of the reference's rocSPARSE BSR kernels
(rocsparse_bsrmm_impl.h:315-389), not a translation: there one thread
group owns a block-row, stages the gathered B rows in shared memory and
accumulates in registers. Here:

- one program per (F-tile, block-row). It reads its own row's extent
  from `row_ptr`, walks the row's blocks in a `fori_loop`, loads each
  (b, b) block and the (b, FT) tile of B it multiplies, and accumulates
  with `pl.dot` into an f32 (b, FT) accumulator held in registers;
- the output tile is stored exactly once, so programs share nothing and
  may run in any order. An empty block-row stores zeros;
- the F-tile is the fastest-varying grid axis, so the programs that
  re-read one block-row's A blocks (one per F-tile) run side by side
  and find them in L2.

The plain form (ops/bsr_spmm_xla.py) writes the gathered (nnzb, b, F)
operand and the (nnzb, b, F) f32 product to device memory and reads both
back for the segment-sum; this kernel moves neither.

Numerics: f32 operands multiply in IEEE f32 (Precision.HIGHEST, the
check_result 1e-4 gate; without it Triton would run TF32). bf16
operands take the tensor cores with f32 accumulation. precision="high"
runs f32 operands as three bf16 tensor-core passes (bf16x3), on
request only: every entry point (the direct plan, impl="auto", the
distributed stripes) serves f32 as IEEE f32 unless asked. int8
blocks and operand (the ops/bsr_spmm_int8.py scheme: per-block and
per-column scales) multiply int8 x int8 -> int32 on the tensor cores;
each block's product is rescaled into the f32 accumulator.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from spmm_denseblock_tpu.backend import on_gpu, pallas_interpret
from spmm_denseblock_tpu.formats.bsr import BSR
from spmm_denseblock_tpu.ops.plan import Plan, grad_plan

# pl.dot on the Triton route needs every dim of its operands >= 16;
# int8 products take 32-deep blocks.
MIN_BLOCK = 16
MIN_BLOCK_INT8 = 32

# HIGHEST: IEEE f32 for f32 operands (for bf16 and int8 it only keeps
# Triton off its TF32 input mode, which those types ignore).
_PRECISIONS = {
    None: lax.Precision.HIGHEST,
    "high": lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
}


def _kernel(row_ptr_ref, cols_ref, blocks_ref, dense_ref, *refs, precision,
            kc):
    # refs: (scales_ref, out_ref) for int8 blocks, else (out_ref,)
    *scales_ref, out_ref = refs
    b, ft = out_ref.shape
    f0 = pl.program_id(0) * ft
    r = pl.program_id(1)

    def body(k, acc):
        # kc < b splits each block's product along K, so an IEEE f32
        # dot (CUDA cores, no tensor-core layout) holds a (b, kc) slice
        # of A in registers instead of the whole block
        x0 = cols_ref[k] * b
        prod = None
        for k0 in range(0, b, kc):
            p = pl.dot(
                blocks_ref[k, :, pl.ds(k0, kc)],
                dense_ref[pl.ds(x0 + k0, kc), pl.ds(f0, ft)],
                precision=precision,
            )
            prod = p if prod is None else prod + p
        if scales_ref:
            return acc + prod.astype(jnp.float32) * scales_ref[0][k]
        return acc + prod

    out_ref[...] = lax.fori_loop(
        row_ptr_ref[r], row_ptr_ref[r + 1], body,
        jnp.zeros((b, ft), jnp.float32),
    )


def tile_config(b: int, f: int, itemsize: int, precision=None):
    """(F-tile, num_warps, num_stages, K-chunk) for one block size and
    width.

    Chosen on an H100 at the serve_headline shape (b=128, F=512; PERF.md):
    bf16x3 (precision="high") runs best at F-tile 128 with 8 warps and
    2 stages (3.49 ms vs 4.53 ms at 64/8/2); bf16 at F-tile 64 with 8
    warps (1.52-1.55 ms at 2-3 stages, within noise); IEEE f32 at
    F-tile 64, 8 warps, 2 stages with each block split into 16-deep K
    slices (9.99 ms, against 30.3 ms at 4 warps and 267 ms unsplit; see
    _kernel). Otherwise the F-tile is 64, or the
    smallest power of two >= 16 covering a narrower width, and stages
    fill what a block's shared memory holds (A block + B tile per stage,
    under 200 KB)."""
    cap = 128 if precision == "high" and b <= 128 else 64
    ft = 16
    while ft < min(f, cap):
        ft *= 2
    if cap == 128:
        return ft, 8, 2, b
    warps = 8 if b * ft >= 128 * 64 else 4
    if precision is None and itemsize == 4:
        return ft, warps, 2, min(b, 16)
    per_stage = (b * b + b * ft) * itemsize
    stages = max(1, min(3, (200 * 1024) // per_stage))
    return ft, warps, stages, b


@functools.partial(
    jax.jit,
    static_argnames=("ft", "num_warps", "num_stages", "kc", "precision",
                     "interpret"),
)
def bsr_spmm_triton(row_ptr, cols, blocks, dense, scales=None, *, ft,
                    num_warps, num_stages, kc=None, precision=None,
                    interpret=False):
    """C = A @ dense for a row-sorted block list. dense: (K, F) with F a
    multiple of ft and K covering every block column; int8 blocks carry
    per-block `scales`; kc (default b) splits each block's product along
    K. Returns the (n_block_rows * b, F) f32 product."""
    nbr = row_ptr.shape[0] - 1
    b = blocks.shape[1]
    f = dense.shape[1]
    inputs = (row_ptr, cols, blocks, dense) + (
        () if scales is None else (scales,))
    return pl.pallas_call(
        functools.partial(_kernel, precision=_PRECISIONS[precision],
                          kc=kc or b),
        out_shape=jax.ShapeDtypeStruct((nbr * b, f), jnp.float32),
        grid=(f // ft, nbr),
        out_specs=pl.BlockSpec((b, ft), lambda j, r: (r, j)),
        compiler_params=plt.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="bsr_spmm",
    )(*inputs)


def kernel_product(row_ptr, cols, blocks, dense, scales=None, *,
                   precision=None, interpret=False):
    """bsr_spmm_triton at the tiles tile_config picks, for any operand
    width: dense (K, F) is padded to the F-tile and the (n_block_rows *
    b, F) f32 product sliced back."""
    b = blocks.shape[1]
    f = dense.shape[1]
    ft, warps, stages, kc = tile_config(b, f, blocks.dtype.itemsize,
                                        precision)
    f_padded = -(-f // ft) * ft
    if f_padded != f:
        dense = jnp.pad(dense, ((0, 0), (0, f_padded - f)))
    return bsr_spmm_triton(
        row_ptr, cols, blocks, dense, scales, ft=ft, num_warps=warps,
        num_stages=stages, kc=kc, precision=precision, interpret=interpret,
    )[:, :f]


def pow2_blocks(bsr: BSR) -> BSR:
    """The same matrix on a block grid the kernel takes: a block size
    that is not a power of two is rounded up to the next one and the
    elements re-blocked exactly (through CSR); others come back as is."""
    b = bsr.b
    if not b & (b - 1):
        return bsr
    from spmm_denseblock_tpu.convert.csr2bsr import bsr_to_csr, csr_to_bsr

    return csr_to_bsr(bsr_to_csr(bsr), 1 << b.bit_length())


def auto_uses_kernel() -> bool:
    """Whether impl='auto' sends block-sparse products to this kernel:
    on a GPU, at every block size (pow2_blocks) and dtype, f32 at its
    IEEE default. There XLA's plain forms (bsr_xla, bsr_int8) did not
    finish compiling at the serve_headline shape in minutes (f32: 5.5
    minutes, then a failed launch; PERF.md, Findings). Elsewhere the
    kernel would run only in the interpreter, so auto takes bsr_xla."""
    return on_gpu()


def kernel_layout(bsr: BSR, min_block: int = MIN_BLOCK) -> BSR:
    """The matrix in a block size the kernel takes: a power of two
    >= min_block. Smaller power-of-two blocks are repacked exactly
    (convert/pack.repack_bsr); other sizes are refused."""
    b = bsr.b
    if b & (b - 1):
        raise ValueError(
            f"bsr_pallas needs a power-of-two block size, got b={b}; "
            "pow2_blocks() re-blocks it (impl='auto' does)"
        )
    if b < min_block:
        from spmm_denseblock_tpu.convert.pack import repack_bsr

        return repack_bsr(bsr, min_block)
    return bsr


def _row_layout(lay: BSR):
    """(row_ptr, block_cols, blocks) host arrays for the kernel; an empty
    matrix gets one zero block so every array is non-empty."""
    b = lay.b
    rows = np.asarray(lay.block_rows[: lay.nnzb], np.int64)
    cols = np.asarray(lay.block_cols[: lay.nnzb], np.int32)
    blocks = np.asarray(lay.blocks[: lay.nnzb], np.float32)
    if rows.size == 0:
        rows = np.zeros(1, np.int64)
        cols = np.zeros(1, np.int32)
        blocks = np.zeros((1, b, b), np.float32)
    row_ptr = np.searchsorted(
        rows, np.arange(lay.n_block_rows + 1)
    ).astype(np.int32)
    return row_ptr, cols, blocks


def bsr_spmm_pallas_plan(bsr: BSR, dtype=None, grad: bool = True,
                         precision=None):
    """Host layout prep once -> jitted C = f(B).

    dtype: optional cast for blocks and B (e.g. jnp.bfloat16);
    accumulation is always f32. precision: None (IEEE f32 for f32
    operands) or "high" (bf16x3 for f32 operands).

    grad=True (default) attaches a custom VJP so models train through
    the kernel: dB = A^T @ dC runs the same kernel on the transposed
    layout, built once here. grad=False skips that copy."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import reject_int8_cast

    reject_int8_cast(dtype, "bsr_pallas (use bsr_int8)")
    if precision not in _PRECISIONS:
        raise ValueError(
            f"precision must be one of {sorted(map(str, _PRECISIONS))}, "
            f"got {precision!r}"
        )
    if precision == "high" and dtype is not None and (
        jnp.dtype(dtype) != jnp.float32
    ):
        raise ValueError("precision='high' applies to f32 operands only")
    if grad:
        return grad_plan(
            bsr_spmm_pallas_plan(bsr, dtype, False, precision),
            bsr_spmm_pallas_plan(bsr.transpose(), dtype, False, precision),
        )
    interpret = pallas_interpret()
    lay = kernel_layout(bsr)
    row_ptr, cols, blocks = _row_layout(lay)
    blocks = blocks.astype(jnp.dtype(jnp.float32 if dtype is None else dtype))
    arrays = (jnp.asarray(row_ptr), jnp.asarray(cols), jnp.asarray(blocks))
    n_rows, n_cols = bsr.shape
    statics = (n_rows, n_cols, lay.n_block_cols * lay.b, precision,
               interpret)
    return Plan(arrays, _pallas_apply, statics)


def bsr_spmm_pallas_int8_plan(bsr: BSR, calibration=None, **_ignored):
    """Quantized serving through the kernel (inference only): blocks
    quantized per block at plan time, the operand per column per call
    (calibration= fixes those scales at plan time) — the scheme and
    contract of ops/bsr_spmm_int8.py, with the product on the int8
    tensor cores instead of XLA's materialized gather."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import (
        quantize_blocks,
        reject_grad_request,
        static_col_scale,
    )

    reject_grad_request(_ignored, "bsr_int8_pallas")
    interpret = pallas_interpret()
    lay = kernel_layout(bsr, MIN_BLOCK_INT8)
    row_ptr, cols, blocks = _row_layout(lay)
    qblocks, scales = quantize_blocks(blocks)
    cs = None if calibration is None else jnp.asarray(
        static_col_scale(calibration))
    arrays = (jnp.asarray(row_ptr), jnp.asarray(cols), jnp.asarray(qblocks),
              jnp.asarray(scales), cs)
    n_rows, n_cols = bsr.shape
    statics = (n_rows, n_cols, lay.n_block_cols * lay.b, None, interpret)
    return Plan(arrays, _pallas_apply, statics)


@functools.partial(jax.jit, static_argnames="statics")
def _pallas_apply(statics, arrays, dense):
    n_rows, n_cols, k_needed, precision, interpret = statics
    row_ptr, cols, blocks = arrays[:3]
    dense = jnp.asarray(dense)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    scales = col_scale = None
    if blocks.dtype == jnp.int8:
        from spmm_denseblock_tpu.ops.bsr_spmm_int8 import quantize_per_column

        scales = arrays[3]
        dense, col_scale = quantize_per_column(
            dense.astype(jnp.float32), arrays[4])
    dense = jnp.pad(dense.astype(blocks.dtype),
                    ((0, k_needed - n_cols), (0, 0)))
    out = kernel_product(row_ptr, cols, blocks, dense, scales,
                         precision=precision, interpret=interpret)[:n_rows]
    return out if col_scale is None else out * col_scale[None, :]


def bsr_spmm_pallas(bsr: BSR, dense, **kw) -> jnp.ndarray:
    return bsr_spmm_pallas_plan(bsr, **kw)(dense)
