"""Hybrid SpMM: dense-block Pallas/XLA GEMM part + remainder CSR part.

One jitted function computes both and sums — XLA schedules the
memory-bound CSR gather alongside the block GEMMs, the JAX version of
divide.cu's two accumulating library calls
(/root/reference/divide.cu:348-373).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spmm_denseblock_tpu.formats.hybrid import Hybrid
from spmm_denseblock_tpu.ops.csr_spmm_ell import csr_spmm_ell_plan
from spmm_denseblock_tpu.ops.bsr_spmm_xla import bsr_spmm_xla_plan
from spmm_denseblock_tpu.ops.bsr_spmm_pallas import (
    auto_uses_kernel,
    bsr_spmm_pallas_plan,
    pow2_blocks,
)
from spmm_denseblock_tpu.ops.plan import sum_plan


def hybrid_spmm_plan(
    hyb: Hybrid, dense_impl: str = "auto", dtype=None, grad: bool = True,
    bucket: str = "quarter", reduce: str = "auto", row_sort: str = "keep",
    compact: str = "off", compact_slots: int = None, feat_dim: int = 128,
):
    """grad=False skips the transposed-layout copies the VJP needs —
    halves device memory for inference/bench plans (a full-products
    hybrid OOM'd on the doubled footprint). `bucket` selects the ELL
    remainder's degree-class scheme (csr_spmm_ell._row_widths);
    `row_sort` its intra-class row order (meancol = gather locality);
    `compact`/`compact_slots` its two-level gather mode (unique
    sub-table compaction — see csr_spmm_ell.COMPACT_SLOTS model).
    dense_impl: "pallas", "xla", or "auto" (the kernel where the BSR
    router would pick it: bsr_spmm_pallas.auto_uses_kernel)."""
    ell_kw = dict(bucket=bucket, reduce=reduce, row_sort=row_sort,
                  compact=compact, feat_dim=feat_dim)
    if compact_slots is not None:
        ell_kw["compact_slots"] = compact_slots
    if hyb.dense.nnzb == 0:
        return csr_spmm_ell_plan(hyb.remainder, grad=grad, dtype=dtype,
                                 **ell_kw)
    if dense_impl == "auto":
        dense_impl = "pallas" if auto_uses_kernel() else "xla"
    if dense_impl == "pallas":
        bsr_run = bsr_spmm_pallas_plan(pow2_blocks(hyb.dense), dtype=dtype,
                                       grad=grad)
    else:
        bsr_run = bsr_spmm_xla_plan(hyb.dense, dtype=dtype)
    # dtype also reaches the ELL remainder: on gather-bound graphs
    # (proteins/products) the remainder gather IS the runtime, and a bf16
    # gather halves that traffic (opt-in reduced precision, ~1e-3 rel).
    csr_run = csr_spmm_ell_plan(hyb.remainder, grad=grad, dtype=dtype,
                                **ell_kw)

    if hyb.remainder.nnz == 0:
        return bsr_run
    return sum_plan((bsr_run, csr_run))


def hybrid_spmm_int8_plan(
    hyb: Hybrid, calibration=None,
    bucket: str = "quarter", reduce: str = "auto", row_sort: str = "keep",
    compact: str = "off", compact_slots: int = None, feat_dim: int = 128,
    **_ignored,
):
    """Serving composition of the two int8 tiers: dense blocks through
    the int8 kernel on a GPU, bsr_int8 elsewhere + the ELL remainder
    through the int8-table gather (half the bf16 gather bytes). Inference
    only; both parts quantize the operand with the same per-column
    scheme, so accuracy matches the single-tier ~1e-2 envelope.
    impl='hybrid_int8'."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import (
        bsr_spmm_int8_plan,
        reject_grad_request,
    )
    from spmm_denseblock_tpu.ops.bsr_spmm_pallas import (
        bsr_spmm_pallas_int8_plan,
    )
    from spmm_denseblock_tpu.ops.csr_spmm_ell import csr_spmm_ell_int8_plan

    reject_grad_request(_ignored, "hybrid_int8")
    ell_kw = dict(bucket=bucket, reduce=reduce, row_sort=row_sort,
                  compact=compact, feat_dim=feat_dim)
    if compact_slots is not None:
        ell_kw["compact_slots"] = compact_slots
    if hyb.dense.nnzb == 0:
        return csr_spmm_ell_int8_plan(hyb.remainder, calibration=calibration,
                                      **ell_kw)
    if auto_uses_kernel():
        dense_plan = bsr_spmm_pallas_int8_plan(pow2_blocks(hyb.dense),
                                               calibration=calibration)
    else:
        dense_plan = bsr_spmm_int8_plan(hyb.dense, calibration=calibration)
    if hyb.remainder.nnz == 0:
        return dense_plan
    rem_plan = csr_spmm_ell_int8_plan(hyb.remainder, calibration=calibration,
                                      **ell_kw)
    return sum_plan((dense_plan, rem_plan))


def hybrid_spmm(hyb: Hybrid, dense, **kw) -> jax.Array:
    return hybrid_spmm_plan(hyb, **kw)(dense)
