"""CSR SpMM via XLA gather + segment-sum.

Design note (vs the reference's GE-SpMM warp kernels,
/root/reference/gespmm_csrmm.h:96-377): element-sparse SpMM is
gather-bandwidth-bound on any hardware; the GPU kernels stage (colInd,
val) chunks in shared memory to coalesce the B-row gathers. The XLA-
idiomatic formulation is data-parallel over nonzeros with static shapes:

    P[e, :] = val[e] * B[col[e], :]        (one gather, one scale)
    C = segment_sum(P, row[e])             (one sorted scatter-add)

XLA lowers the gather/scatter to efficient dynamic-slice loops and fuses
the scale; since row ids are sorted, segment_sum uses the monotonic path.
This is the CSR baseline tier; the dense-block win lives in the BSR tiers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.ops.plan import Plan, sum_plan


@functools.partial(jax.jit, static_argnames=("n_rows",))
def _csr_spmm_device(row_ids, col_ids, vals, dense, n_rows: int):
    gathered = jnp.take(dense, col_ids, axis=0)
    if vals is not None:
        gathered = gathered * vals[:, None]
    out = jax.ops.segment_sum(
        gathered, row_ids, num_segments=n_rows, indices_are_sorted=True
    )
    return out.astype(jnp.float32)


CHUNK_NNZ_BYTES = 4 << 30  # gather-intermediate budget for auto-chunking


def csr_spmm_plan(csr: CSR, chunk_nnz=None):
    """Host-side layout prep once; returns a jitted C = f(B) closure.

    The gather materializes an (nnz, F) intermediate; at ogbn-products
    scale that is tens of GB. When nnz exceeds `chunk_nnz` (default: auto
    from CHUNK_NNZ_BYTES assuming F<=512 f32), the plan splits the
    nonzeros into row-sorted chunks and sums per-chunk segment-sums —
    peak memory drops to chunk_nnz * F * 4 while outputs stay exact
    (partial row sums add)."""
    if chunk_nnz is None:
        chunk_nnz = max(1, CHUNK_NNZ_BYTES // (512 * 4))
    n_rows = csr.n_rows
    row_ids_h = csr.row_ids()
    col_ids_h = np.asarray(csr.indices, dtype=np.int32)
    vals_h = None if csr.data is None else np.asarray(csr.data)

    if csr.nnz <= chunk_nnz:
        arrays = (
            jnp.asarray(row_ids_h),
            jnp.asarray(col_ids_h),
            None if vals_h is None else jnp.asarray(vals_h),
        )
        return Plan(arrays, _csr_xla_apply, (n_rows,))

    n_chunks = -(-csr.nnz // chunk_nnz)
    parts = []
    for c in range(n_chunks):
        sl = slice(c * chunk_nnz, min((c + 1) * chunk_nnz, csr.nnz))
        arrays = (
            jnp.asarray(row_ids_h[sl]),
            jnp.asarray(col_ids_h[sl]),
            None if vals_h is None else jnp.asarray(vals_h[sl]),
        )
        parts.append(Plan(arrays, _csr_xla_apply, (n_rows,)))
    return sum_plan(parts)


@functools.partial(jax.jit, static_argnames="statics")
def _csr_xla_apply(statics, arrays, dense):
    (n_rows,) = statics
    row_ids, col_ids, vals = arrays
    return _csr_spmm_device(row_ids, col_ids, vals, jnp.asarray(dense), n_rows)


def csr_spmm(csr: CSR, dense) -> jnp.ndarray:
    return csr_spmm_plan(csr)(dense)


def bcoo_spmm_plan(csr: CSR):
    """jax.experimental.sparse.BCOO comparison path — the analog of the
    reference's OpenAI-blocksparse cross-library check
    (/root/reference/check_blocksparse.py)."""
    from jax.experimental import sparse as jsparse

    coo = np.stack([csr.row_ids(), np.asarray(csr.indices)], axis=1)
    mat = jsparse.BCOO(
        (jnp.asarray(csr.values()), jnp.asarray(coo.astype(np.int32))),
        shape=csr.shape,
        indices_sorted=True,
        unique_indices=False,  # adjacency lists may carry duplicate edges
    )

    @jax.jit
    def run(dense):
        return (mat @ jnp.asarray(dense)).astype(jnp.float32)

    return run
