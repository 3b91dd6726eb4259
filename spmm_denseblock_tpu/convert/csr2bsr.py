"""CSR <-> BSR conversion (host, vectorized numpy).

Replaces the reference's cuSPARSE two-phase protocol
(cusparseXcsr2bsrNnz then cusparseScsr2bsr,
/root/reference/run_bsrmm.cu:121-142) and the hand-rolled host converter
(getBSR, /root/reference/my_run_bsr.cu:34-121). Here the conversion is a
host-side preprocessing step (like the reference's, it runs once and the
result is reused across SpMM calls); a jit-able device variant lives in
ops/device_convert.py.

Blocks are stored row-major within a block (dense[r, c] -> blocks[k, r%b,
c%b]) — the reference has both conventions (col-major my_run_bsr.cu:104,
row-major divide.cu:116); we standardize on row-major to match jnp.
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.formats.bsr import BSR


def csr_to_bsr(csr: CSR, block_size: int) -> BSR:
    """Two-phase like the cuSPARSE protocol: (1) count distinct nonzero
    blocks (nnzb), (2) scatter element values into (nnzb, b, b)."""
    b = block_size
    n_rows, n_cols = csr.shape
    nbc = -(-n_cols // b)

    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = csr.values()

    brow, bcol = rows // b, cols // b
    bkey = brow * nbc + bcol
    # phase 1: nnzb count
    uniq, inv = np.unique(bkey, return_inverse=True)
    nnzb = uniq.shape[0]
    # phase 2: scatter fill
    blocks = np.zeros((nnzb, b, b), dtype=np.float32)
    np.add.at(blocks, (inv, rows % b, cols % b), vals)
    return BSR.from_parts(
        (uniq // nbc).astype(np.int32),
        (uniq % nbc).astype(np.int32),
        blocks,
        csr.shape,
        b,
    )


def bsr_to_csr(bsr: BSR) -> CSR:
    """Inverse conversion, dropping explicit zeros *not* (parity with
    cusparseSbsr2csr which keeps nnz = nnzb*b^2 including the zero fill,
    /root/reference/bsr2csr.cu:186-192): we keep all b^2 cells per stored
    block so a round-trip reproduces the reference's nnz accounting."""
    b = bsr.b
    nnzb = bsr.nnzb
    brows = np.asarray(bsr.block_rows[:nnzb], dtype=np.int64)
    bcols = np.asarray(bsr.block_cols[:nnzb], dtype=np.int64)
    blocks = np.asarray(bsr.blocks[:nnzb], dtype=np.float32)

    rr, cc = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    rows = (brows[:, None, None] * b + rr[None]).ravel()
    cols = (bcols[:, None, None] * b + cc[None]).ravel()
    vals = blocks.ravel()
    # clip cells that padded past the logical shape
    keep = (rows < bsr.shape[0]) & (cols < bsr.shape[1])
    return CSR.from_coo(rows[keep], cols[keep], vals[keep], bsr.shape)


def csr_to_bsr_pruned(csr: CSR, block_size: int) -> BSR:
    """Like csr_to_bsr but also a building block for repacking: identical
    today, kept as the named entry point convert callers use when they
    want zero-block pruning semantics made explicit."""
    return csr_to_bsr(csr, block_size)
