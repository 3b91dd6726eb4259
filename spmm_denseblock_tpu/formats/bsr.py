"""BSR (block sparse row) format.

Design divergence from the GPU reference (the single biggest one, see
SURVEY.md §7 "Hard parts"): instead of a ragged (bsrRowPtr, bsrColInd,
bsrVal) walked per block-row by warps (/root/reference/rocsparse_bsrmm.h:
102-256), blocks live in a *flat, statically-shaped* layout:

    blocks     : (nnzb, b, b)   block values, sorted by (block_row, block_col)
    block_rows : (nnzb,) int32  segment ids
    block_cols : (nnzb,) int32  gather ids into the dense operand

This is what the XLA path (batched matmul + segment_sum) consumes
directly, and what the Pallas kernel's row-pointer layout is built from;
padding to a fixed nnzb keeps shapes static across jit calls. The block
size defaults to 128: nonzero 128x128 tiles are full tensor-core
matmuls, the analog of the reference's per-warp b<=32 dispatch
(/root/reference/rocsparse_bsrmm.h:192-252).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    """Flat block-sparse-row matrix.

    ``shape`` is the logical (possibly non-multiple-of-b) dense shape;
    block grid dims are padded up. Entries must be sorted by
    (block_row, block_col); padding blocks (all-zero, row/col pointing at
    the last block-row / col 0) may follow real entries — ``nnzb`` counts
    real blocks only.
    """

    block_rows: jax.Array  # (nnzb_padded,) int32, nondecreasing
    block_cols: jax.Array  # (nnzb_padded,) int32
    blocks: jax.Array  # (nnzb_padded, b, b)
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    block_size: int = dataclasses.field(metadata=dict(static=True))
    nnzb: int = dataclasses.field(metadata=dict(static=True))

    @property
    def b(self) -> int:
        return self.block_size

    @property
    def n_block_rows(self) -> int:
        return -(-self.shape[0] // self.block_size)

    @property
    def n_block_cols(self) -> int:
        return -(-self.shape[1] // self.block_size)

    @property
    def nnzb_padded(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def dtype(self):
        return self.blocks.dtype

    # -- analytics (reference: reorder_graph.cc:18-22) ----------------------

    def block_density(self) -> float:
        """nnzb / (n_block_rows * n_block_cols) — run_bsrmm.cu:144."""
        return self.nnzb / (self.n_block_rows * self.n_block_cols)

    def nnz_inside(self) -> int:
        blk = np.asarray(self.blocks[: self.nnzb])
        return int(np.count_nonzero(blk))

    def utilization(self) -> float:
        """nnz / (nnzb * b^2) — fraction of stored block cells that are
        nonzero (reorder_graph.cc:19)."""
        denom = self.nnzb * self.b * self.b
        return self.nnz_inside() / denom if denom else 0.0

    # -- construction / conversion -----------------------------------------

    @staticmethod
    def from_parts(
        block_rows: np.ndarray,
        block_cols: np.ndarray,
        blocks: np.ndarray,
        shape: Tuple[int, int],
        block_size: int,
    ) -> "BSR":
        order = np.lexsort((block_cols, block_rows))
        return BSR(
            block_rows=np.ascontiguousarray(block_rows[order], dtype=np.int32),
            block_cols=np.ascontiguousarray(block_cols[order], dtype=np.int32),
            blocks=np.ascontiguousarray(blocks[order]),
            shape=shape,
            block_size=block_size,
            nnzb=int(block_rows.shape[0]),
        )

    def pad_to(self, nnzb_padded: int) -> "BSR":
        """Pad with zero blocks so jit sees a stable shape. Padding rows
        point at the last block-row so the segment-sum epilogue is a no-op
        add of zeros."""
        cur = self.nnzb_padded
        if nnzb_padded < cur:
            raise ValueError(f"cannot shrink padding {cur} -> {nnzb_padded}")
        if nnzb_padded == cur:
            return self
        extra = nnzb_padded - cur
        pad_row = self.n_block_rows - 1
        return BSR(
            block_rows=np.concatenate(
                [np.asarray(self.block_rows), np.full(extra, pad_row, np.int32)]
            ),
            block_cols=np.concatenate(
                [np.asarray(self.block_cols), np.zeros(extra, np.int32)]
            ),
            blocks=np.concatenate(
                [
                    np.asarray(self.blocks),
                    np.zeros((extra, self.b, self.b), np.asarray(self.blocks).dtype),
                ]
            ),
            shape=self.shape,
            block_size=self.block_size,
            nnzb=self.nnzb,
        )

    def block_indptr(self) -> np.ndarray:
        """(n_block_rows + 1,) classic BSR rowptr over *real* blocks —
        interop with the reference's (bsrRowPtr) contract."""
        rows = np.asarray(self.block_rows[: self.nnzb])
        counts = np.bincount(rows, minlength=self.n_block_rows)
        indptr = np.zeros(self.n_block_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return indptr

    def to_dense(self) -> np.ndarray:
        b = self.b
        nbr, nbc = self.n_block_rows, self.n_block_cols
        dense = np.zeros((nbr * b, nbc * b), dtype=np.float32)
        rows = np.asarray(self.block_rows[: self.nnzb])
        cols = np.asarray(self.block_cols[: self.nnzb])
        blocks = np.asarray(self.blocks[: self.nnzb], dtype=np.float32)
        for k in range(self.nnzb):
            r, c = rows[k] * b, cols[k] * b
            dense[r : r + b, c : c + b] += blocks[k]
        return dense[: self.shape[0], : self.shape[1]]

    def transpose(self) -> "BSR":
        """A^T as BSR: swap block row/col ids, transpose each block. Used
        by the SpMM backward pass (dB = A^T @ dC)."""
        nnzb = self.nnzb
        return BSR.from_parts(
            np.asarray(self.block_cols[:nnzb]),
            np.asarray(self.block_rows[:nnzb]),
            np.asarray(self.blocks[:nnzb]).transpose(0, 2, 1),
            (self.shape[1], self.shape[0]),
            self.block_size,
        )

    def to_scipy(self):
        """scipy.sparse.bsr_matrix interop (padded to the block grid;
        .tocsr()[:n, :m] recovers the logical shape). Blocks are already
        (row, col)-sorted, matching scipy's BSR invariant."""
        import scipy.sparse as sp

        indptr = self.block_indptr()
        blocks = np.asarray(self.blocks[: self.nnzb], dtype=np.float32)
        cols = np.asarray(self.block_cols[: self.nnzb])
        nbr, nbc, b = self.n_block_rows, self.n_block_cols, self.b
        return sp.bsr_matrix(
            (blocks, cols, indptr), shape=(nbr * b, nbc * b), blocksize=(b, b)
        )

    def device_put(self, dtype=None, sharding=None) -> "BSR":
        put = lambda x: jax.device_put(x, sharding) if sharding else jnp.asarray(x)
        blocks = np.asarray(self.blocks)
        if dtype is not None:
            blocks = blocks.astype(dtype)
        return BSR(
            block_rows=put(np.asarray(self.block_rows)),
            block_cols=put(np.asarray(self.block_cols)),
            blocks=put(blocks),
            shape=self.shape,
            block_size=self.block_size,
            nnzb=self.nnzb,
        )


def random_bsr(
    p: float,
    n_block_rows: int,
    n_block_cols: Optional[int] = None,
    block_size: int = 128,
    seed: int = 1234,
    values: str = "uniform",
) -> BSR:
    """Bernoulli(p) random BSR — analog of randomBSRMatrix
    (/root/reference/load_data.cc:81-113), which fills each chosen block
    with uniform values."""
    if n_block_cols is None:
        n_block_cols = n_block_rows
    rng = np.random.default_rng(seed)
    row_nnzb = rng.binomial(n_block_cols, p, size=n_block_rows)
    cols = rng.integers(0, n_block_cols, size=int(row_nnzb.sum()), dtype=np.int64)
    rows = np.repeat(np.arange(n_block_rows, dtype=np.int64), row_nnzb)
    key = np.unique(rows * n_block_cols + cols)
    rows, cols = key // n_block_cols, key % n_block_cols
    nnzb = rows.shape[0]
    if values == "uniform":
        blocks = rng.random((nnzb, block_size, block_size), dtype=np.float32)
    else:
        blocks = np.ones((nnzb, block_size, block_size), dtype=np.float32)
    return BSR.from_parts(
        rows.astype(np.int32),
        cols.astype(np.int32),
        blocks,
        (n_block_rows * block_size, n_block_cols * block_size),
        block_size,
    )
