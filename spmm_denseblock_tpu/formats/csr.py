"""CSR format as a JAX pytree dataclass.

Design notes: a CSR matrix is a *static-shape* triple
(indptr, indices, data). Ragged per-row extents never appear inside jit —
device kernels consume either the COO view (row_ids/col_ids, used by the
XLA segment-sum SpMM) or a padded/packed layout built in ``convert/``.

Reference parity: mirrors the (rowPtr, colInd, val) triples of
/root/reference/load_data.cc:42-79 (randomCSRMatrix) and the adjacency
convention csrVal == 1.0 (/root/reference/run_csrmm.cu:66).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix.

    Fields may be numpy (host) or jax (device) arrays; conversion helpers
    below. ``data is None`` means implicit 1.0 values (adjacency matrices).
    """

    indptr: jax.Array  # (n_rows + 1,) int32
    indices: jax.Array  # (nnz,) int32
    data: Optional[jax.Array]  # (nnz,) float, or None for implicit ones
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return jnp.float32 if self.data is None else self.data.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_scipy(mat, keep_data: bool = True) -> "CSR":
        m = mat.tocsr()
        m.sort_indices()
        data = np.asarray(m.data, dtype=np.float32) if keep_data else None
        return CSR(
            indptr=np.asarray(m.indptr, dtype=np.int32),
            indices=np.asarray(m.indices, dtype=np.int32),
            data=data,
            shape=tuple(m.shape),
        )

    @staticmethod
    def from_edges(
        edges: np.ndarray, n_rows: int, n_cols: Optional[int] = None
    ) -> "CSR":
        """Build from an (E, 2) array of (src, dst) pairs; values implicit 1.

        Duplicate edges are kept (parity with the reference's adjacency
        lists, /root/reference/utility.cc:31-45 convertGraphToCSR, which
        does not dedupe).
        """
        if n_cols is None:
            n_cols = n_rows
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        order = np.argsort(edges[:, 0] * n_cols + edges[:, 1], kind="stable")
        edges = edges[order]
        counts = np.bincount(edges[:, 0], minlength=n_rows)
        indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSR(
            indptr=indptr,
            indices=edges[:, 1].astype(np.int32),
            data=None,
            shape=(n_rows, n_cols),
        )

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        data: Optional[np.ndarray],
        shape: Tuple[int, int],
    ) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        # single fused sort key is ~1.6x faster than lexsort at 10^7+ nnz
        # (stable kind keeps duplicate coordinates in input order)
        order = np.argsort(rows * shape[1] + cols, kind="stable")
        rows, cols = rows[order], cols[order]
        if data is not None:
            data = np.asarray(data, dtype=np.float32)[order]
        counts = np.bincount(rows, minlength=shape[0])
        indptr = np.zeros(shape[0] + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSR(indptr=indptr, indices=cols.astype(np.int32), data=data, shape=shape)

    # -- views -------------------------------------------------------------

    def row_ids(self) -> np.ndarray:
        """COO row index vector (nnz,): the segment ids for segment-sum SpMM."""
        indptr = np.asarray(self.indptr)
        return np.repeat(
            np.arange(self.n_rows, dtype=np.int32), np.diff(indptr)
        )

    def values(self) -> np.ndarray:
        if self.data is None:
            return np.ones(self.nnz, dtype=np.float32)
        return np.asarray(self.data)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.values(), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray().astype(np.float32)

    def device_put(self, sharding=None) -> "CSR":
        put = lambda x: jax.device_put(x, sharding) if sharding else jnp.asarray(x)
        return CSR(
            indptr=put(np.asarray(self.indptr)),
            indices=put(np.asarray(self.indices)),
            data=None if self.data is None else put(np.asarray(self.data)),
            shape=self.shape,
        )

    def transpose(self) -> "CSR":
        """A^T as CSR (host): row/col swap through the COO view."""
        return CSR.from_coo(
            np.asarray(self.indices, dtype=np.int64),
            self.row_ids().astype(np.int64),
            None if self.data is None else np.asarray(self.data),
            (self.shape[1], self.shape[0]),
        )

    def degrees(self) -> np.ndarray:
        return np.diff(np.asarray(self.indptr)).astype(np.int64)


def random_csr(
    p: float,
    n_rows: int,
    n_cols: Optional[int] = None,
    seed: int = 1234,
    values: str = "uniform",
) -> CSR:
    """Bernoulli(p) random CSR, seeded — the analog of randomCSRMatrix
    (/root/reference/load_data.cc:42-69), which draws per-row binomial nnz
    counts and uniform column ids.

    values: 'uniform' -> U[0,1) data; 'ones' -> implicit 1.0 (data=None).
    """
    if n_cols is None:
        n_cols = n_rows
    rng = np.random.default_rng(seed)
    # Per-row nnz ~ Binomial(n_cols, p); columns sampled without replacement
    # would be O(n^2) for large rows — with replacement then dedupe matches
    # the spirit (collisions negligible at the densities swept).
    row_nnz = rng.binomial(n_cols, p, size=n_rows)
    nnz = int(row_nnz.sum())
    cols = rng.integers(0, n_cols, size=nnz, dtype=np.int64)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
    # dedupe (row, col) pairs
    key = rows * n_cols + cols
    key = np.unique(key)
    rows, cols = key // n_cols, key % n_cols
    data = (
        rng.random(rows.shape[0], dtype=np.float32) if values == "uniform" else None
    )
    return CSR.from_coo(rows, cols, data, (n_rows, n_cols))
