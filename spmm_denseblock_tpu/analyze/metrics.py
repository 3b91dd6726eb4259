"""Block-structure analytics (vectorized numpy).

Reference parity:
- calculate_nnzb            <- calculateNnzb, /root/reference/utility.cc:47-69
- block_metrics             <- analyzeBlockSparseMetrics,
                               /root/reference/reorder_graph.cc:12-24
  (density = nnzb/nb^2, utilization = nnz/(nnzb*b^2), average = nnz/nnzb)
- fill_histogram            <- calculate_block_density_dist,
                               /root/reference/block_density_dist.cpp:47-86
  (10-bucket per-block occupancy distribution)
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR

DEFAULT_BLOCK_SIZES = (2, 4, 8, 16, 32, 64, 128, 256)
# the reference sweeps {2..64} (reorder_graph.cc:14); 128/256 added because
# those are the matrix-unit tile sizes the BSR kernels run at.


def _block_keys(csr: CSR, b: int) -> np.ndarray:
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    nbc = -(-csr.shape[1] // b)
    return (rows // b) * nbc + cols // b


def calculate_nnzb(csr: CSR, block_size: int) -> int:
    return int(np.unique(_block_keys(csr, block_size)).shape[0])


def block_metrics(
    csr: CSR, block_sizes: Sequence[int] = DEFAULT_BLOCK_SIZES
) -> Dict[int, Dict[str, float]]:
    out: Dict[int, Dict[str, float]] = {}
    nnz = csr.nnz
    for b in block_sizes:
        nbr = -(-csr.shape[0] // b)
        nbc = -(-csr.shape[1] // b)
        nnzb = calculate_nnzb(csr, b)
        out[b] = dict(
            nnzb=float(nnzb),
            density=nnzb / (nbr * nbc),
            utilization=nnz / (nnzb * b * b) if nnzb else 0.0,
            average=nnz / nnzb if nnzb else 0.0,
        )
    return out


def fill_histogram(csr: CSR, block_size: int, n_buckets: int = 10) -> np.ndarray:
    """Bucket k counts blocks with occupancy in (k/n, (k+1)/n]; occupancy
    exactly 0 never appears (only nonzero blocks exist)."""
    _, counts = np.unique(_block_keys(csr, block_size), return_counts=True)
    occ = counts.astype(np.float64) / (block_size * block_size)
    buckets = np.minimum((np.ceil(occ * n_buckets) - 1).astype(np.int64), n_buckets - 1)
    buckets = np.maximum(buckets, 0)
    return np.bincount(buckets, minlength=n_buckets)


# ELL gather-rate brackets (fit from before the H100 port, not yet re-measured on the H100):
# the ELL tier's cost is per-index-bound and cliffs with operand-table
# size. These bracket an estimate, they are not an interpolation model.
ELL_NS_PER_SLOT_SMALL_TABLE = 2.6
ELL_NS_PER_SLOT_BIG_TABLE = 11.5


def ell_metrics(
    csr: CSR, bucket: str = "quarter", feat_dim: int = 128,
    itemsize: int = 4, compact_model: bool = False,
) -> Dict[str, float]:
    """Gather-era counterpart of block_metrics: what the degree-bucketed
    ELL tier (ops/csr_spmm_ell.py) will build for this matrix — padded
    slot count (the quantity the gather runtime tracks), padding
    waste, class/chunk counts, and bracket time estimates at the two
    FIXED per-slot rates (small-table / big-table endpoints — not
    interpolated; fitted before the H100 port). `feat_dim`/`itemsize` only size the returned
    table_bytes, which picks the endpoint that applies."""
    from spmm_denseblock_tpu.ops.csr_spmm_ell import CHUNK_SLOTS, _row_widths

    deg = csr.degrees().astype(np.int64)
    K = _row_widths(deg, bucket)  # every row gets >=1 slot (pads incl.)
    slots = int(K.sum())
    classes, counts = np.unique(K, return_counts=True)
    n_chunks = int(
        sum(
            -(-int(m) // max(1, CHUNK_SLOTS // int(k)))
            for k, m in zip(classes, counts)
        )
    )
    table_bytes = int(csr.n_cols) * feat_dim * itemsize
    out = {
        "slots": slots,
        "padded_ratio": slots / max(csr.nnz, 1),
        "n_classes": int(classes.size),
        "n_chunks": n_chunks,
        "table_bytes": table_bytes,
        "est_ms_small_table_rate": slots * ELL_NS_PER_SLOT_SMALL_TABLE / 1e6,
        "est_ms_big_table_rate": slots * ELL_NS_PER_SLOT_BIG_TABLE / 1e6,
    }
    if compact_model:
        # opt-in: costs an O(nnz) unique-count pass (minutes at
        # products scale), vs the O(n) degree-only fields above
        out.update(ell_compact_metrics(csr, bucket, feat_dim, itemsize))
    return out


def ell_compact_metrics(
    csr: CSR, bucket: str = "quarter", feat_dim: int = 128,
    itemsize: int = 4,
) -> Dict[str, float]:
    """Two-level (unique-compacted) gather prediction for the ELL tier
    (ops/csr_spmm_ell.py compact="auto"): per candidate span of
    COMPACT_SLOTS, the unique-neighbor count U against its slot count S
    feeds the byte-based rate model — the same decision the layout
    builder makes. Returns the modeled flat vs two-level times and the
    aggregate U/S (a locality figure of the ordering: lower = rows
    inside degree classes share more neighbors)."""
    from spmm_denseblock_tpu.ops.csr_spmm_ell import (
        CHUNK_SLOTS,
        COMPACT_SLOTS,
        _COMPACT_MIN_GAIN,
        _gather_ns_per_slot,
        _row_widths,
    )
    from spmm_denseblock_tpu.reorder.simple import _ragged_arange
    from spmm_denseblock_tpu import native

    deg = csr.degrees().astype(np.int64)
    K_r = _row_widths(deg, bucket)
    order = np.argsort(K_r, kind="stable")
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    table_bytes = int(csr.n_cols) * feat_dim * itemsize
    r_big = _gather_ns_per_slot(table_bytes, itemsize)
    flat_ns = two_ns = 0.0
    sum_u = sum_s = 0
    n_compacted = 0
    for K in np.unique(K_r[order]):
        rows_k = order[K_r[order] == K]
        d = indptr[rows_k + 1] - indptr[rows_k]
        src = np.repeat(indptr[rows_k], d) + _ragged_arange(d)
        idx = cols[src]
        # per-span unique counts on the UNPADDED stream: pad slots all
        # repeat one id, so they change U by at most 1 (added below).
        # Span size mirrors _compact_spans (COMPACT_SLOTS capped at the
        # CHUNK_SLOTS HBM guard), as does the _COMPACT_MIN_GAIN gate.
        tgt_m = max(1, min(COMPACT_SLOTS, CHUNK_SLOTS) // int(K))
        off = np.concatenate([[0], np.cumsum(d)])
        for s in range(0, rows_k.size, tgt_m):
            m = min(tgt_m, rows_k.size - s)
            S = m * int(K)
            seg = idx[off[s]: off[s + m]]
            res = native.unique_inverse(seg, int(csr.n_cols))
            nu = res[0].size if res is not None else np.unique(seg).size
            U = int(nu) + 1  # + pad id
            r_sub = _gather_ns_per_slot(U * feat_dim * itemsize, itemsize)
            flat = S * r_big
            two = U * r_big + S * r_sub
            compacts = two <= _COMPACT_MIN_GAIN * flat
            flat_ns += flat
            two_ns += two if compacts else flat
            n_compacted += compacts
            sum_u += U
            sum_s += S
    return {
        "compact_u_over_s": round(sum_u / max(sum_s, 1), 4),
        "est_ms_flat": flat_ns / 1e6,
        "est_ms_two_level": two_ns / 1e6,
        "compact_spans": int(n_compacted),
    }


def bandwidth_profile(csr: CSR) -> Dict[str, float]:
    """Classic reordering-quality metrics: matrix bandwidth
    (max |i - j| over nonzeros) and envelope/profile (sum over rows of
    the span from the leftmost nonzero to the diagonal) — the quantities
    RCM-style orderings minimize; complements the block-level metrics."""
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    if rows.shape[0] == 0:
        return {"bandwidth": 0.0, "profile": 0.0, "avg_span": 0.0}
    diff = np.abs(rows - cols)
    bandwidth = float(diff.max())
    # per-row span: max(i - min_j, 0)
    n = csr.n_rows
    min_col = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(min_col, rows, cols)
    present = min_col != np.iinfo(np.int64).max
    span = np.where(
        present, np.maximum(np.arange(n) - min_col, 0), 0
    )
    return {
        "bandwidth": bandwidth,
        "profile": float(span.sum()),
        "avg_span": float(span.sum() / max(present.sum(), 1)),
    }
