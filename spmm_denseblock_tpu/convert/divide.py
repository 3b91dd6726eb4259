"""Hybrid dense-block / remainder-CSR splitter.

The vectorized-numpy re-design of divide_matrix
(/root/reference/divide.cu:52-127): per candidate block, occupancy =
count/b^2; blocks with occupancy >= density go to the BSR part, every
other nonzero stays in a leftover CSR. One pass over the COO view instead
of the reference's per-block-row counts/flags scan.
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.formats.bsr import BSR
from spmm_denseblock_tpu.formats.hybrid import Hybrid


def divide(csr: CSR, block_size: int, density: float) -> Hybrid:
    b = block_size
    n_rows, n_cols = csr.shape
    nbc = -(-n_cols // b)

    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = csr.values()

    bkey = (rows // b) * nbc + (cols // b)
    uniq, inv, counts = np.unique(bkey, return_inverse=True, return_counts=True)

    # occupancy threshold — matches the reference's ">= density" gate
    # (divide.cu:93). Note: counts can exceed b^2 only if the input has
    # duplicate coordinates; CSR.from_coo keeps duplicates like the
    # reference's adjacency lists do.
    dense_mask_per_block = counts.astype(np.float64) / (b * b) >= density
    dense_mask = dense_mask_per_block[inv]

    # BSR part
    dense_keys = uniq[dense_mask_per_block]
    if dense_keys.shape[0] > 0:
        remap = np.searchsorted(dense_keys, bkey[dense_mask])
        blocks = np.zeros((dense_keys.shape[0], b, b), dtype=np.float32)
        np.add.at(
            blocks,
            (remap, rows[dense_mask] % b, cols[dense_mask] % b),
            vals[dense_mask],
        )
        bsr = BSR.from_parts(
            (dense_keys // nbc).astype(np.int32),
            (dense_keys % nbc).astype(np.int32),
            blocks,
            csr.shape,
            b,
        )
    else:
        bsr = BSR.from_parts(
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros((0, b, b), np.float32),
            csr.shape,
            b,
        )

    # remainder CSR part
    rem = ~dense_mask
    remainder = CSR.from_coo(rows[rem], cols[rem], vals[rem], csr.shape)
    return Hybrid(dense=bsr, remainder=remainder, shape=csr.shape)


def auto_threshold(csr: CSR, block_size: int, dense_speedup: float = 4.0) -> float:
    """Analytics-driven density threshold for divide() — the L3->L4 link
    the reference leaves to the human (the divide.cu density argv came
    from eyeballing block_density_dist output).

    Model: routing a block through the dense path costs b^2 cell-ops on
    the matrix units but runs ~dense_speedup x faster per element than the
    gather-bound CSR path; a block with occupancy >= 1/dense_speedup is
    therefore cheaper dense. The returned threshold is that break-even
    clipped to the occupancy distribution actually present (10-bucket
    fill histogram), so a graph with no dense blocks yields a threshold
    that routes everything to CSR rather than creating a tiny BSR part.
    """
    import numpy as np

    from spmm_denseblock_tpu.analyze.metrics import fill_histogram

    breakeven = 1.0 / dense_speedup
    hist = fill_histogram(csr, block_size)
    # densest occupied bucket lower edge
    occupied = np.nonzero(hist)[0]
    if occupied.size == 0:
        return 1.0
    densest_edge = occupied[-1] / hist.shape[0]
    if densest_edge < breakeven:
        return 1.0  # nothing qualifies: pure CSR
    return float(breakeven)


def ell_padded_slots(degrees: np.ndarray, bucket: str = "quarter") -> int:
    """Total gather slots the degree-bucketed ELL tier issues for rows
    with these degrees: sum of per-row ELL widths (ops/csr_spmm_ell.py's
    class layout; `bucket` must match the plan that will execute the
    remainder). On the earlier target the remainder cost tracked this
    count (per-index-bound gather), not raw nnz or tile-amplified bytes;
    not yet re-measured on the H100."""
    from spmm_denseblock_tpu.ops.csr_spmm_ell import _row_widths

    deg = np.asarray(degrees, dtype=np.int64)
    K = _row_widths(deg, bucket)
    return int(K[deg > 0].sum())


def score_thresholds(
    csr: CSR,
    block_size: int,
    candidates=(0.02, 0.03, 0.05),
    slots_per_block: float = 400.0,
    dense_bytes_budget: int = 2 << 30,
    dtype_bytes: int = 4,
    margin: float = 0.02,
):
    """Cost-model threshold selection for divide().

    Cost model (a fit from before the H100 port, not yet re-measured on the H100): within one
    graph,
        t(thr) ~ c_blk * dense_nnzb(thr) + c_slot * ell_padded_slots(rem)
    — a dense block pays for itself iff it drains >= slots_per_block
    padded ELL slots from the remainder. The default of 400 ranked the
    earlier target's full-proteins sweep correctly. The marginal
    costs between adjacent thresholds are strongly nonlinear (high-K
    classes drain first), so this is a RANKING constant, not a
    physical one. Unlike the round-1 byte model it still knows that
    capturing HIGH-degree rows is worth far more than raw nnz says
    (draining a row past a class boundary shrinks its padding).

    One expensive pass (per-block nnz counts) is shared by all
    candidates; each candidate then costs one boolean mask + bincount.
    Returns (best_threshold_or_None, report). None means no candidate
    beat the pure-ELL score by more than `margin` (building a dense tier
    costs memory and plan time; a sub-noise win is not worth it), or
    every qualifying dense part exceeded `dense_bytes_budget`.
    """
    b = block_size
    n_rows, n_cols = csr.shape
    nbc = -(-n_cols // b)
    rows = csr.row_ids().astype(np.int64)
    bkey = (rows // b) * nbc + (np.asarray(csr.indices, np.int64) // b)
    uniq, inv, counts = np.unique(bkey, return_inverse=True, return_counts=True)
    occupancy = counts.astype(np.float64) / (b * b)
    block_bytes = b * b * dtype_bytes

    report = []
    best_thr, best_score = None, float("inf")
    # None (= pure ELL) goes first so score ties resolve to NO dense
    # part rather than an empty hybrid
    for thr in [None] + sorted(set(candidates)):
        if thr is None:
            dense_mask_blk = np.zeros(uniq.shape[0], dtype=bool)
        else:
            dense_mask_blk = occupancy >= thr
        nnzb = int(dense_mask_blk.sum())
        if nnzb * block_bytes > dense_bytes_budget:
            report.append({"thr": thr, "nnzb": nnzb, "score": None,
                           "reason": "over dense-bytes budget"})
            continue
        rem_rows = rows[~dense_mask_blk[inv]]
        rem_deg = np.bincount(rem_rows, minlength=n_rows)
        slots = ell_padded_slots(rem_deg)
        score = slots_per_block * nnzb + slots
        report.append({"thr": thr, "nnzb": nnzb, "padded_slots": slots,
                       "score": float(score)})
        if score < best_score:
            best_thr, best_score = thr, score
        if thr is None:
            ell_score = score
    if best_thr is not None and best_score > ell_score * (1.0 - margin):
        best_thr = None
    return best_thr, report
