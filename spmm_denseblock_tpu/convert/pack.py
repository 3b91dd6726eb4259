"""Layout packing helpers: small-b BSR -> large-tile BSR, padding utilities.

Rationale (SURVEY.md §7 "Small blocks on a large matrix unit"): blocks
of b in {2..32} — the reference's sweep range
(/root/reference/benchmark.py:4-8) — underfill a matrix unit. We repack
B/b x B/b grids of small blocks into one B x B supertile (nonzero if any
constituent is), the analog of the reference's WF_SIZE dispatch on
blockDim (/root/reference/rocsparse_bsrmm.h:192-252). The Pallas kernel
needs b >= 16 (ops/bsr_spmm_pallas.kernel_layout).
"""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu.formats.bsr import BSR


def repack_bsr(bsr: BSR, new_block_size: int) -> BSR:
    """Re-block a BSR matrix to a different (usually larger, tile-aligned)
    block size. Exact: the dense matrix represented is unchanged."""
    b, nb = bsr.b, new_block_size
    if nb == b:
        return bsr
    if nb % b != 0:
        raise ValueError(f"new block size {nb} must be a multiple of {b}")
    g = nb // b
    nnzb = bsr.nnzb
    brows = np.asarray(bsr.block_rows[:nnzb], dtype=np.int64)
    bcols = np.asarray(bsr.block_cols[:nnzb], dtype=np.int64)
    blocks = np.asarray(bsr.blocks[:nnzb], dtype=np.float32)

    n_new_bc = -(-bsr.n_block_cols // g)
    srow, scol = brows // g, bcols // g
    skey = srow * n_new_bc + scol
    uniq, inv = np.unique(skey, return_inverse=True)
    out = np.zeros((uniq.shape[0], nb, nb), dtype=np.float32)
    ro = (brows % g) * b
    co = (bcols % g) * b
    for k in range(nnzb):
        out[inv[k], ro[k] : ro[k] + b, co[k] : co[k] + b] += blocks[k]
    return BSR.from_parts(
        (uniq // n_new_bc).astype(np.int32),
        (uniq % n_new_bc).astype(np.int32),
        out,
        bsr.shape,
        nb,
    )


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pad_dense_rows(x: np.ndarray, n_rows: int) -> np.ndarray:
    """Zero-pad the leading dim of a dense operand up to n_rows (block-grid
    coverage for the Pallas kernel's gathered B tiles)."""
    if x.shape[0] == n_rows:
        return x
    pad = [(0, n_rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad)
