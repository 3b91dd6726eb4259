"""Host-side sharding of sparse formats across a device mesh.

The sparse matrix A is partitioned by contiguous **block-row stripes**:
shard s owns block-rows [s*rows_per, (s+1)*rows_per). Each shard's block
list is padded to a common nnzb so the stacked arrays have static shapes
(the multi-device analog of BSR.pad_to). Padding blocks are all-zero and
point at the shard's last local block-row, so they contribute nothing.

The reference has no distributed layer; the per-shard nnz imbalance this
padding absorbs is the distributed analog of the per-warp nnz imbalance
the reference's kernels fight (/root/reference/gespmm_csrmm.h:96-166) —
reordered graphs cluster nonzeros deliberately, so stripes are uneven.
`shard_stats` reports the imbalance so benchmarks can quantify it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from spmm_denseblock_tpu.formats.bsr import BSR
from spmm_denseblock_tpu.formats.csr import CSR


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ShardedBSR:
    """Stacked per-shard flat-BSR arrays (host numpy until device_put).

    local_rows : (n_shards, m) int32 — block-row ids local to the stripe
    block_cols : (n_shards, m) int32 — GLOBAL block-col ids (into the
                 column space padded to n_shards * col_chunk blocks)
    blocks     : (n_shards, m, b, b)
    """

    local_rows: np.ndarray
    block_cols: np.ndarray
    blocks: np.ndarray
    shape: Tuple[int, int]  # logical dense shape of A
    block_size: int
    rows_per_shard: int  # block-rows per stripe
    col_chunk: int  # block-cols per ring chunk (= per-shard B stripe)
    nnzb: int  # real (unpadded) total
    nnzb_per_shard: np.ndarray = None  # (n_shards,) real block counts
    # optional variable contiguous stripe boundaries (n_shards+1,) in
    # block-row units; None = uniform stripes of rows_per_shard. When
    # set, local ids are relative to boundaries[s] and every stripe is
    # PADDED to rows_per_shard (= max stripe height) so shard_map's
    # one-program rule holds; B must be laid out with the matching
    # padded-stripe view (see parallel/spmm._halo_run).
    boundaries: np.ndarray = None

    @property
    def n_shards(self) -> int:
        return int(self.local_rows.shape[0])

    @property
    def b(self) -> int:
        return self.block_size


def balanced_contiguous_boundaries(bsr: BSR, n_shards: int) -> np.ndarray:
    """Contiguous stripe boundaries with near-equal nnzb per stripe
    (prefix-sum split at load quantiles). Unlike LPT block-row
    permutation, this preserves row ORDER — a banded (reordered) matrix
    stays banded, so halo's O(1)-comms eligibility survives balancing.
    Returns (n_shards+1,) block-row splits with boundaries[0]=0,
    boundaries[-1]=n_block_rows."""
    nbr = bsr.n_block_rows
    counts = np.bincount(
        np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr
    ).astype(np.int64)
    csum = np.cumsum(counts)
    total = int(csum[-1])
    targets = total * np.arange(1, n_shards) / n_shards
    cuts = np.searchsorted(csum, targets, side="left") + 1
    bounds = np.concatenate([[0], cuts, [nbr]]).astype(np.int64)
    # enforce strictly increasing (degenerate loads can collapse cuts)
    for i in range(1, n_shards + 1):
        lo = bounds[i - 1] + 1 if i < n_shards else bounds[i - 1]
        hi = nbr - (n_shards - i) if i < n_shards else nbr
        bounds[i] = min(max(bounds[i], lo), hi)
    return bounds


def block_index_payload(nnzb: int) -> np.ndarray:
    """(nnzb, 1, 1) int64 stand-in for a block-value array: entry i
    holds i+1 (0 = zero block). Every layout stage (shard_bsr /
    bucket_by_col_chunk / bucket_halo) only permutes blocks, pads with
    np.zeros, and detects padding via abs().sum() != 0 — all of which
    hold for this payload — so the whole shard->bucket pipeline can run
    on 8-byte tokens instead of b*b*4-byte blocks, and the real values
    are materialized ONCE at the end (materialize_packed)."""
    return (np.arange(nnzb, dtype=np.int64) + 1).reshape(-1, 1, 1)


def materialize_packed(idx_payload, blocks) -> np.ndarray:
    """Expand an index payload that rode through the pack pipeline into
    real block values with one zero-init + one gather. idx_payload:
    (..., 1, 1) int64 from block_index_payload; blocks: (nnzb, b, b)."""
    idx = np.asarray(idx_payload)[..., 0, 0]
    blocks = np.asarray(blocks)
    b = blocks.shape[-1]
    out = np.zeros(idx.shape + (b, b), blocks.dtype)
    nz = idx > 0
    out[nz] = blocks[idx[nz] - 1]
    return out


def shard_bsr(
    bsr: BSR, n_shards: int, boundaries=None, payload=None
) -> ShardedBSR:
    """Partition into `n_shards` contiguous block-row stripes, pad each
    stripe's block list to the max stripe nnzb. boundaries=None gives
    uniform stripes; an (n_shards+1,) array gives variable contiguous
    stripes (balanced_contiguous_boundaries), each padded to the max
    stripe height.

    payload: optional (nnzb, pb, pb) array to shard IN PLACE OF the
    block values (block_index_payload for the fast metadata-only plan
    path); the returned ShardedBSR.blocks then carries the payload and
    block_size still reports the true b for geometry."""
    b = bsr.b
    nbr = bsr.n_block_rows
    if boundaries is None:
        rows_per = _cdiv(nbr, n_shards)
        col_chunk = _cdiv(bsr.n_block_cols, n_shards)
    else:
        boundaries = np.asarray(boundaries, dtype=np.int64)
        assert boundaries.shape == (n_shards + 1,)
        rows_per = int(np.diff(boundaries).max())
        col_chunk = rows_per  # square padded chunks (halo-only layout)

    rows = np.asarray(bsr.block_rows[: bsr.nnzb])
    cols = np.asarray(bsr.block_cols[: bsr.nnzb])
    blocks = (
        np.asarray(bsr.blocks[: bsr.nnzb]) if payload is None
        else np.asarray(payload)
    )
    pb = blocks.shape[-1]  # payload block dim (== b unless index mode)

    if boundaries is None:
        owner = rows // rows_per
        base = None
    else:
        owner = np.searchsorted(boundaries, rows, side="right") - 1
        base = boundaries
    real_counts = np.bincount(owner, minlength=n_shards)

    # stripes sorted by local row (segment_sum's indices_are_sorted
    # contract).
    shard_lists = []
    for s in range(n_shards):
        sel = owner == s
        s_base = s * rows_per if base is None else int(base[s])
        slr = (rows[sel] - s_base).astype(np.int64)
        sbc = cols[sel].astype(np.int64)
        sbv = blocks[sel]
        order = np.argsort(slr, kind="stable")
        shard_lists.append((slr[order], sbc[order], sbv[order]))

    m = max(max(x[0].shape[0] for x in shard_lists), 1)
    lr = np.full((n_shards, m), rows_per - 1, dtype=np.int32)
    bc = np.zeros((n_shards, m), dtype=np.int32)
    bv = np.zeros((n_shards, m, pb, pb), dtype=np.asarray(blocks).dtype)
    for s, (slr, sbc, sbv) in enumerate(shard_lists):
        k = slr.shape[0]
        lr[s, :k] = slr
        bc[s, :k] = sbc
        bv[s, :k] = sbv
    return ShardedBSR(
        local_rows=lr,
        block_cols=bc,
        blocks=bv,
        shape=bsr.shape,
        block_size=b,
        rows_per_shard=rows_per,
        col_chunk=col_chunk,
        nnzb=bsr.nnzb,
        nnzb_per_shard=real_counts,
        boundaries=base,
    )


def bucket_by_col_chunk(sh: ShardedBSR) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Re-bucket each shard's blocks by which ring chunk their block-col
    falls in, for the ppermute-ring schedule (parallel/spmm.py).

    Returns (local_rows, chunk_cols, blocks) with shape
    (n_shards, n_chunks, mb, ...); chunk_cols are block-col ids LOCAL to
    the chunk. Padding entries are zero blocks at (last local row, col 0).
    """
    n, cpc, rows_per = sh.n_shards, sh.col_chunk, sh.rows_per_shard
    b = sh.blocks.shape[-1]  # payload dim (== sh.b unless index mode)
    chunk_of = np.asarray(sh.block_cols) // cpc  # (n, m)

    # count real blocks per (shard, chunk): padding entries in sh are zero
    # blocks, harmless to include in whatever bucket they land in (chunk 0).
    mb = 1
    per = np.zeros((n, n), dtype=np.int64)
    for s in range(n):
        per[s] = np.bincount(chunk_of[s], minlength=n)[:n]
    mb = max(int(per.max(initial=0)), 1)

    lr = np.full((n, n, mb), rows_per - 1, dtype=np.int32)
    cc = np.zeros((n, n, mb), dtype=np.int32)
    bv = np.zeros((n, n, mb, b, b), dtype=sh.blocks.dtype)
    for s in range(n):
        for c in range(n):
            sel = chunk_of[s] == c
            k = int(per[s, c])
            if k:
                rows_sc = sh.local_rows[s, sel]
                order = np.argsort(rows_sc, kind="stable")
                lr[s, c, :k] = rows_sc[order]
                cc[s, c, :k] = (sh.block_cols[s, sel] - c * cpc)[order]
                bv[s, c, :k] = sh.blocks[s, sel][order]
    return lr, cc, bv


def shard_stats(sh: ShardedBSR) -> dict:
    """Per-shard load-balance diagnostics (nnzb-weighted)."""
    per = np.asarray(sh.nnzb_per_shard)
    mean = float(per.mean())
    return {
        "nnzb_per_shard": per.tolist(),
        "imbalance": float(per.max() / mean) if mean else 1.0,
        "padded_m": int(sh.local_rows.shape[1]),
    }


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Stacked per-shard COO-view arrays for row-partitioned CSR SpMM.

    local_rows : (n_shards, m) int32 — row ids local to the stripe
    col_ids    : (n_shards, m) int32 — global column ids
    vals       : (n_shards, m) float32 (padding entries are 0.0)
    """

    local_rows: np.ndarray
    col_ids: np.ndarray
    vals: np.ndarray
    shape: Tuple[int, int]
    rows_per_shard: int
    nnz: int

    @property
    def n_shards(self) -> int:
        return int(self.local_rows.shape[0])


def shard_csr(csr: CSR, n_shards: int) -> ShardedCSR:
    rows_per = _cdiv(csr.n_rows, n_shards)
    rows = csr.row_ids()
    cols = np.asarray(csr.indices)
    vals = csr.values()
    owner = rows // rows_per
    counts = np.bincount(owner, minlength=n_shards)
    m = max(int(counts.max(initial=0)), 1)
    lr = np.full((n_shards, m), rows_per - 1, dtype=np.int32)
    ci = np.zeros((n_shards, m), dtype=np.int32)
    va = np.zeros((n_shards, m), dtype=np.float32)
    for s in range(n_shards):
        sel = owner == s
        k = int(counts[s])
        if k:
            lr[s, :k] = rows[sel] - s * rows_per
            ci[s, :k] = cols[sel]
            va[s, :k] = vals[sel]
    return ShardedCSR(
        local_rows=lr,
        col_ids=ci,
        vals=va,
        shape=csr.shape,
        rows_per_shard=rows_per,
        nnz=csr.nnz,
    )


def bucket_halo(sh: ShardedBSR, halo: int = 1):
    """Bucket each shard's blocks by NEIGHBOR chunk offset in
    [-halo, +halo] (mod n_shards) for the halo-exchange schedule.

    Returns (local_rows, chunk_cols, blocks) with shape
    (n_shards, 2*halo+1, mb, ...) — offset index h corresponds to chunk
    (s + h - halo) mod n — or None if any block's column falls outside
    its shard's halo (caller falls back to allgather/ring)."""
    n, cpc, rows_per = sh.n_shards, sh.col_chunk, sh.rows_per_shard
    b = sh.blocks.shape[-1]  # payload dim (== sh.b unless index mode)
    width = 2 * halo + 1
    if width >= n:
        return None  # halo covers everything; use allgather
    if sh.boundaries is None:
        chunk_of = np.asarray(sh.block_cols) // cpc  # (n, m)
        col_local = np.asarray(sh.block_cols) % cpc
    else:
        # variable contiguous stripes: B chunk s covers block-cols
        # [boundaries[s], boundaries[s+1]) padded to rows_per (square
        # matrices only — the adjacency case halo serves)
        bounds = np.asarray(sh.boundaries)
        chunk_of = (
            np.searchsorted(bounds, np.asarray(sh.block_cols), side="right")
            - 1
        )
        col_local = np.asarray(sh.block_cols) - bounds[chunk_of]
    shard_ids = np.arange(n)[:, None]
    offset = (chunk_of - shard_ids + halo) % n  # (n, m) in [0, n)
    # padding entries are zero blocks at col 0 -> chunk 0; their offset
    # may be out of halo for far shards, but they are all-zero, so remap
    # them to the center slot instead of failing the halo check.
    pad_mask = np.abs(sh.blocks).sum(axis=(-1, -2)) == 0
    offset = np.where(pad_mask, halo, offset)
    col_local = np.where(pad_mask, 0, col_local)
    if (offset >= width).any():
        return None
    per = np.zeros((n, width), dtype=np.int64)
    for s in range(n):
        per[s] = np.bincount(offset[s], minlength=width)[:width]
    mb = max(int(per.max(initial=0)), 1)
    lr = np.full((n, width, mb), rows_per - 1, dtype=np.int32)
    cc = np.zeros((n, width, mb), dtype=np.int32)
    bv = np.zeros((n, width, mb, b, b), dtype=sh.blocks.dtype)
    for s in range(n):
        for h in range(width):
            sel = offset[s] == h
            k = int(per[s, h])
            if k:
                rows_sh = sh.local_rows[s, sel]
                order = np.argsort(rows_sh, kind="stable")
                lr[s, h, :k] = rows_sh[order]
                cc[s, h, :k] = col_local[s, sel][order]
                bv[s, h, :k] = sh.blocks[s, sel][order]
    return lr, cc, bv
