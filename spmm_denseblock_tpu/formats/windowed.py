"""Windowed dense-tile format: the dense-tile payoff of reordering.

Reordering (RCM/Rabbit/Gorder) concentrates each row's nonzeros into a
narrow column band. This format exploits that directly: rows are tiled
in groups of R; each row-tile picks its K best W-aligned column windows
and stores the submatrix restricted to (tile, window) as a DENSE
(R, W) tile per window; everything else falls into a remainder CSR.
SpMM then becomes

    C[tile] = sum_k tiles[t, k] @ B[window_{t,k}]   (batched dense
              matmuls, contiguous window loads — no scattered gathers)
  + remainder CSR segment-sum (the long tail)

This is the rectangular-supertile generalization of the reference's
square-block hybrid (divide.cu:52-127): where divide keeps b x b blocks
above a density threshold, windowed keeps R x W row-band tiles — a
shape matrix units and streaming memory reads want. Zero-fill FLOPs are
the price; the matrix units have FLOPs to burn while the CSR gather path
is latency-bound.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Windowed:
    """tiles: (T, K, R, W) dense row-band tiles; win_idx[t, k] = which
    W-aligned column window tile (t, k) multiplies; remainder: CSR of all
    nonzeros not captured. Row-tile t covers rows [t*R, (t+1)*R)."""

    tiles: jax.Array  # (T, K, R, W)
    win_idx: jax.Array  # (T, K) int32
    remainder: CSR
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    tile_rows: int = dataclasses.field(metadata=dict(static=True))
    window: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_windows_per_tile(self) -> int:
        return int(self.tiles.shape[1])

    def captured_nnz(self) -> int:
        return int(np.count_nonzero(np.asarray(self.tiles)))

    def to_dense(self) -> np.ndarray:
        R, W = self.tile_rows, self.window
        n_rows, n_cols = self.shape
        out = np.zeros((self.n_tiles * R, -(-n_cols // W) * W), np.float32)
        tiles = np.asarray(self.tiles, dtype=np.float32)
        wins = np.asarray(self.win_idx)
        for t in range(self.n_tiles):
            for k in range(self.n_windows_per_tile):
                c0 = int(wins[t, k]) * W
                out[t * R : (t + 1) * R, c0 : c0 + W] += tiles[t, k]
        return out[:n_rows, :n_cols] + self.remainder.to_dense()


def divide_windowed(
    csr: CSR,
    tile_rows: int = 256,
    window: int = 1024,
    min_fill: float = 0.0,
    n_windows: int = 1,
) -> Windowed:
    """Split into windowed dense tiles + remainder.

    Each row-tile keeps its `n_windows` W-aligned column blocks holding
    the MOST nonzeros (count ties -> lower window id; rank ties within a
    tile keep window-id order). A (tile, window) pair whose captured-nnz
    fraction of R*W falls below min_fill is dropped to the remainder
    (its tile slot stays all-zero at window 0)."""
    R, W, K = tile_rows, window, n_windows
    n_rows, n_cols = csr.shape
    T = -(-n_rows // R)
    n_win = -(-n_cols // W)
    K = min(K, n_win)

    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = csr.values()

    tile_of = rows // R
    win_of = cols // W
    pair = tile_of * n_win + win_of
    counts = np.bincount(pair, minlength=T * n_win).reshape(T, n_win)

    # top-K windows per tile (count desc, window id asc on ties)
    order = np.argsort(-counts, axis=1, kind="stable")
    top = order[:, :K]  # (T, K) window ids
    top_counts = np.take_along_axis(counts, top, axis=1)
    keep = top_counts >= max(min_fill * R * W, 1)  # empty windows dropped

    # slot lookup: slot_of[t, w] = k if window w is tile t's k-th slot
    slot_of = np.full((T, n_win), -1, dtype=np.int64)
    t_ids = np.repeat(np.arange(T), K)
    slot_of[t_ids, top.ravel()] = np.where(
        keep.ravel(), np.tile(np.arange(K), T), -1
    )

    slot = slot_of[tile_of, win_of]  # (nnz,) in [-1, K)
    sel = slot >= 0
    tiles = np.zeros((T, K, R, W), dtype=np.float32)
    np.add.at(
        tiles,
        (tile_of[sel], slot[sel], rows[sel] % R, cols[sel] % W),
        vals[sel],
    )
    win_idx = np.where(keep, top, 0).astype(np.int32)
    remainder = CSR.from_coo(rows[~sel], cols[~sel], vals[~sel], csr.shape)
    return Windowed(
        tiles=tiles,
        win_idx=win_idx,
        remainder=remainder,
        shape=csr.shape,
        tile_rows=R,
        window=W,
    )
