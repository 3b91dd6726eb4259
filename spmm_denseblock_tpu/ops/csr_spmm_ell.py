"""CSR SpMM via degree-bucketed ELL padding — scatter-free reduction.

In gather + segment_sum the SCATTER can be the bottleneck: XLA may
serialize segment accumulation. The reference's GE-SpMM kernels dodge
it with warp-private accumulators (/root/reference/gespmm_csrmm.h:96-166
— one output row per warp, so no cross-thread reduction). The XLA-native
equivalent of "one accumulator per row" is to make every row's nonzeros
a FIXED-length contiguous segment:

- Bucket rows by degree class K = next_pow2(degree) (classes 1,2,4,...).
  Padding waste is < 2x by construction.
- Per class: gather indices (m_k * K,) point at B rows, pads at a zero
  row appended to B (adjacency case) or carry val 0 (valued case).
- The reduce is `G.reshape(m_k, K, F).sum(axis=1)` — a dense axis
  reduction XLA vectorizes and fuses with the gather; no scatter-add,
  no sorted-segment machinery.
- Outputs come out in degree-sorted row order; one row-gather with the
  inverse position map restores the caller's order.

This stays a *plan*: all layout work happens host-side once; the hot
call is gathers + reshaped sums + one permutation gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.ops.plan import Plan, grad_plan

# gather-intermediate budget: slots * F * 4 bytes; 4M slots keeps the
# biggest per-chunk intermediate ~2 GB f32 / 1 GB bf16 at F=128 (the
# GNN regime) while holding the chunk count low enough for the
# compiler at products scale (~37 chunks at 147M slots). A
# full-products hybrid run ran out of device memory at 8M slots once a
# 2 GB dense-block tier shared it with the chunk + table + outputs; chunk
# launches are noise next to the per-index gather cost, so smaller is
# safe. Lower further for F >= 512 full-graph serving.
CHUNK_SLOTS = 4 << 20

# -- two-level (unique-compacted) gather model --------------------------------
# The per-index gather cost cliffs with the gather SOURCE's byte size:
# a fast rate on cache-friendly tables (<= 96 MB), a mid-cliff rate
# (<= 176 MB), and a big-table plateau. The rates below are a fit from before the H100 port,
# not yet re-measured on the H100 (whose 50 MB L2 moves the cliffs). A
# chunk whose rows share most neighbors can therefore gather its U
# unique operand rows ONCE at the big-table rate into a compact
# sub-table and read its S slots from that at the fast rate:
#     U * r_big + S * r_small(U*F*itemsize)   vs   S * r_big.
# Rabbit/rcmk keep community-adjacent rows adjacent inside each degree
# class, so U/S sits at 0.3-0.4 for ~1M-slot spans on full
# ogbn-products.
GATHER_FAST_TABLE_BYTES = 96 << 20
GATHER_MID_TABLE_BYTES = 176 << 20
GATHER_NS_MID_TABLE = 4.25
COMPACT_SLOTS = 1 << 20  # candidate span when compact != "off"
_COMPACT_MIN_GAIN = 0.9  # modeled two-level cost must be <= 90% of flat


def _gather_ns_per_slot(table_bytes: int, itemsize: int) -> float:
    from spmm_denseblock_tpu.analyze.metrics import (
        ELL_NS_PER_SLOT_BIG_TABLE,
        ELL_NS_PER_SLOT_SMALL_TABLE,
    )

    if table_bytes <= GATHER_FAST_TABLE_BYTES:
        return ELL_NS_PER_SLOT_SMALL_TABLE
    if table_bytes <= GATHER_MID_TABLE_BYTES:
        return GATHER_NS_MID_TABLE
    # the big-table plateau is itself dtype-sensitive; the 2-byte
    # figure is the conservative one (fit from before the H100 port)
    return ELL_NS_PER_SLOT_BIG_TABLE if itemsize >= 4 else 8.4


def _compact_spans(idx, m_k, K, max_m, compact, compact_slots, feat_dim,
                   itemsize, r_big, n_vals):
    """Split a degree class's m_k rows into chunk spans. Returns a list
    of (row_start, n_rows, uniq_or_None): uniq != None marks a span the
    host cost model (or compact="force") chose to two-level gather.
    Rejected candidate spans are merged back into plain CHUNK_SLOTS
    chunks so the op count does not grow where compaction buys nothing."""

    def plain(s0, m0):
        return [(s0 + o, min(max_m, m0 - o), None, None)
                for o in range(0, m0, max_m)]

    if compact == "off":
        return plain(0, m_k)
    # candidate spans never exceed max_m: the CHUNK_SLOTS HBM guard
    # (bounding the (m, K, F) gather intermediate) applies to compacted
    # chunks exactly as to plain ones
    tgt_m = max(1, min(compact_slots // K, max_m))
    spans, pend = [], None  # pend: accumulated rejected (start, len)
    from spmm_denseblock_tpu import native

    for s in range(0, m_k, tgt_m):
        m = min(tgt_m, m_k - s)
        seg = idx[s * K: (s + m) * K]
        # native dense-mark pass (O(n + n_vals)); numpy sort fallback
        res = native.unique_inverse(seg, n_vals)
        uniq, inv = res if res is not None else np.unique(
            seg, return_inverse=True
        )
        S, U = m * K, uniq.size
        r_sub = _gather_ns_per_slot(U * feat_dim * itemsize, itemsize)
        win = U * r_big + S * r_sub <= _COMPACT_MIN_GAIN * S * r_big
        if compact == "force" or win:
            if pend is not None:
                spans.extend(plain(*pend))
                pend = None
            spans.append((s, m, uniq, inv))
        else:
            pend = (s, m) if pend is None else (pend[0], pend[1] + m)
    if pend is not None:
        spans.extend(plain(*pend))
    return spans


@functools.partial(
    jax.jit, static_argnames=("layout", "has_vals", "band_rows")
)
def _ell_spmm_device(
    idx_chunks, val_chunks, positions, dense, layout, has_vals, band_rows=0
):
    """layout: tuple of (m_k, K, mode, band_start, compacted), one per
    chunk in idx_chunks/val_chunks; a compacted chunk's idx entry is a
    (uniq, local) pair (see _run_chunks).

    Chunks arrive as SEPARATE 2D arrays — never as one flat
    concatenated vector. A single (slots,) monolith sliced on device
    looked equivalent, but XLA's tiled layout assignment re-lays-out
    large R1 arrays as 2D using the length's factorization: full
    ogbl-citation's 71,370,006-slot index vector (= 2 x 35,685,003, no
    other small factors) was assigned s32[35685003,2]{1,0:T(8,128)} —
    the 2-wide minor dim tile-pads to 128, a 64x blowup = 18.3 GB, a
    compile-time RESOURCE_EXHAUSTED. (proteins/products only compiled
    because their slot totals happened to factor well.)

    Per-chunk 2D shapes remove the luck, but the MINOR dim must itself
    be tile-friendly: a (m, 1) or (m, 2) chunk (the K=1/2 degree
    classes, m up to CHUNK_SLOTS) would re-create the same 128-wide
    padding blowup. So every chunk is stored with its LARGER dim minor:
      mode "matsum"  — (m, K) row-major, K >= m, sum over axis 1
      mode "matsumT" — (K, m) transposed, m > K, sum over axis 0
      mode "scan"    — (K, m) transposed (scan requires leading K)
    The 128-lane minor-dim pad is then over a dim >= sqrt(slots) —
    negligible for every big chunk. The 8-SUBLANE pad on the major dim
    still bites small-K transposed chunks: a (K, m) chunk with K < 8
    pads K -> 8, an 8/K amplification (8x on the K=1 class). That cost
    is bounded and small in absolute terms — it scales with the small-K
    classes' slot counts (32*m bytes vs 4*m*K), low-degree classes are
    a minor slot fraction, and it beats the alternatives: untransposed
    (m, K) would pad 128/K on the lane dim (128x at K=1), and the flat
    monolith is the compile-time hazard above.

    mode "matsum"/"matsumT" gather a materialized (.., .., F) block and
    sum the K axis; mode "scan" runs K fused gather+accumulate passes
    with no (m, K, F) intermediate. On the earlier target the scan form
    won on big source tables and matsum on small ones (per-step scan
    overhead); the crossover (_chunk_mode) is a fit from before the H100 port, not yet
    re-measured on the H100.

    band_start >= 0: the chunk's indices are LOCAL offsets into the
    `band_rows`-row slice dense[band_start : band_start+band_rows] —
    XLA folds the slice into the gather and the per-index cost drops
    to the small-table rate (bf16: 2.8-4.5 vs 11.1 ns/idx at the full
    products table). Banded chunks REQUIRE vals (pads carry 0 and
    point at local row 0; there is no zero row inside a band).
    band_start == -1: full table; pattern-only (has_vals=False) chunks
    pad at index n_cols into an appended zero row, valued chunks pad at
    index 0 with val 0 — the valued form needs NO padded copy of the
    table (a products-scale bf16 cast + zero-row concatenate costs a
    full extra table buffer per call, which tipped the banded plan
    over HBM)."""
    if not has_vals:
        # one zero row at the end serves every pad slot (index n_cols)
        dense = jnp.concatenate(
            [dense, jnp.zeros((1, dense.shape[1]), dense.dtype)], axis=0
        )
    cat = _run_chunks(idx_chunks, val_chunks, dense, layout, has_vals,
                      band_rows)
    return jnp.take(cat, positions, axis=0).astype(jnp.float32)


def _run_chunks(idx_chunks, val_chunks, dense, layout, has_vals, band_rows):
    """Run every (m, K, mode, band_start, compacted) chunk of `layout`
    against `dense`, returning the class-concatenated (sum_m, F) partial
    rows. A compacted chunk's idx_chunks entry is a PAIR (uniq, local):
    the chunk first gathers its U unique operand rows into a compact
    sub-table (one big-table gather of U indices), then reads its S
    slots from that sub-table at the measured small-table per-index
    rate — see the two-level gather model next to COMPACT_SLOTS."""
    F = dense.shape[1]
    outs = []
    for ci, (m_k, K, mode, band_start, compacted) in enumerate(layout):
        v = val_chunks[ci] if has_vals else None
        if compacted:
            uniq, idx = idx_chunks[ci]
            src = jnp.take(dense, uniq, axis=0)
        else:
            idx = idx_chunks[ci]
            src = (
                jax.lax.slice_in_dim(
                    dense, band_start, band_start + band_rows, axis=0
                )
                if band_start >= 0
                else dense
            )
        if mode == "scan":
            xs = (idx, v) if has_vals else (idx,)

            def body(acc, x, src=src):
                g = jnp.take(src, x[0], axis=0)
                if g.dtype == jnp.int8:
                    # int8 pays off in the GATHER (HBM reads halve vs
                    # bf16); widen immediately for the value multiply
                    g = g.astype(jnp.float32)
                if has_vals:
                    g = g * x[1][:, None].astype(g.dtype)
                return acc + g.astype(jnp.float32), None

            out = jax.lax.scan(body, jnp.zeros((m_k, F), jnp.float32), xs)[0]
        else:
            g = jnp.take(src, idx, axis=0)  # (m,K,F) or (K,m,F)
            red_axis = 0 if mode == "matsumT" else 1
            if g.dtype == jnp.int8 and not has_vals:
                # |sum| <= K*127 <= 32512: exact in int32
                out = g.sum(axis=red_axis, dtype=jnp.int32).astype(jnp.float32)
            else:
                if g.dtype == jnp.int8:
                    g = g.astype(jnp.float32)
                if has_vals:
                    g = g * v[:, :, None].astype(g.dtype)
                out = g.sum(axis=red_axis, dtype=jnp.float32)
        outs.append(out)
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


@functools.partial(
    jax.jit, static_argnames=("layout_in", "layout_ovf", "band_rows")
)
def _ell_banded_device(
    idx_chunks, val_chunks, pos_in, pos_ovf, dense, layout_in, layout_ovf,
    band_rows
):
    """One fused program for the banded plan: in-band chunks (band
    slices, local indices) + overflow chunks (full table), both valued
    (pad-at-0), restored by their own position maps and summed. The
    first len(layout_in) entries of idx_chunks/val_chunks are the
    in-band chunks. Fusing everything into one program lets XLA's
    buffer assignment reuse the chunk temporaries and fold the two
    restores into the add — the sum-of-two-subplans form kept two full
    (n, F) partials plus two restored copies alive across program
    boundaries and exhausted HBM at products scale."""
    n_in = len(layout_in)
    cat_in = _run_chunks(
        idx_chunks[:n_in], val_chunks[:n_in], dense, layout_in, True,
        band_rows,
    )
    cat_ovf = _run_chunks(
        idx_chunks[n_in:], val_chunks[n_in:], dense, layout_ovf, True, 0
    )
    return (
        jnp.take(cat_in, pos_in, axis=0) + jnp.take(cat_ovf, pos_ovf, axis=0)
    ).astype(jnp.float32)


def _row_widths(deg: np.ndarray, bucket: str) -> np.ndarray:
    """Per-row ELL width. bucket="pow2": next power of two (<2x waste,
    ~15 classes). bucket="quarter": round up to a multiple of
    next_pow2(deg)/4 — same asymptotic class count (~2x pow2's, 29 at
    products scale) but <=1.25x waste per row; measured on full
    synthetic ogbn-products: padded slots 179.8M -> 147.4M (1.459x ->
    1.196x of nnz)."""
    p2 = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64))
    if bucket == "pow2":
        return p2
    if bucket != "quarter":
        raise ValueError(f"unknown ELL bucket scheme: {bucket!r}")
    step = np.maximum(1, p2 // 4)
    return np.maximum(1, ((deg + step - 1) // step) * step)


# scan reduce pays off when the gather SOURCE is big and the class is
# wide enough to amortize per-step overhead. The 2^19-row crossover is
# a fit from before the H100 port, not yet re-measured on the H100.
SCAN_MIN_SOURCE_ROWS = 1 << 19
_SCAN_MIN_M, _SCAN_MAX_K = 4096, 256


def _chunk_mode(reduce: str, n_cols: int, m: int, K: int) -> str:
    if reduce == "matsum" or K < 2:
        return "matsum"
    if m < _SCAN_MIN_M or K > _SCAN_MAX_K:
        return "matsum"
    if reduce == "scan":
        return "scan"
    return "scan" if n_cols >= SCAN_MIN_SOURCE_ROWS else "matsum"


def _store_chunk(seg, vseg, m: int, K: int, mode: str):
    """Shape a flat (m*K,) row-major chunk for device storage: 2D with
    the LARGER dim minor (see _ell_spmm_device docstring — small minor
    dims tile-pad in tiled device layouts). Returns (idx2d, vals2d_or_None, mode)
    with mode promoted to "matsumT" when a matsum chunk is stored
    transposed."""
    seg = seg.reshape(m, K)
    if vseg is not None:
        vseg = vseg.reshape(m, K)
    if mode == "scan" or (mode == "matsum" and m > K):
        seg = np.ascontiguousarray(seg.T)
        if vseg is not None:
            vseg = np.ascontiguousarray(vseg.T)
        if mode == "matsum":
            mode = "matsumT"
    return seg, vseg, mode


def _ell_layout(csr: CSR, bucket: str = "quarter", reduce: str = "auto",
                row_sort: str = "keep", compact: str = "off",
                compact_slots: int = COMPACT_SLOTS, itemsize: int = 4,
                feat_dim: int = 128):
    """row_sort: intra-class row order. Rows inside a degree class can
    be permuted freely — the position map restores caller order — so
    "meancol" sorts each class's rows by mean neighbor id to make the
    gather's index stream approximately ascending (DRAM page locality;
    the big-table per-index rate is paging-bound). "keep" preserves
    the caller's
    (reordering-locality) order.

    compact: "off" | "auto" | "force" — two-level gather (see the model
    next to COMPACT_SLOTS). "auto" evaluates the host cost model per
    compact_slots-sized candidate span and compacts only where it wins
    (never fires when the full table already gathers at the fast rate);
    "force" compacts every span (tests/probes). itemsize/feat_dim feed
    the byte-based rate brackets (itemsize = gather dtype's, feat_dim =
    expected operand width; the model is a routing heuristic, not a
    correctness input)."""
    deg = csr.degrees().astype(np.int64)
    n = csr.n_rows
    K_r = _row_widths(deg, bucket)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    if row_sort == "meancol":
        csum = np.concatenate([[0], np.cumsum(cols, dtype=np.int64)])
        mean_col = (csum[indptr[1:]] - csum[indptr[:-1]]) // np.maximum(deg, 1)
        order = np.lexsort((mean_col, K_r))  # class-major, mean-col minor
    elif row_sort == "keep":
        order = np.argsort(K_r, kind="stable")  # rows grouped by class
    else:
        raise ValueError(f"unknown row_sort: {row_sort!r}")
    has_vals = csr.data is not None
    vals = np.asarray(csr.data, dtype=np.float32) if has_vals else None

    from spmm_denseblock_tpu.reorder.simple import _ragged_arange

    # valued layouts pad at row 0 (val 0 kills the contribution; no
    # appended zero row -> no per-call padded copy of the table);
    # pattern-only layouts pad at the appended zero row n_cols
    pad_idx = 0 if has_vals else csr.n_cols
    if compact not in ("off", "auto", "force"):
        raise ValueError(f"unknown compact mode: {compact!r}")
    table_bytes = int(csr.n_cols) * feat_dim * itemsize
    r_big = _gather_ns_per_slot(table_bytes, itemsize)
    if compact == "auto" and table_bytes <= GATHER_FAST_TABLE_BYTES:
        compact = "off"  # full table already gathers at the fast rate
    idx_parts, val_parts, layout = [], [], []
    for K in np.unique(K_r[order]):
        rows_k = order[K_r[order] == K]
        m_k = rows_k.size
        idx = np.full(m_k * K, pad_idx, dtype=np.int32)
        starts = indptr[rows_k]
        d = indptr[rows_k + 1] - starts
        tgt = np.repeat(np.arange(m_k, dtype=np.int64) * K, d) + _ragged_arange(d)
        src = np.repeat(starts, d) + _ragged_arange(d)
        idx[tgt] = cols[src]
        v = None
        if has_vals:
            v = np.zeros(m_k * K, dtype=np.float32)
            v[tgt] = vals[src]
        # split giant classes so the gathered intermediate stays bounded
        # (products-scale: one class can hold 10^8 slots; each chunk's
        # (m, K, F) gather must fit HBM even if XLA fails to fuse the
        # sum), emitting each chunk as its own 2D array (_store_chunk).
        max_m = max(1, CHUNK_SLOTS // K)
        for s, m, uniq, inv in _compact_spans(idx, m_k, int(K), max_m,
                                              compact, compact_slots,
                                              feat_dim, itemsize, r_big,
                                              csr.n_cols + 1):
            seg_flat = idx[s * K: (s + m) * K]
            vflat = v[s * K: (s + m) * K] if has_vals else None
            if uniq is not None:
                local = inv.astype(np.int32)
                mode = _chunk_mode(reduce, uniq.size, m, int(K))
                seg, vseg, mode = _store_chunk(local, vflat, m, int(K), mode)
                idx_parts.append((uniq.astype(np.int32), seg))
                layout.append((m, int(K), mode, -1, True))
            else:
                mode = _chunk_mode(reduce, csr.n_cols, m, int(K))
                seg, vseg, mode = _store_chunk(seg_flat, vflat, m, int(K),
                                               mode)
                idx_parts.append(seg)
                layout.append((m, int(K), mode, -1, False))
            if has_vals:
                val_parts.append(vseg)

    positions = np.empty(n, dtype=np.int32)
    positions[order] = np.arange(n, dtype=np.int32)
    return (
        tuple(idx_parts), tuple(val_parts), positions, tuple(layout),
        has_vals,
    )


def _banded_split(csr: CSR, band_rows: int):
    """Per-row home band (majority vote over disjoint `band_rows`-wide
    column bands, start clamped so the band fits the table) and the
    in-band membership mask per nonzero. Returns (row_start, in_mask)."""
    W = band_rows
    n_rows, n_cols = csr.shape
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    nbands = max(1, -(-n_cols // W))
    key = rows * nbands + cols // W
    cnt = np.bincount(key, minlength=n_rows * nbands).reshape(n_rows, nbands)
    home = cnt.argmax(1)
    row_start = np.minimum(home * W, max(0, n_cols - W)).astype(np.int64)
    in_mask = (cols >= row_start[rows]) & (cols < row_start[rows] + W)
    return row_start, in_mask


def _ell_layout_banded(csr: CSR, band_rows: int, bucket: str):
    """In-band ELL layout: rows grouped by (home band, width class),
    indices stored as LOCAL band offsets, pads at local 0 with val 0 —
    every chunk carries vals (a 0/1 mask when the matrix is pattern-
    only), because a band slice has no guaranteed zero row. Returns the
    same tuple shape as _ell_layout plus the overflow COO (rows, cols,
    vals_or_None) for the caller to wrap in a full-table plan."""
    n_rows, n_cols = csr.shape
    indptr = np.asarray(csr.indptr, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), deg)
    has_vals = csr.data is not None
    vals = np.asarray(csr.data, np.float32) if has_vals else None

    row_start, in_mask = _banded_split(csr, band_rows)
    in_rows, in_cols = rows[in_mask], cols[in_mask]
    in_vals = vals[in_mask] if has_vals else np.ones(in_mask.sum(), np.float32)
    in_local = (in_cols - row_start[in_rows]).astype(np.int32)
    d_in = np.bincount(in_rows, minlength=n_rows).astype(np.int64)
    K_r = _row_widths(d_in, bucket)

    # rows grouped by (band start, width class); stable keeps the
    # caller's (reorder-locality) order inside each group
    order = np.lexsort((K_r, row_start))
    # per-row contiguous slices of in_* come from cumsum of d_in in the
    # ORIGINAL row order (in_rows is sorted because rows was)
    in_ptr = np.concatenate([[0], np.cumsum(d_in)])

    from spmm_denseblock_tpu.reorder.simple import _ragged_arange

    idx_parts, val_parts, layout = [], [], []
    group_key = row_start[order] * (K_r.max() + 1) + K_r[order]
    boundaries = np.flatnonzero(
        np.concatenate([[True], group_key[1:] != group_key[:-1]])
    )
    for gi, b0 in enumerate(boundaries):
        b1 = boundaries[gi + 1] if gi + 1 < boundaries.size else order.size
        rows_g = order[b0:b1]
        K = int(K_r[rows_g[0]])
        start = int(row_start[rows_g[0]])
        m_g = rows_g.size
        idx = np.zeros(m_g * K, dtype=np.int32)  # pads: local 0, val 0
        v = np.zeros(m_g * K, dtype=np.float32)
        d = d_in[rows_g]
        tgt = np.repeat(np.arange(m_g, dtype=np.int64) * K, d) + _ragged_arange(d)
        src = np.repeat(in_ptr[rows_g], d) + _ragged_arange(d)
        idx[tgt] = in_local[src]
        v[tgt] = in_vals[src]
        max_m = max(1, CHUNK_SLOTS // K)
        for s in range(0, m_g, max_m):
            m = int(min(max_m, m_g - s))
            seg, vseg, mode = _store_chunk(
                idx[s * K: (s + m) * K], v[s * K: (s + m) * K], m, K,
                "matsum",
            )
            idx_parts.append(seg)
            val_parts.append(vseg)
            layout.append((m, K, mode, start, False))

    positions = np.empty(n_rows, dtype=np.int32)
    positions[order] = np.arange(n_rows, dtype=np.int32)
    ovf = (
        rows[~in_mask],
        cols[~in_mask],
        vals[~in_mask] if has_vals else None,
    )
    return tuple(idx_parts), tuple(val_parts), positions, tuple(layout), ovf


def csr_spmm_ell_banded_plan(
    csr: CSR,
    band_rows: int = 1 << 19,
    grad: bool = True,
    dtype=None,
    bucket: str = "quarter",
    reduce: str = "auto",
):
    """Banded ELL: in-band gathers read a `band_rows`-row slice of the
    operand (a smaller gather source is a faster one), out-of-band
    nonzeros run
    through the regular full-table ELL plan; outputs sum. Pays off when
    the operand table is much bigger than a band AND the reordering
    localizes columns (rabbit on products: 64% in-band at W=2^19).
    Band guidance from a fit made before the H100 port, not yet
    re-measured on it:
    use with 2-byte dtypes."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import reject_int8_cast

    reject_int8_cast(dtype, "csr_ell_banded (use csr_ell_int8)")
    if grad:
        return grad_plan(
            csr_spmm_ell_banded_plan(csr, band_rows, grad=False, dtype=dtype,
                                     bucket=bucket, reduce=reduce),
            csr_spmm_ell_banded_plan(csr.transpose(), band_rows, grad=False,
                                     dtype=dtype, bucket=bucket,
                                     reduce=reduce),
        )
    if csr.n_cols <= band_rows:  # nothing to band
        return csr_spmm_ell_plan(csr, grad=False, dtype=dtype, bucket=bucket,
                                 reduce=reduce)
    idx_in, vals_in, pos_in, layout_in, (orows, ocols, ovals) = (
        _ell_layout_banded(csr, band_rows, bucket)
    )
    if ovals is None:
        # force the valued (pad-at-0) form: the overflow then needs no
        # padded table copy either, so the whole banded plan reads the
        # operand in place
        ovals = np.ones(orows.shape[0], np.float32)
    ovf_csr = CSR.from_coo(orows, ocols, ovals, shape=csr.shape)
    idx_ovf, vals_ovf, pos_ovf, layout_ovf, _ = _ell_layout(
        ovf_csr, bucket, reduce
    )
    dtype_key = None if dtype is None else jnp.dtype(dtype).name
    arrays = (
        tuple(jnp.asarray(c) for c in idx_in + idx_ovf),
        tuple(jnp.asarray(c) for c in vals_in + vals_ovf),
        jnp.asarray(pos_in),
        jnp.asarray(pos_ovf),
    )
    statics = (csr.shape, layout_in, layout_ovf, dtype_key, int(band_rows))
    return Plan(arrays, _banded_apply, statics)


@functools.partial(jax.jit, static_argnames="statics")
def _banded_apply(statics, arrays, dense):
    # one fused program incl. the dtype cast (every eager pre-op would
    # be a dispatch of its own)
    (n_rows, n_cols), layout_in, layout_ovf, dtype_key, band_rows = statics
    idx_chunks, val_chunks, pos_in, pos_ovf = arrays
    dense = jnp.asarray(dense)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    if dtype_key is not None:
        dense = dense.astype(dtype_key)
    elif dense.dtype != jnp.float32:
        dense = dense.astype(jnp.float32)
    return _ell_banded_device(
        idx_chunks, val_chunks, pos_in, pos_ovf, dense, layout_in,
        layout_ovf, band_rows
    )


def _dev_chunk(c):
    """Device-put one idx chunk: a plain 2D array or a (uniq, local)
    compacted pair."""
    if isinstance(c, tuple):
        return (jnp.asarray(c[0]), jnp.asarray(c[1]))
    return jnp.asarray(c)


def csr_spmm_ell_plan(csr: CSR, grad: bool = True, dtype=None,
                      bucket: str = "quarter", reduce: str = "auto",
                      row_sort: str = "keep", compact: str = "off",
                      compact_slots: int = COMPACT_SLOTS,
                      feat_dim: int = 128):
    """Host layout prep once -> Plan C = f(B).

    dtype=jnp.bfloat16: gather in bf16 (halves the dominant HBM gather
    traffic on full-graph serving), accumulate in f32 — ~1e-3 relative
    error, outside the 1e-4 oracle gate, so it is opt-in.
    bucket="quarter": finer degree classes, ~18% fewer padded slots at
    products scale (see _row_widths) at ~2x the class/launch count.
    reduce: "auto" picks matsum/scan per chunk by the crossover in
    _chunk_mode (a fit from before the H100 port); "matsum"/"scan"
    force one form.
    row_sort="meancol": sort rows inside each class by mean neighbor id
    for gather page locality (free — position map restores order).
    compact="auto": two-level gather — chunks whose rows share most
    neighbors gather their unique operand rows into a compact sub-table
    once and read slots from it at the small-table rate (model
    and thresholds next to COMPACT_SLOTS; layout cost rises by one
    np.unique + searchsorted pass per candidate span)."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import reject_int8_cast

    reject_int8_cast(dtype, "csr_ell (use csr_ell_int8)")
    if grad:
        return grad_plan(
            csr_spmm_ell_plan(csr, grad=False, dtype=dtype, bucket=bucket,
                              reduce=reduce, row_sort=row_sort,
                              compact=compact, compact_slots=compact_slots,
                              feat_dim=feat_dim),
            csr_spmm_ell_plan(csr.transpose(), grad=False, dtype=dtype,
                              bucket=bucket, reduce=reduce,
                              row_sort=row_sort, compact=compact,
                              compact_slots=compact_slots,
                              feat_dim=feat_dim),
        )
    itemsize = 4 if dtype is None else jnp.dtype(dtype).itemsize
    idx_chunks, val_chunks, positions, layout, has_vals = _ell_layout(
        csr, bucket, reduce, row_sort, compact, compact_slots, itemsize,
        feat_dim,
    )
    arrays = (
        tuple(_dev_chunk(c) for c in idx_chunks),
        tuple(jnp.asarray(c) for c in val_chunks),
        jnp.asarray(positions),
    )
    dtype_key = None if dtype is None else jnp.dtype(dtype).name
    statics = (csr.shape, layout, has_vals, dtype_key)
    return Plan(arrays, _ell_apply, statics)


@functools.partial(jax.jit, static_argnames="statics")
def _ell_apply(statics, arrays, dense):
    # one fused program incl. the dtype cast (see _banded_apply note)
    (n_rows, n_cols), layout, has_vals, dtype_key = statics
    idx_chunks, val_chunks, positions = arrays
    dense = jnp.asarray(dense)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    if dtype_key is not None:
        dense = dense.astype(dtype_key)
    elif dense.dtype != jnp.float32:
        dense = dense.astype(jnp.float32)
    if not layout:  # empty matrix
        return jnp.zeros((n_rows, dense.shape[1]), jnp.float32)
    return _ell_spmm_device(
        idx_chunks, val_chunks, positions, dense, layout, has_vals
    )


@functools.partial(jax.jit, static_argnames=("layout", "has_vals"))
def _ell_spmm_int8_device(
    idx_chunks, val_chunks, positions, col_scale, dense, layout, has_vals
):
    """int8-table variant: quantize the operand per column (symmetric,
    zero-point-free — scheme shared with ops/bsr_spmm_int8.py), run the
    SAME chunk machinery against the int8 table, rescale once at the
    end. The win is in the gather: the dominant full-scale cost is
    per-index and cliffs with table size, so an int8 table both halves
    the gathered bytes vs bf16 AND drops the table to half the size on
    that curve (products 628 -> 314 MB at F=128).

    col_scale: static (F,) scales from a calibration batch, or None for
    per-call dynamic scales (one absmax pass over the operand).
    Rescale commutes with the row-permutation gather and the row sums
    because scales are per column: C = s[c] * (A @ q)[:, c]."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import quantize_per_column

    q, col_scale = quantize_per_column(dense, col_scale)
    if not has_vals:
        q = jnp.concatenate(
            [q, jnp.zeros((1, q.shape[1]), jnp.int8)], axis=0
        )
    cat = _run_chunks(idx_chunks, val_chunks, q, layout, has_vals, 0)
    out = jnp.take(cat, positions, axis=0)
    return (out * col_scale[None, :]).astype(jnp.float32)


def csr_spmm_ell_int8_plan(
    csr: CSR,
    calibration=None,
    bucket: str = "quarter",
    reduce: str = "auto",
    row_sort: str = "keep",
    compact: str = "off",
    compact_slots: int = COMPACT_SLOTS,
    feat_dim: int = 128,
    **_ignored,
):
    """int8-table ELL gather — the serving tier for the gather-floor
    regime (full proteins/products, where the ELL gather IS the
    runtime). Inference only (no VJP; quantization noise ~1e-2 relative
    error, far outside the f32 1e-4 gate — opt-in, impl='csr_ell_int8').

    calibration: optional representative operand batch; fixes per-column
    scales at plan time (static-scale serving — same rationale as
    bsr_spmm_int8.static_col_scale: dynamic per-call quantization
    dominated at small graph sizes in the round-1 ddi measurement)."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import (
        reject_grad_request,
        static_col_scale,
    )

    reject_grad_request(_ignored, "csr_ell_int8")
    idx_chunks, val_chunks, positions, layout, has_vals = _ell_layout(
        csr, bucket, reduce, row_sort, compact, compact_slots, itemsize=1,
        feat_dim=feat_dim,
    )
    cs = (
        None
        if calibration is None
        else jnp.asarray(static_col_scale(calibration))
    )
    arrays = (
        tuple(_dev_chunk(c) for c in idx_chunks),
        tuple(jnp.asarray(c) for c in val_chunks),
        jnp.asarray(positions),
        cs,
    )
    statics = (csr.shape, layout, has_vals)
    return Plan(arrays, _ell_int8_apply, statics)


@functools.partial(jax.jit, static_argnames="statics")
def _ell_int8_apply(statics, arrays, dense):
    # one fused program incl. the f32 normalize (see _banded_apply note)
    (n_rows, n_cols), layout, has_vals = statics
    idx_chunks, val_chunks, positions, col_scale = arrays
    dense = jnp.asarray(dense)
    assert dense.shape[0] == n_cols, (dense.shape, n_cols)
    if dense.dtype != jnp.float32:
        dense = dense.astype(jnp.float32)
    if not layout:  # empty matrix
        return jnp.zeros((n_rows, dense.shape[1]), jnp.float32)
    return _ell_spmm_int8_device(
        idx_chunks, val_chunks, positions, col_scale, dense, layout,
        has_vals,
    )


def csr_spmm_ell(csr: CSR, dense, **kw) -> jnp.ndarray:
    return csr_spmm_ell_plan(csr, **kw)(dense)
