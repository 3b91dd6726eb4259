"""Graph / matrix text I/O — the reference's inter-layer file contract.

The reference's layers communicate via text files on disk (SURVEY.md §1):
- edge list `tmp/<ds>_1.txt`: `n nnz` header then one `src dst` per line
  (download_ogb.py:23-27, loadGraphFromFile load_data.cc:167-184)
- CSR dumps `<name>_indptr.txt` / `<name>_indices.txt`: first line is the
  element count, then one value per line (dumpCSRToFile
  load_data.cc:125-141, loadCSRFromFile :143-165)
- permutation files: one integer per line (rabbit_reorder.cc:10-19)

We keep the exact formats so artifacts are interchangeable with the
reference pipeline, and add a binary .npz cache (orders of magnitude
faster for ogbn-scale graphs).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR


def dump_edge_list(csr: CSR, path: str) -> None:
    rows = csr.row_ids()
    cols = np.asarray(csr.indices)
    with open(path, "w") as f:
        f.write(f"{csr.n_rows} {csr.nnz}\n")
        # C-speed formatting (reference files reach 10^8 lines)
        np.savetxt(f, np.stack([rows, cols], 1), fmt="%d")


def load_edge_list(path: str) -> CSR:
    """`n nnz` header + edge pairs; neighbors end up sorted (the
    loadGraphFromFile contract)."""
    with open(path) as f:
        n, nnz = map(int, f.readline().split())
        # np.fromstring parses at C speed (np.loadtxt is line-by-line
        # Python — minutes at ogbn-products scale)
        data = np.fromstring(f.read(), dtype=np.int64, sep=" ")
    data = data.reshape(-1, 2)
    if data.shape[0] != nnz:
        raise ValueError(f"{path}: expected {nnz} edges, got {data.shape[0]}")
    return CSR.from_edges(data, n_rows=n)


def dump_csr(csr: CSR, prefix: str) -> None:
    """Writes `<prefix>_indptr.txt` + `<prefix>_indices.txt` in the
    reference's count-header format."""
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    with open(prefix + "_indptr.txt", "w") as f:
        f.write(f"{indptr.shape[0]}\n")
        np.savetxt(f, indptr, fmt="%d")
    with open(prefix + "_indices.txt", "w") as f:
        f.write(f"{indices.shape[0]}\n")
        np.savetxt(f, indices, fmt="%d")


def load_csr(prefix: str, n_cols: Optional[int] = None) -> CSR:
    with open(prefix + "_indptr.txt") as f:
        cnt = int(f.readline())
        indptr = np.fromstring(f.read(), dtype=np.int64, sep=" ")[:cnt]
    with open(prefix + "_indices.txt") as f:
        cnt = int(f.readline())
        indices = np.fromstring(f.read(), dtype=np.int64, sep=" ")[:cnt]
    n = indptr.shape[0] - 1
    return CSR(
        indptr=indptr.astype(np.int32),
        indices=indices.astype(np.int32),
        data=None,
        shape=(n, n_cols if n_cols is not None else n),
    )


def dump_permutation(old2new: np.ndarray, path: str) -> None:
    with open(path, "w") as f:
        np.savetxt(f, np.asarray(old2new), fmt="%d")


def load_permutation(path: str) -> np.ndarray:
    with open(path) as f:
        return np.fromstring(f.read(), dtype=np.int64, sep=" ").reshape(-1)


# -- binary cache (the library's fast path) -----------------------------------


def save_npz(csr: CSR, path: str) -> None:
    np.savez_compressed(
        path,
        indptr=np.asarray(csr.indptr),
        indices=np.asarray(csr.indices),
        data=np.zeros(0) if csr.data is None else np.asarray(csr.data),
        shape=np.asarray(csr.shape),
    )


def load_npz(path: str) -> CSR:
    z = np.load(path)
    data = z["data"]
    return CSR(
        indptr=z["indptr"].astype(np.int32),
        indices=z["indices"].astype(np.int32),
        data=None if data.shape[0] == 0 else data.astype(np.float32),
        shape=tuple(int(x) for x in z["shape"]),
    )


def cached(cache_dir: str, name: str, builder) -> CSR:
    """Generate-once-then-reuse, like the reference's tmp/ text cache
    (load_data.cc:63-67)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, name + ".npz")
    if os.path.exists(path):
        return load_npz(path)
    csr = builder()
    save_npz(csr, path)
    return csr


def dump_metis_graph(csr: CSR, path: str) -> None:
    """METIS graph format (gen_adj.cpp parity,
    /root/reference/gen_adj.cpp:45-53): header `n m` (m = undirected edge
    count), then per-vertex 1-indexed neighbor lists, self-loops dropped.
    Feed the file to external ndmetis/gpmetis; read results back with
    reorder.load_iperm / load_partition."""
    rows = csr.row_ids().astype(np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    n = csr.n_rows
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)])
    m = rows.shape[0] // 2  # symmetric input assumed (reference's graphs)
    with open(path, "w") as f:
        f.write(f"{n} {m}\n")
        for v in range(n):
            nb = cols[starts[v] : starts[v + 1]] + 1
            f.write(" ".join(map(str, nb)) + "\n")
