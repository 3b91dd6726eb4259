"""spmm_denseblock_tpu — a block-sparse SpMM library for JAX on NVIDIA GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of the CUDA
research codebase ``xuyifangreeneyes/spmm-denseblock`` (mounted read-only at
/root/reference): graph reordering to densify nonzero blocks, CSR<->BSR and
hybrid format conversion, block-density analytics, and CSR-SpMM / BSR-SpMM /
dense-block-GEMM kernels, re-designed for JAX:

- BSR blocks are matrix-unit tiles (default 128x128) stored as a flat
  ``(nnzb, b, b)`` array with block row/col index vectors (static shapes;
  no ragged CSR walks inside jit).
- The hot kernel is a Pallas (Triton) block-row kernel for the GPU: one
  program per (F-tile, block-row) walks its row's blocks, multiplies each
  with the B tile it needs on the tensor cores, accumulates in registers
  and stores its output tile once (ops/bsr_spmm_pallas.py).
- Distribution is a jax.sharding Mesh + shard_map layer (row-partitioned A,
  all-gather or ppermute-ring halo exchange of B) — the reference is
  single-GPU and has no counterpart (SURVEY.md §2.7).

Layer map (mirrors SURVEY.md §7):
  formats/   CSR, BSR, hybrid pytree dataclasses + device layouts
  io/        edge-list / CSR text I/O (reference file contract), caching
  reorder/   permutation engine: degree-sort, BFS, RCM, Gorder, Rabbit,
             METIS adapters, greedy-closest
  analyze/   block density / utilization / fill histogram / heatmaps
  convert/   csr2bsr, bsr2csr, hybrid divide, small-b -> big-tile packing
  ops/       SpMM kernels (Pallas + XLA fallbacks) and oracles
  parallel/  mesh + shard_map distributed SpMM
  models/    GNN model family (GCN/SAGE/GIN) exercising the SpMM ops
  bench/     roofline benchmark harness (nnz/s, GFLOP/s)
"""

__version__ = "0.5.0"

from spmm_denseblock_tpu.formats import (  # noqa: F401
    CSR,
    BSR,
    Hybrid,
)
