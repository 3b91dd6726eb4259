"""Serving example: reorder once, quantize once, stream SpMM inference.

    python examples/serve_spmm.py [--dataset ogbn-arxiv] [--scale 0.1]
                                  [--impl bsr_int8] [--dim 256]

Demonstrates the deployment path: offline preprocessing (reorder +
format conversion + int8 quantization) followed by a hot loop of
C = A @ X calls on fresh feature batches — the production shape of the
reference's run_csrmm/run_bsrmm measurement loop.
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np

from spmm_denseblock_tpu.analyze.metrics import block_metrics
from spmm_denseblock_tpu.bench.timing import time_call
from spmm_denseblock_tpu.io.datasets import load_dataset
from spmm_denseblock_tpu.ops import spmm_plan, spmm_scipy
from spmm_denseblock_tpu.reorder import reorder_cached


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-arxiv")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--strategy", default="rabbit")
    ap.add_argument(
        "--impl",
        default="auto",
        help="auto routes real (element-sparse) graphs to hybrid; "
        "bsr_int8 is the quantized block tier for block-dense "
        "inputs; csr_ell_int8 / hybrid_int8 are the quantized serving "
        "tiers for gather-bound full graphs (use with --calibrate)",
    )
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--check", action="store_true", help="verify vs scipy")
    ap.add_argument(
        "--calibrate",
        action="store_true",
        help="int8 tiers: fix per-column operand scales from one "
        "representative batch at plan time (static-scale serving — "
        "skips the per-call absmax reduction)",
    )
    args = ap.parse_args()

    t0 = time.perf_counter()
    csr = load_dataset(args.dataset, scale=args.scale)
    rcsr, _ = reorder_cached(
        csr, args.strategy, tag=f"{args.dataset}_s{args.scale}"
    )
    m = block_metrics(rcsr, [args.block_size])[args.block_size]
    plan_kw = {}
    if args.calibrate and "int8" in args.impl:
        cal = np.random.default_rng(1).standard_normal(
            (rcsr.n_cols, args.dim)
        ).astype(np.float32)
        plan_kw["calibration"] = cal
    plan = spmm_plan(rcsr, impl=args.impl, block_size=args.block_size, **plan_kw)
    print(
        f"offline prep {time.perf_counter() - t0:.1f}s: n={csr.n_rows} "
        f"nnz={csr.nnz} density={m['density']:.5f}"
    )

    rng = np.random.default_rng(0)
    x = jax.device_put(
        rng.standard_normal((rcsr.n_cols, args.dim)).astype(np.float32)
    )
    if args.check:
        got = np.asarray(plan(x))
        want = spmm_scipy(rcsr, np.asarray(x))
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        print(f"check vs scipy: rel err {rel:.2e}")

    secs = time_call(plan, x, iters=10)["secs"]
    print(
        f"{args.impl}: {secs * 1e3:.2f} ms/call  "
        f"{csr.nnz / secs / 1e9:.2f} Gnnz/s  "
        f"{2 * csr.nnz * args.dim / secs / 1e9:.0f} GFLOP/s"
    )


if __name__ == "__main__":
    main()
