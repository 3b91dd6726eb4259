"""End-to-end example: reorder an OGB-scale graph, build the SpMM plan,
train a GCN for node classification.

    python examples/train_gcn.py [--dataset ogbn-arxiv] [--scale 0.1]
                                 [--impl auto] [--epochs 50]

On a GPU, --impl bsr_pallas forces the Pallas BSR kernel.

This is the framework's "hello world": the reference repo benchmarks the
A @ X SpMM in isolation (run_csrmm.cu / run_bsrmm.cu); here the same
kernel sits inside a jitted training step, forward and backward.
"""

from __future__ import annotations

import argparse
import time

import jax
import numpy as np
import optax

from spmm_denseblock_tpu.analyze.metrics import block_metrics
from spmm_denseblock_tpu.io.datasets import load_dataset
from spmm_denseblock_tpu.models import (
    gcn_apply,
    init_gcn,
    make_train_step,
    sym_norm_adjacency,
)
from spmm_denseblock_tpu.ops import spmm_plan
from spmm_denseblock_tpu.reorder import reorder_cached


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ogbn-arxiv")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--strategy", default="rcmk")
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--dims", type=int, nargs="*", default=[128, 256, 40])
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    csr = load_dataset(args.dataset, scale=args.scale)
    print(f"{args.dataset} (scale {args.scale}): n={csr.n_rows} nnz={csr.nnz}")

    rcsr, _ = reorder_cached(
        csr, args.strategy, tag=f"{args.dataset}_s{args.scale}"
    )
    m = block_metrics(rcsr, [args.block_size])[args.block_size]
    print(
        f"reorder={args.strategy}: block density={m['density']:.5f} "
        f"utilization={m['utilization']:.4f}"
    )

    adj = sym_norm_adjacency(rcsr)
    spmm = spmm_plan(
        adj, impl=args.impl, block_size=args.block_size,
        feat_dim=max(args.dims),
    )

    rng = np.random.default_rng(args.seed)
    n, n_cls = csr.n_rows, args.dims[-1]
    x = rng.standard_normal((n, args.dims[0])).astype(np.float32)
    y = rng.integers(0, n_cls, size=n).astype(np.int32)  # synthetic labels
    split = rng.random(n)
    train_mask = (split < 0.6).astype(np.float32)
    val_mask = (split >= 0.6).astype(np.float32)

    params = init_gcn(jax.random.PRNGKey(args.seed), args.dims)
    step, init_state = make_train_step(gcn_apply, spmm, optax.adam(args.lr))
    opt_state = init_state(params)

    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        params, opt_state, metrics = step(params, opt_state, x, y, train_mask)
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            loss = float(metrics["loss"])
            acc = float(metrics["acc"])
            print(f"epoch {epoch:3d} loss {loss:.4f} train-acc {acc:.3f}")
    dt = time.perf_counter() - t0
    print(f"{args.epochs} epochs in {dt:.1f}s ({dt / args.epochs * 1e3:.1f} ms/epoch)")


if __name__ == "__main__":
    main()
