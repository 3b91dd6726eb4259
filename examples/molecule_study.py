"""ogbg-style molecule study: per-graph reorder -> average block
utilization table -> block-diag graph classifier on the reordered batch.

Reference parity: /root/reference/ogbg_code_rcmk.py:60-76 (100-graph
average utilization under per-graph RCM) and ogbg_molhiv.py:5-59 (the
per-molecule greedy chain). Runs on CPU (host analytics + a small
training loop on whatever backend is default).

Usage: python examples/molecule_study.py [--n-graphs 100] [--train]
Appends the utilization table to tmp/ogbg_molecule_study.jsonl.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-graphs", type=int, default=100)
    ap.add_argument("--mean-nodes", type=int, default=25)
    ap.add_argument("--train", action="store_true",
                    help="also train the block-diag classifier briefly")
    ap.add_argument("--out", default="tmp/ogbg_molecule_study.jsonl")
    args = ap.parse_args()

    import numpy as np

    from spmm_denseblock_tpu.analyze import molecule_utilization_study
    from spmm_denseblock_tpu.io.datasets import synthetic_molecules

    csr, graph_ids = synthetic_molecules(
        n_graphs=args.n_graphs, mean_nodes=args.mean_nodes, seed=1234
    )
    table = molecule_utilization_study(
        csr, graph_ids,
        strategies=("original", "rcmk", "closest"),
        n_graphs=args.n_graphs,
    )
    print(f"{args.n_graphs}-graph average block utilization "
          f"(molecule batch, {csr.n_rows} nodes / {csr.nnz} nnz):")
    bs = sorted(next(iter(table.values())).keys())
    print("strategy   " + "  ".join(f"b={b:<4}" for b in bs))
    for strat, row in table.items():
        print(f"{strat:<10} " + "  ".join(
            f"{row[b]['utilization']:.4f}" for b in bs))

    rec = {"kind": "molecule_utilization_study", "n_graphs": args.n_graphs,
           "mean_nodes": args.mean_nodes, "n": int(csr.n_rows),
           "nnz": int(csr.nnz),
           "table": {s: {str(b): v for b, v in row.items()}
                     for s, row in table.items()}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print("wrote", args.out)

    if not args.train:
        return
    # classifier on the per-graph-reordered batch (graph_ids invariant
    # under the permutation because each graph reorders within its range)
    import jax
    import jax.numpy as jnp
    import optax

    from spmm_denseblock_tpu.analyze import per_graph_reorder
    from spmm_denseblock_tpu.models import (
        graph_classifier_apply,
        init_graph_classifier,
    )
    from spmm_denseblock_tpu.ops import spmm_plan
    from spmm_denseblock_tpu.reorder import permutate

    perm = per_graph_reorder(csr, graph_ids, "rcmk")
    rcsr = permutate(perm, csr)
    n_graphs = int(graph_ids.max()) + 1
    dims = [8, 16, 16]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((csr.n_rows, dims[0])).astype(np.float32)
    y = rng.integers(0, 2, size=n_graphs).astype(np.int32)
    params = init_graph_classifier(jax.random.PRNGKey(0), dims, 2)
    spmm = spmm_plan(rcsr, impl="csr_ell")
    gids = jnp.asarray(np.asarray(graph_ids))
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            logits = graph_classifier_apply(p, spmm, x, gids, n_graphs)
            lp = jax.nn.log_softmax(logits)
            return -jnp.mean(jnp.take_along_axis(lp, y[:, None], axis=1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    for i in range(20):
        params, opt_state, loss = step(params, opt_state)
    print(f"classifier 20 steps: loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
