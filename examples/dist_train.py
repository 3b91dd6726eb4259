"""Distributed GNN training example — single process or several hosts.

Single host (uses all local devices; on this image, force the virtual
CPU mesh to see multi-device behavior):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/dist_train.py --platform cpu --epochs 10

Several GPU hosts (every host runs the SAME command with its own
process id; jax.distributed needs the coordinator spelled out):

    JAX_COORDINATOR_ADDRESS=host0:12345 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=0 python examples/dist_train.py --multihost --epochs 50

The mesh is ('row', 'col'): graph-node stripes with halo exchange over
'row', tensor-parallel feature sharding over 'col' (parallel/train.py).
"""

from __future__ import annotations

import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--n-nodes", type=int, default=2048)
    ap.add_argument("--dims", type=int, nargs="*", default=[32, 64, 8])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--strategy", default="ring", choices=["ring", "allgather"])
    ap.add_argument("--col-parallel", type=int, default=None)
    ap.add_argument(
        "--ckpt-dir", default=None,
        help="sharded orbax checkpoints (models/checkpoint_dist.py): "
             "resume from the latest step if one exists, save every "
             "--ckpt-every epochs",
    )
    ap.add_argument("--ckpt-every", type=int, default=10)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from spmm_denseblock_tpu.parallel import make_mesh, pod_mesh
    from spmm_denseblock_tpu.parallel.multihost import initialize, is_coordinator
    from spmm_denseblock_tpu.parallel.train import (
        make_dist_train_step,
        random_problem,
    )

    if args.multihost:
        initialize()
        mesh = pod_mesh(row_parallelism=args.col_parallel and
                        len(jax.devices()) // args.col_parallel)
    else:
        n = len(jax.devices())
        col = args.col_parallel or (2 if n >= 4 and n % 2 == 0 else 1)
        mesh = make_mesh((n // col, col))
    log = print if (not args.multihost or is_coordinator()) else (lambda *a: None)
    log(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
        f"on {jax.device_count()} devices / {jax.process_count()} processes")

    adj, x, y, mask = random_problem(args.n_nodes, args.dims, p=0.02, seed=0)
    params, opt_state, step = make_dist_train_step(
        adj, mesh, args.dims, model="gcn",
        block_size=args.block_size, strategy=args.strategy,
    )

    mgr, start = None, 0
    if args.ckpt_dir:
        from spmm_denseblock_tpu.models import (
            make_manager,
            restore_dist_checkpoint,
            save_dist_checkpoint,
        )

        mgr = make_manager(args.ckpt_dir)
        if mgr.latest_step() is not None:
            state, start = restore_dist_checkpoint(
                mgr, {"params": params, "opt": opt_state}
            )
            params, opt_state = state["params"], state["opt"]
            log(f"resumed from {args.ckpt_dir} at epoch {start}")

    t0 = time.perf_counter()
    for epoch in range(start, args.epochs):
        params, opt_state, m = step(params, opt_state, x, y, mask)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            log(f"epoch {epoch:3d} loss {float(m['loss']):.4f} "
                f"acc {float(m['acc']):.3f}")
        if mgr and (epoch + 1) % args.ckpt_every == 0:
            save_dist_checkpoint(
                mgr, epoch + 1, {"params": params, "opt": opt_state}
            )
    dt = time.perf_counter() - t0
    done = args.epochs - start
    if done:
        log(f"{done} epochs in {dt:.1f}s ({dt / done * 1e3:.0f} ms/epoch)")


if __name__ == "__main__":
    main()
