"""Sweep grids + CLI — the re-design of the reference's benchmark.py
(/root/reference/benchmark.py:3-46), which shells out to per-config CUDA
binaries; here each grid point is a library call and results stream to
JSONL.

Usage:
  python -m spmm_denseblock_tpu.bench bsrmm   [--quick] [--out results.jsonl]
  python -m spmm_denseblock_tpu.bench csrmm   [--quick]
  python -m spmm_denseblock_tpu.bench graph   [--datasets ogbn-arxiv ...]
  python -m spmm_denseblock_tpu.bench scaling [--devices 1 2 4 8]
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from typing import Dict, Iterable, List

from spmm_denseblock_tpu.bench import harness

# reference grids (benchmark.py:4-13,23-33,36-46), rescaled to large
# tiles: the reference sweeps b in {2..64}; small blocks are repacked to
# >=128 supertiles (convert/pack.py), so the device-level sweep covers
# the tile sizes the matrix units consume.
BSR_GRID = {
    "p": [2e-4, 2e-3, 2e-2],
    "b": [32, 64, 128],
    "dim": [64, 128, 256, 512],
    "impl": ["bsr_pallas", "bsr_xla"],
    # the reference's transB axis (test_bsrmm.cu / benchmark.py:8):
    # transb=1 feeds a column-major operand and times the entry
    # transpose with the SpMM (the cost of the row-major layout choice)
    "transb": [0, 1],
}
CSR_GRID = {
    "p": [2e-4, 2e-3, 2e-2],
    "dim": [64, 128, 256, 512],
    "impl": ["csr_xla", "bcoo"],
}
GRAPH_GRID = {
    "datasets": ["ogbn-arxiv", "ogbl-collab"],
    "strategy": ["original", "rcmk", "rabbit"],
    "dim": [16, 32, 64, 128],
    "impl": ["csr_xla", "bsr_pallas", "hybrid", "windowed"],
}


def _emit(rec: Dict, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def _run_grid(cases: Iterable[Dict], fn, out) -> List[Dict]:
    done = []
    for kw in cases:
        try:
            rec = fn(**kw)
        except Exception:
            rec = {"error": traceback.format_exc(limit=3), **kw}
        _emit(rec, out)
        done.append(rec)
    return done


def sweep_bsrmm(quick=False, out=None):
    g = BSR_GRID
    cases = [
        dict(p=p, block_size=b, dim=d, impl=i, transb=t)
        for p in (g["p"][:1] if quick else g["p"])
        for b in (g["b"][-1:] if quick else g["b"])
        for d in (g["dim"][:1] if quick else g["dim"])
        for i in g["impl"]
        for t in (g["transb"][:1] if quick else g["transb"])
    ]
    return _run_grid(cases, harness.bench_synthetic_bsr, out)


def sweep_csrmm(quick=False, out=None):
    g = CSR_GRID
    cases = [
        dict(p=p, dim=d, impl=i, n_rows=1 << (12 if quick else 15))
        for p in (g["p"][:1] if quick else g["p"])
        for d in (g["dim"][:1] if quick else g["dim"])
        for i in g["impl"]
    ]
    return _run_grid(cases, harness.bench_synthetic_csr, out)


def sweep_graph(datasets=None, quick=False, out=None, scale=None):
    g = GRAPH_GRID
    datasets = datasets or g["datasets"]
    if scale is None:
        scale = 0.05 if quick else 1.0
    cases = [
        dict(dataset=ds, strategy=s, dim=d, impl=i, scale=scale)
        for ds in datasets
        for s in (g["strategy"][:2] if quick else g["strategy"])
        for d in (g["dim"][:1] if quick else g["dim"])
        for i in (g["impl"][:2] if quick else g["impl"])
    ]
    return _run_grid(cases, harness.bench_graph, out)


def sweep_scaling(devices=None, out=None):
    import jax

    avail = len(jax.devices())
    devices = devices or [d for d in (1, 2, 4, 8) if d <= avail]
    rec = harness.bench_scaling(devices)
    _emit(rec, out)
    return [rec]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spmm_denseblock_tpu.bench")
    ap.add_argument("sweep", choices=["bsrmm", "csrmm", "graph", "scaling"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--devices", nargs="*", type=int, default=None)
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--platform", default=None, help="e.g. cpu to force the host mesh")
    args = ap.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    out = open(args.out, "w") if args.out else None
    try:
        if args.sweep == "bsrmm":
            sweep_bsrmm(quick=args.quick, out=out)
        elif args.sweep == "csrmm":
            sweep_csrmm(quick=args.quick, out=out)
        elif args.sweep == "graph":
            sweep_graph(datasets=args.datasets, quick=args.quick, out=out, scale=args.scale)
        else:
            sweep_scaling(devices=args.devices, out=out)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
