"""Benchmark case runners — the reference's driver set re-designed as a
library (test_csrmm.cu, test_bsrmm.cu, run_csrmm.cu, run_bsrmm.cu,
divide.cu drivers; SURVEY.md §2.5).

Every runner returns a flat dict record with the reference's metrics
(ms, GFLOP/s with the reference's formulas, block density/utilization)
plus roofline fields (bytes moved, arithmetic intensity, achieved
GB/s). Records are JSON-serializable for the sweep harness.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from spmm_denseblock_tpu.analyze.metrics import block_metrics
from spmm_denseblock_tpu.bench.timing import time_call
from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu.convert.divide import divide
from spmm_denseblock_tpu.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu.formats.csr import CSR, random_csr
from spmm_denseblock_tpu.io.datasets import load_dataset
from spmm_denseblock_tpu.ops import spmm_plan
from spmm_denseblock_tpu.reorder import reorder


def _dense_operand(n_rows: int, dim: int, seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_rows, dim)).astype(np.float32)


@jax.jit
def _transb_apply(plan, xt):
    """Column-major entry: ops/plan.transb_plan semantics, jitted with
    the plan as an ARGUMENT (Plan is a pytree), NOT a closure capture —
    closing over it would re-embed its device arrays as HLO constants
    (ops/plan.py)."""
    return plan(xt.T)


def _time_spread(plan, x, iters: int = 10) -> dict:
    """Median host-clock time of plan(x) with its min and max
    (bench/timing.time_call)."""
    return time_call(plan, jax.device_put(x), iters=iters)


# Per-dtype conformance tolerances: the reference gate is elementwise
# 1e-4 in f32 (/root/reference/check_result.cu:233-246); bf16 gathers
# carry ~1e-3 relative error BY DESIGN (opt-in reduced precision) and
# int8 quantization ~1e-2 — a bf16 record failing the f32 gate is bf16
# being bf16, not a regression, and records must say which.
DTYPE_TOL = {
    "float32": 1e-4,
    "f32": 1e-4,
    "bf16x3": 1e-4,  # three-pass bf16 recovers f32-grade accuracy
    "bfloat16": 5e-3,
    "bf16": 5e-3,
    "int8": 5e-2,
}


def dtype_tolerance(dtype_name: Optional[str]) -> float:
    return DTYPE_TOL.get(str(dtype_name or "float32"), 1e-4)


def conformance_fields(out, ref, dtype_name: Optional[str]) -> Dict:
    """max-relative-error vs an oracle plus the PER-DTYPE gate (a bare
    1e-4 gate would misread expected bf16/int8 noise as failure)."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    denom = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(out - ref))) / denom
    tol = dtype_tolerance(dtype_name)
    return {
        "max_rel_err": err,
        "tol": tol,
        "dtype_for_tol": str(dtype_name or "float32"),
        "gate_ok": err <= tol,
    }


def _spread_fields(t: dict) -> Dict:
    """ms median + min/max + repeat count from a time_call dict."""
    return {
        "ms": t["secs"] * 1e3,
        "ms_min": t["secs_min"] * 1e3,
        "ms_max": t["secs_max"] * 1e3,
        "repeats": t["repeats"],
    }


def _bsr_record(bsr: BSR, dim: int, secs: float) -> Dict:
    b = bsr.b
    # reference formula: nnzb*b^2*dim MAC -> 2x for FLOPs
    # (test_bsrmm.cu:168 counts MACs; we report true FLOPs)
    flops = 2.0 * bsr.nnzb * b * b * dim
    bytes_moved = 4.0 * (
        bsr.nnzb * b * b  # blocks
        + bsr.nnzb * b * dim  # gathered B tiles
        + bsr.n_block_rows * b * dim  # C
    )
    return {
        "ms": secs * 1e3,
        "gflops": flops / secs / 1e9,
        "nnz_per_s": bsr.nnz_inside() / secs,
        "block_density": bsr.block_density(),
        "block_utilization": bsr.utilization(),
        "bytes": bytes_moved,
        "intensity_flop_per_byte": flops / bytes_moved,
        "achieved_gb_s": bytes_moved / secs / 1e9,
    }


def bench_synthetic_bsr(
    p: float, block_size: int, dim: int, impl: str = "bsr_pallas",
    n_block_rows: int = 1024, dtype=None, transb: int = 0,
) -> Dict:
    """test_bsrmm analog: seeded random BSR, one timed SpMM.

    transb=1: the dense operand arrives COLUMN-major ((dim, K), the
    reference's transB axis — test_bsrmm.cu sweeps transB in {0,1} with
    cusparse's op(B)). The library's layout standardizes on row-major
    features, so this tier measures the cost of that choice: a
    jitted transpose fused in front of the same plan. The transpose is
    timed INSIDE the call (it is what a column-major caller pays)."""
    import time as _t

    bsr = random_bsr(p, n_block_rows, block_size=block_size, seed=1234)
    t0 = _t.perf_counter()
    plan = spmm_plan(bsr, impl=impl, dtype=dtype) if dtype else spmm_plan(bsr, impl=impl)
    plan_s = _t.perf_counter() - t0
    x = _dense_operand(bsr.shape[1], dim)
    if transb:
        import functools

        plan = functools.partial(_transb_apply, plan)
        x = np.ascontiguousarray(x.T)
    t = _time_spread(plan, x)
    rec = _bsr_record(bsr, dim, t["secs"])
    rec.update(_spread_fields(t))
    rec.update(
        kind="synthetic_bsr", p=p, b=block_size, dim=dim, impl=impl,
        n=bsr.shape[0], nnzb=bsr.nnzb, transb=transb, plan_s=plan_s,
        dtype=str(dtype) if dtype else "float32",
    )
    return rec


def bench_synthetic_csr(
    p: float, dim: int, impl: str = "csr_xla", n_rows: int = 1 << 15
) -> Dict:
    """test_csrmm analog (the reference uses 2^17; default 2^15 keeps
    the CPU test runs short)."""
    import time as _t

    csr = random_csr(p, n_rows, seed=1234)
    t0 = _t.perf_counter()
    plan = spmm_plan(csr, impl=impl)
    plan_s = _t.perf_counter() - t0
    x = _dense_operand(csr.shape[1], dim)
    t = _time_spread(plan, x)
    secs = t["secs"]
    flops = 2.0 * csr.nnz * dim
    rec = {
        "kind": "synthetic_csr", "p": p, "dim": dim, "impl": impl,
        "n": csr.n_rows, "nnz": csr.nnz, "plan_s": plan_s,
        "gflops": flops / secs / 1e9, "nnz_per_s": csr.nnz / secs,
    }
    rec.update(_spread_fields(t))
    return rec


def bench_graph(
    dataset: str, strategy: str = "rcmk", block_size: int = 128,
    dim: int = 128, impl: str = "hybrid", scale: float = 1.0,
    density_threshold: float = 0.05, dtype=None, n_windows: int = 1,
) -> Dict:
    """run_csrmm/run_bsrmm/divide analog on a (reordered) graph."""
    import time as _t

    csr = load_dataset(dataset, scale=scale)
    rcsr, _ = reorder(csr, strategy)
    metrics = block_metrics(rcsr, [block_size])[block_size]
    t_plan0 = _t.perf_counter()

    # inference plans: grad=True would build transposed-layout copies and
    # double device memory (full-products hybrid OOM'd on it)
    kw = dict(dtype=dtype, grad=False) if dtype else dict(grad=False)
    if impl == "windowed":
        from spmm_denseblock_tpu.formats.windowed import divide_windowed

        wt = divide_windowed(rcsr, tile_rows=256, window=1024, n_windows=n_windows)
        from spmm_denseblock_tpu.ops.windowed_spmm import windowed_spmm_plan

        plan = windowed_spmm_plan(wt, **kw)
        extra = {
            "captured_nnz": wt.captured_nnz(),
            "remainder_nnz": wt.remainder.nnz,
            "n_tiles": wt.n_tiles,
        }
    elif impl == "hybrid":
        hyb = divide(rcsr, block_size, density_threshold)
        plan = spmm_plan(hyb, impl="hybrid", **kw)
        extra = {
            "dense_nnzb": hyb.dense.nnzb,
            "remainder_nnz": hyb.remainder.nnz,
            "density_threshold": density_threshold,
        }
    elif impl.startswith("bsr"):
        bsr = csr_to_bsr(rcsr, block_size)
        plan = spmm_plan(bsr, impl=impl, **kw)
        extra = {"nnzb": bsr.nnzb}
    else:
        plan = spmm_plan(rcsr, impl=impl, **kw)
        extra = {}
    plan_s = _t.perf_counter() - t_plan0

    x = _dense_operand(rcsr.n_cols, dim)
    t = _time_spread(plan, x)
    secs = t["secs"]
    flops = 2.0 * csr.nnz * dim
    from spmm_denseblock_tpu.io.datasets import dataset_provenance, graph_stats

    rec = {
        "kind": "graph", "dataset": dataset, "strategy": strategy,
        "b": block_size, "dim": dim, "impl": impl, "scale": scale,
        "dtype": jnp.dtype(dtype).name if dtype else "float32",
        "n": csr.n_rows, "nnz": csr.nnz, "plan_s": plan_s,
        "gflops": flops / secs / 1e9, "nnz_per_s": csr.nnz / secs,
        "block_density": metrics["density"],
        "block_utilization": metrics["utilization"],
        # honest provenance: which graph this actually measured, with
        # its measured structure (synthetic stand-ins are labeled, and
        # their stats make the gap to the real dataset visible)
        "source": dataset_provenance(dataset),
        "graph_stats": graph_stats(csr, sample=500),
    }
    rec.update(_spread_fields(t))
    rec.update(extra)
    return rec


def bench_scaling(
    n_devices_list: Sequence[int],
    p: float = 1.6e-2,
    block_size: int = 64,
    dim: int = 256,
    n_block_rows: int = 1024,
    strategy: str = "allgather",
) -> Dict:
    """Distributed scaling measurement + the interconnect model it must
    be read against (parallel/comms.py docstring for why these are
    separate).

    On a SINGLE-HOST CPU mesh every virtual device shares the same
    cores, so linear nnz/s scaling is physically impossible — the
    honest metric there is RETENTION = rate(n) / rate(1): how much of
    the saturated-core total throughput survives partitioning +
    emulated collectives. Ideal = 1.0. The per-device `efficiency`
    column is kept for multi-card runs, where devices are real cards.
    Each record also carries the analytic interconnect prediction for
    the same shape on an H100 host over NVLink (parallel/comms.py)."""
    from spmm_denseblock_tpu.parallel import make_mesh_1d
    from spmm_denseblock_tpu.parallel.comms import efficiency_model
    from spmm_denseblock_tpu.parallel.spmm import dist_bsr_spmm_plan

    bsr = random_bsr(p, n_block_rows, block_size=block_size, seed=1234)
    x = _dense_operand(bsr.shape[1], dim)
    nnz = bsr.nnz_inside()
    points = []
    base = None
    rate1 = None
    x_dev = x
    for nd in n_devices_list:
        mesh = make_mesh_1d(nd)
        plan = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy)
        # every timed call is synchronised: deep async queues can
        # deadlock CPU-mesh collectives
        secs = time_call(plan, x_dev, iters=3, warmup=1)["secs"]
        rate = nnz / secs
        if base is None:
            base = rate / nd if nd else rate
            rate1 = rate
        model = efficiency_model(
            strategy if strategy != "auto" else "allgather",
            nd, bsr.nnzb, block_size, bsr.shape[1], dim,
        )
        points.append(
            {
                "devices": nd,
                "ms": secs * 1e3,
                "nnz_per_s": rate,
                "efficiency": rate / (nd * base) if base else 1.0,
                "retention": rate / rate1 if rate1 else 1.0,
                "link_model_efficiency": model["efficiency"],
                "link_model_t_comp_us": model["t_comp_us"],
                "link_model_t_comm_us": model["t_comm_us"],
            }
        )
    return {
        "kind": "scaling", "p": p, "b": block_size, "dim": dim,
        "nnzb": bsr.nnzb, "strategy": strategy, "points": points,
        "note": (
            "single-host CPU mesh: devices share cores; read `retention` "
            "(ideal 1.0), not `efficiency`; `link_model_*` is the H100 "
            "NVLink prediction for this shape (parallel/comms.py)"
        ),
    }


def bench_train_scaling(
    n_devices_list: Sequence[int],
    p: float = 1.6e-2,
    block_size: int = 64,
    dims: Sequence[int] = (256, 256, 32),
    n_block_rows: int = 1024,
    strategy: str = "allgather",
    iters: int = 4,
    seed: int = 0,
) -> Dict:
    """Distributed TRAIN-STEP scaling — the model-level counterpart of
    bench_scaling. One full GCN step (dist SpMM fwd+bwd, dense layers,
    adam) per point, on a 1D row mesh of n devices.

    Same reading discipline as bench_scaling: on a single-host CPU mesh
    devices share cores, so the honest metric is RETENTION = step
    rate(n) / rate(1), ideal 1.0 (linear `efficiency` is physically
    impossible there and is kept only for real multi-card runs). Timing
    is fully synced per step (loss readback) — deep async queues
    deadlock CPU-mesh collective rendezvous."""
    import time as _time

    from spmm_denseblock_tpu.parallel import make_mesh_1d
    from spmm_denseblock_tpu.parallel.train import make_dist_train_step

    bsr = random_bsr(p, n_block_rows, block_size=block_size, seed=1234)
    n = bsr.shape[0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], size=n).astype(np.int32)
    mask = np.ones(n, np.float32)

    points = []
    rate1, nd1 = None, None
    for nd in n_devices_list:
        mesh = make_mesh_1d(nd)
        params, opt_state, step = make_dist_train_step(
            bsr, mesh=mesh, dims=list(dims), block_size=block_size,
            strategy=strategy, seed=seed,
        )
        # warm/compile; the loss fetch is the true sync barrier
        params, opt_state, m = step(params, opt_state, x, y, mask)
        float(m["loss"])
        t0 = _time.perf_counter()
        for _ in range(iters):
            params, opt_state, m = step(params, opt_state, x, y, mask)
            float(m["loss"])  # per-step readback: no async queue
        secs = (_time.perf_counter() - t0) / iters
        rate = 1.0 / secs
        if rate1 is None:
            rate1, nd1 = rate, nd
        points.append(
            {
                "devices": nd,
                "ms_per_step": secs * 1e3,
                "steps_per_s": rate,
                # both normalized to the FIRST point (baseline_devices
                # in the record): per-device efficiency and total-rate
                # retention are only rate(1)-relative when the list
                # starts at 1 device
                "efficiency": (rate / nd) / (rate1 / nd1),
                "retention": rate / rate1,
            }
        )
    return {
        "kind": "train_scaling", "p": p, "b": block_size,
        "dims": list(dims), "nnzb": bsr.nnzb, "strategy": strategy,
        "baseline_devices": nd1, "points": points,
        "note": (
            "single-host CPU mesh: devices share cores; read `retention` "
            "(rate vs the baseline_devices point, ideal 1.0), not "
            "`efficiency`"
        ),
    }


def bench_train_step(
    dataset: str = "ogbn-arxiv",
    strategy: str = "rabbit",
    dims: Sequence[int] = (128, 256, 40),
    impl: str = "auto",
    block_size: int = 128,
    scale: float = 1.0,
    iters: int = 10,
    seed: int = 0,
) -> Dict:
    """End-to-end GCN training-step latency on a (reordered) graph —
    the model-level counterpart of the SpMM runners. Steps chain through
    the parameter pytree (true data dependency); the final loss fetch is
    the readback barrier."""
    import time as _time

    import jax
    import optax

    from spmm_denseblock_tpu.models import (
        gcn_apply,
        init_gcn,
        make_train_step,
        sym_norm_adjacency,
    )

    csr = load_dataset(dataset, scale=scale)
    rcsr, _ = reorder(csr, strategy)
    adj = sym_norm_adjacency(rcsr)
    spmm = spmm_plan(adj, impl=impl, block_size=block_size, feat_dim=max(dims))
    params = init_gcn(jax.random.PRNGKey(seed), list(dims))
    step, init_state = make_train_step(gcn_apply, spmm, optax.adam(1e-2))
    opt_state = init_state(params)

    rng = np.random.default_rng(seed)
    x = jax.device_put(
        rng.standard_normal((csr.n_rows, dims[0])).astype(np.float32)
    )
    y = jax.device_put(rng.integers(0, dims[-1], size=csr.n_rows).astype(np.int32))
    mask = jax.device_put(np.ones(csr.n_rows, np.float32))

    # warm/compile + barrier
    params, opt_state, m = step(params, opt_state, x, y, mask)
    float(m["loss"])
    t0 = _time.perf_counter()
    for _ in range(iters):
        params, opt_state, m = step(params, opt_state, x, y, mask)
    float(m["loss"])  # readback barrier; loss depends on the whole chain
    secs = (_time.perf_counter() - t0) / iters

    return {
        "kind": "train_step", "dataset": dataset, "strategy": strategy,
        "impl": impl, "dims": list(dims), "scale": scale,
        "n": csr.n_rows, "nnz": csr.nnz, "ms_per_step": secs * 1e3,
        "edges_per_s": csr.nnz * 2 * (len(dims) - 1) / secs,  # fwd+bwd spmm
    }
