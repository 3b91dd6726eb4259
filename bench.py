"""Headline benchmark: BSR SpMM GFLOP/s on one GPU.

Config mirrors the reference's synthetic sweep point
(test_bsrmm.cu:46-182 at m=2^17 with GFLOP/s = nnzb*b^2*dim/1e6/ms,
/root/reference/test_bsrmm.cu:168): a 2^17 x 2^17 matrix as a 1024x1024
grid of 128x128 blocks at block density 2e-2, dense operand dim 512.

The reference publishes no numbers (BASELINE.md). The natural baseline,
XLA's batched-matmul formulation of the same product (bsr_xla), does not
finish compiling at this shape on the H100 (PERF.md), so `vs_baseline`
is null and the tiers are the kernel's own: the headline is f32 as
`auto` serves it (IEEE f32); bf16x3 (precision="high", opt-in) and bf16
are reported beside it. Every tier is checked on the timed input
against float64 rows at its gate (f32 1e-4, bf16 5e-3); a headline
outside its gate fails the run.

Needs a GPU: exits non-zero, printing no result, anywhere else.
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import json
import sys

import jax
import numpy as np


def main() -> int:
    from spmm_denseblock_tpu.backend import on_gpu

    if not on_gpu():
        print(f"bench.py needs a GPU; JAX's backend is "
              f"{jax.default_backend()!r}", file=sys.stderr)
        return 1

    from spmm_denseblock_tpu.bench.harness import dtype_tolerance
    from spmm_denseblock_tpu.bench.timing import time_call
    from spmm_denseblock_tpu.formats.bsr import random_bsr
    from spmm_denseblock_tpu.hardware import device_spec
    from spmm_denseblock_tpu.ops import bsr_spmm_pallas_plan
    from spmm_denseblock_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    spec = device_spec(dev.device_kind)
    nb, b, f, p = 1024, 128, 512, 2e-2
    bsr = random_bsr(p, nb, nb, block_size=b, seed=1234)
    rng = np.random.default_rng(1234)
    dense = jax.device_put(
        rng.standard_normal((bsr.shape[1], f)).astype(np.float32)
    )
    flops = 2.0 * bsr.nnzb * b * b * f
    sample = np.arange(0, nb, 16)
    rows = (sample[:, None] * b + np.arange(b)).reshape(-1)
    exact = _exact_rows(bsr, np.asarray(dense, np.float64), sample)

    tiers, errors = {}, {}
    for name, kw, tol in (
        ("f32_ieee", {}, dtype_tolerance("float32")),
        ("f32_bf16x3", {"precision": "high"}, dtype_tolerance("float32")),
        ("bf16", {"dtype": "bfloat16"}, dtype_tolerance("bfloat16")),
    ):
        plan = bsr_spmm_pallas_plan(bsr, grad=False, **kw)
        out = np.asarray(plan(dense))[rows]
        errors[name] = float(np.abs(out - exact).max() / np.abs(exact).max())
        tiers[name] = flops / time_call(plan, dense, iters=10)["secs"] / 1e9
        if errors[name] > tol:
            print(f"bench.py: tier {name} is outside its gate "
                  f"({errors[name]:.2e} > {tol:.0e})", file=sys.stderr)
            if name == "f32_ieee":
                return 1
        del plan
    print(json.dumps({
        "metric": "bsr_spmm_pallas_gflops",
        "value": tiers["f32_ieee"],
        "unit": "GFLOP/s",
        "vs_baseline": None,
        "dtype": "f32 (IEEE)",
        "max_rel_err": errors,
        "bf16_share_of_peak": tiers["bf16"] * 1e9 / spec.flops_bf16,
        "tiers_gflops": tiers,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


def _exact_rows(bsr, x, block_rows) -> np.ndarray:
    """float64 numpy product for the given block-rows of A @ x."""
    b = bsr.b
    rows = np.asarray(bsr.block_rows[: bsr.nnzb])
    cols = np.asarray(bsr.block_cols[: bsr.nnzb])
    out = np.zeros((len(block_rows) * b, x.shape[1]))
    for i, r in enumerate(block_rows):
        for k in np.nonzero(rows == r)[0]:
            c = int(cols[k])
            out[i * b:(i + 1) * b] += (
                bsr.blocks[k].astype(np.float64) @ x[c * b:(c + 1) * b])
    return out


if __name__ == "__main__":
    sys.exit(main())
