"""Implementation registry + the user-facing spmm_plan entry point.

The analog of the reference's per-driver impl dispatch strings
('cusparseScsrmm' / 'cusparseScsrmm2' / 'gespmm' in run_csrmm.cu:47-50,
'rocsparse' / 'cusparse' in run_bsrmm.cu) — but as one registry.

    plan = spmm_plan(matrix, impl="bsr_pallas")   # host prep + jit, once
    C = plan(B)                                   # hot call

Tiers: csr_xla (gather+segment-sum, auto nnz-chunked), csr_ell
(degree-bucketed ELL, scatter-free, the element-sparse workhorse), bcoo,
bsr_xla (gather + batched matmul + segment-sum), bsr_pallas (the
block-row Pallas kernel for the GPU, custom VJP), bsr_int8 /
bsr_int8_pallas (quantized inference, XLA / kernel), hybrid (dense
blocks + CSR tail), windowed (row-band x column-window dense tiles),
dense (oracle). impl='auto' picks by backend, block size, dtype, a
device-memory budget and the capture estimate; spmm_tune times
candidates on the caller's operand.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import jax
import jax.numpy as jnp

from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.formats.bsr import BSR
from spmm_denseblock_tpu.formats.hybrid import Hybrid
from spmm_denseblock_tpu.formats.windowed import Windowed, divide_windowed
from spmm_denseblock_tpu.ops.windowed_spmm import (
    tiered_spmm_plan,
    windowed_spmm_int8_plan,
    windowed_spmm_plan,
)
from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu.ops.csr_spmm import csr_spmm_plan, bcoo_spmm_plan
from spmm_denseblock_tpu.ops.csr_spmm_ell import (
    csr_spmm_ell_banded_plan,
    csr_spmm_ell_int8_plan,
    csr_spmm_ell_plan,
)
from spmm_denseblock_tpu.ops.bsr_spmm_xla import bsr_spmm_xla_plan
from spmm_denseblock_tpu.ops.bsr_spmm_pallas import (
    auto_uses_kernel,
    bsr_spmm_pallas_int8_plan,
    bsr_spmm_pallas_plan,
    pow2_blocks,
)
from spmm_denseblock_tpu.ops.bsr_spmm_int8 import bsr_spmm_int8_plan
from spmm_denseblock_tpu.ops.hybrid_spmm import (
    hybrid_spmm_int8_plan,
    hybrid_spmm_plan,
)
from spmm_denseblock_tpu.ops.reference import spmm_dense_jnp


@functools.partial(jax.jit, static_argnames="statics")
def _dense_apply(statics, arrays, dense):
    (a,) = arrays
    return spmm_dense_jnp(a, dense)


def _dense_plan(mat, **kw):
    from spmm_denseblock_tpu.ops.plan import Plan

    return Plan((jnp.asarray(mat.to_dense()),), _dense_apply)


def _prefer_repack128(bsr) -> bool:
    """Small-b BSR routing score: compare the direct path's dominant
    cost (2x the materialized (nnzb, b, F) gather at a min(230, 30*b)
    GB/s small-b rate) against the repacked path's (one 128-wide B tile
    per occupied supertile at ~420 GB/s). F cancels, so the rule is
    F-free. The two rates are a fit from before the H100 port, not yet re-measured on the
    H100."""
    import numpy as np

    b = bsr.block_size
    nnzb = bsr.nnzb
    g = 128 // b
    srow = np.asarray(bsr.block_rows[:nnzb], np.int64) // g
    scol = np.asarray(bsr.block_cols[:nnzb], np.int64) // g
    n_sup = np.unique(srow * (-(-bsr.n_block_cols // g)) + scol).size
    direct_cost = nnzb * b * 2 / min(230.0, 30.0 * b)
    repack_cost = n_sup * 128 / 420.0
    return repack_cost < direct_cost


def _as_csr(m):
    if isinstance(m, CSR):
        return m
    from spmm_denseblock_tpu.convert.csr2bsr import bsr_to_csr
    from spmm_denseblock_tpu.formats.bsr import BSR as _BSR

    if isinstance(m, _BSR):
        return bsr_to_csr(m)
    raise TypeError(f"cannot route {type(m).__name__} to a CSR-tier impl")


_INT8_VARIANT = {
    "bsr_pallas": "bsr_int8_pallas",
    "bsr_xla": "bsr_int8",
    "csr_ell": "csr_ell_int8",
    "hybrid": "hybrid_int8",
    "windowed": "windowed_int8",
}

PLANNERS: Dict[str, Callable] = {
    # CSR tier
    "csr_xla": lambda m, **kw: csr_spmm_plan(_as_csr(m)),  # autodiff, no copies
    "csr_ell": lambda m, **kw: csr_spmm_ell_plan(_as_csr(m), **kw),
    "csr_ell_int8": lambda m, **kw: csr_spmm_ell_int8_plan(_as_csr(m), **kw),
    "csr_ell_banded": lambda m, **kw: csr_spmm_ell_banded_plan(_as_csr(m), **kw),
    "bcoo": lambda m, **kw: bcoo_spmm_plan(_as_csr(m)),
    # BSR tier
    "bsr_xla": lambda m, **kw: bsr_spmm_xla_plan(m, **kw),
    "bsr_pallas": lambda m, **kw: bsr_spmm_pallas_plan(m, **kw),
    "bsr_int8": lambda m, **kw: bsr_spmm_int8_plan(m, **kw),
    "bsr_int8_pallas": lambda m, **kw: bsr_spmm_pallas_int8_plan(m, **kw),
    # hybrid tier
    "hybrid": lambda m, **kw: hybrid_spmm_plan(m, **kw),
    "hybrid_int8": lambda m, **kw: hybrid_spmm_int8_plan(m, **kw),
    "windowed": lambda m, **kw: windowed_spmm_plan(m, **kw),
    "windowed_int8": lambda m, **kw: windowed_spmm_int8_plan(m, **kw),
    "tiered": lambda m, **kw: tiered_spmm_plan(m, **kw),
    # oracle tier
    "dense": _dense_plan,
}


def spmm_plan(matrix, impl: str = "auto", block_size: int = 128, **kw):
    """Build an SpMM executor for `matrix`.

    impl='auto': hybrid inputs run the two-kernel path; block inputs pick
    the BSR tier by backend (bsr_spmm_pallas.auto_uses_kernel: the
    kernel on a GPU, bsr_xla elsewhere) and block size — the analog of
    rocSPARSE's blockDim/WF_SIZE dispatch
    (/root/reference/rocsparse_bsrmm.h:192-252).
    feat_dim sizes the ELL tiers' gather model.
    """
    was_auto = impl == "auto"
    feat_dim = kw.pop("feat_dim", None)
    tune_with = kw.pop("tune_with", None)
    repack_to = kw.pop("repack_to", None)
    operand_layout = kw.pop("operand_layout", "row")
    if operand_layout not in ("row", "col"):
        raise ValueError(
            f"operand_layout must be 'row' or 'col', got {operand_layout!r}"
        )
    if operand_layout == "col":
        # column-major feature entry (the reference's transB=1 axis,
        # test_bsrmm.cu): plan takes B^T (F, K), the transpose is fused
        # into the jitted program (ops/plan.transb_plan).
        from spmm_denseblock_tpu.ops.plan import transb_plan

        inner = spmm_plan(
            matrix, impl=impl, block_size=block_size,
            feat_dim=feat_dim, tune_with=tune_with, repack_to=repack_to,
            **kw,
        )
        return transb_plan(inner)
    if repack_to is not None and isinstance(matrix, BSR):
        from spmm_denseblock_tpu.convert.pack import repack_bsr

        # small-b BSR -> larger supertiles (SURVEY §7): trades
        # zero-fill FLOPs for full matrix-unit tiles.
        matrix = repack_bsr(matrix, repack_to)
    if impl in ("hybrid", "hybrid_int8") and isinstance(matrix, CSR):
        from spmm_denseblock_tpu.convert.divide import (
            auto_threshold,
            divide,
            score_thresholds,
        )

        thr = kw.pop("density_threshold", None)
        if thr is None:
            # measurement-calibrated selection (see the auto branch);
            # margin=0 because the caller asked for a hybrid explicitly.
            # hybrid_int8 gathers a 1-byte table — score with the bytes
            # the plan will actually move, like the auto path does
            dt = kw.get("dtype")
            thr_dtype_bytes = (
                1 if impl == "hybrid_int8"
                else (4 if dt is None else jnp.dtype(dt).itemsize)
            )
            thr, _ = score_thresholds(
                matrix, block_size,
                candidates={0.015, 0.02, 0.03, 0.05,
                            auto_threshold(matrix, block_size)},
                margin=0.0,
                dtype_bytes=thr_dtype_bytes,
            )
            if thr is None:  # nothing qualifies: densest blocks only
                thr = auto_threshold(matrix, block_size)
        matrix = divide(matrix, block_size, thr)
    if impl.startswith("windowed") and isinstance(matrix, CSR):
        matrix = divide_windowed(
            matrix,
            tile_rows=kw.pop("tile_rows", 256),
            window=kw.pop("window", 1024),
            min_fill=kw.pop("min_fill", 0.0),
            n_windows=kw.pop("n_windows", 1),
        )
    if impl == "auto":
        if isinstance(matrix, Windowed):
            impl = "windowed"
        elif isinstance(matrix, Hybrid):
            impl = "hybrid"
        else:
            if isinstance(matrix, BSR) and auto_uses_kernel():
                # the kernel takes power-of-two blocks only
                matrix = pow2_blocks(matrix)
            if isinstance(matrix, BSR) and matrix.block_size < 32 and (
                128 % matrix.block_size == 0
            ):
                # small-b crossover (the reference's blockDim {2..16}
                # axis, rocsparse_bsrmm_impl.h:14-313): repack to
                # 128-supertiles when the supertile path's bytes beat
                # the direct small-b path's (_prefer_repack128; a fit from
                # before the H100 port, not yet re-measured on it).
                if _prefer_repack128(matrix):
                    from spmm_denseblock_tpu.convert.pack import repack_bsr

                    matrix = repack_bsr(matrix, 128)
            impl = "bsr_pallas" if auto_uses_kernel() else "bsr_xla"
        # memory guard: a BSR-ified element-sparse graph can exceed
        # device memory
        # (nnzb * b^2 * 4 bytes — full ogbn-arxiv at b=128 is tens of GB).
        # Route such inputs to a densifying tier instead: scored hybrid
        # (dense blocks + ELL tail) or pure csr_ell.
        if impl.startswith("bsr") and isinstance(matrix, CSR):
            from spmm_denseblock_tpu.analyze.metrics import calculate_nnzb
            from spmm_denseblock_tpu.convert.divide import auto_threshold, divide

            budget = kw.pop("bsr_bytes_budget", 4 << 30)
            nnzb = calculate_nnzb(matrix, block_size)
            # fill-amplification guard: a weakly-structured graph BSR-ifies
            # into mostly-zero blocks; past ~32x zero-fill the block
            # matmul work is waste and the scatter-free ELL tier wins
            # (fit from before the H100 port, not yet re-measured on the H100).
            fill_amp = nnzb * block_size * block_size / max(matrix.nnz, 1)
            if (
                fill_amp > 32
                and nnzb * block_size * block_size * 4 <= budget
            ):
                impl = "csr_ell"
            elif nnzb * block_size * block_size * 4 > budget:
                # threshold scoring (convert/divide.score_thresholds):
                # dense-block count vs padded-ELL-slot count at a
                # slots/block break-even (fit from before the H100 port, not yet re-measured
                # on the H100).
                from spmm_denseblock_tpu.convert.divide import (
                    score_thresholds,
                )

                dt = kw.get("dtype")
                # actual operand itemsize: 1 (int8 serving), 2 (bf16),
                # 4 (f32) — the scorer's gather-byte and dense-budget
                # models scale with the table dtype
                dtype_bytes = 4 if dt is None else jnp.dtype(dt).itemsize
                from spmm_denseblock_tpu.ops.csr_spmm_ell import (
                    SCAN_MIN_SOURCE_ROWS,
                )

                cands = {0.015, 0.02, 0.03, 0.05,
                         auto_threshold(matrix, block_size)}
                # two-regime block cost: 400 slots/block on a
                # proteins-size table, 4000 on a products-size one (big
                # tables make the dense blocks relatively pricier). Both
                # are fits from before the H100 port, not yet re-measured on the H100.
                big_table = matrix.n_cols >= SCAN_MIN_SOURCE_ROWS
                # quarter budget: the dense tier shares device memory
                # with the ELL gather chunk, the operand table, the
                # output, and the train step's in-flight buffers
                best_thr, rep = score_thresholds(
                    matrix, block_size, candidates=cands,
                    slots_per_block=4000.0 if big_table else 400.0,
                    dense_bytes_budget=budget // 4, dtype_bytes=dtype_bytes,
                )
                # thin-margin tune fallback: the slots_per_block
                # constants are two-point fits — when the hybrid/pure-ELL
                # scores sit within 15% and the caller supplied a
                # representative operand, time the finalists instead of
                # trusting the model.
                if tune_with is not None:
                    scores = {
                        r["thr"]: r["score"]
                        for r in rep
                        if r.get("score") is not None
                    }
                    s_ell = scores.get(None)
                    s_hyb = min(
                        (v for k, v in scores.items() if k is not None),
                        default=None,
                    )
                    thin = (
                        s_ell is not None
                        and s_hyb is not None
                        and abs(s_hyb - s_ell) <= 0.15 * min(s_hyb, s_ell)
                    )
                    if thin:
                        hyb_thr = best_thr if best_thr is not None else min(
                            (k for k, v in scores.items()
                             if k is not None and v == s_hyb),
                        )
                        plan, _ = spmm_tune(
                            matrix, tune_with,
                            candidates=(
                                ("hybrid", {"density_threshold": hyb_thr,
                                            "compact": "auto"}),
                                ("csr_ell", {"compact": "auto"}),
                            ),
                            block_size=block_size, **kw,
                        )
                        return plan
                if best_thr is not None:
                    matrix = divide(matrix, block_size, best_thr)
                    impl = "hybrid"
                else:  # densification pays nothing here
                    # NOT csr_ell_banded: despite the single-band probe's
                    # 2.8-4.5 ns/idx, the full banded plan measured
                    # 1488 ms vs plain quarter+scan 1298 on full products
                    # (split-layout padding + multi-band cycling eat the
                    # band-slice rate) — banded stays an opt-in tier for
                    # graphs whose reordering localizes harder
                    impl = "csr_ell"
    # quantized serving: dtype=int8 maps the chosen tier (auto-routed OR
    # explicitly named) to its int8 variant (inference only; pass
    # calibration= for static scales). Tiers without a quantized variant
    # still reach their reject_int8_cast guard.
    dt = kw.get("dtype")
    if dt is not None and jnp.dtype(dt) == jnp.int8 and impl in _INT8_VARIANT:
        kw.pop("dtype")
        impl = _INT8_VARIANT[impl]
    kw.pop("bsr_bytes_budget", None)
    if was_auto and impl in (
        "csr_ell", "csr_ell_int8", "hybrid", "hybrid_int8"
    ):
        # two-level compacted gathers. "auto" only compacts chunks
        # whose byte-rate model (fit from before the H100 port, not yet re-measured on the
        # H100) predicts a win, so small tables are unaffected;
        # plan-build cost rises by one unique+searchsorted pass per
        # candidate span.
        kw.setdefault("compact", "auto")
    if impl.startswith("bsr") and isinstance(matrix, CSR):
        matrix = csr_to_bsr(matrix, block_size)
        if was_auto and auto_uses_kernel():
            matrix = pow2_blocks(matrix)
    if feat_dim is not None and impl in (
        "csr_ell", "csr_ell_int8", "hybrid", "hybrid_int8"
    ):
        # the ELL planners' two-level compaction model sizes its
        # byte-based rate brackets with the operand width
        kw["feat_dim"] = feat_dim
    if impl not in PLANNERS:
        raise KeyError(f"unknown impl {impl!r}; have {sorted(PLANNERS)}")
    return PLANNERS[impl](matrix, **kw)


def spmm_tune(
    matrix,
    sample_dense,
    candidates=None,
    block_size: int = 128,
    **kw,
):
    """Empirical dispatch: build each candidate plan, time it briefly on
    the caller's representative operand, return (best_plan, report).

    The runtime answer to the reference's compile-time WF_SIZE dispatch —
    the crossover depends on density, block size, and feature width
    together, so measuring beats modeling. Plans are cached work anyway;
    tuning costs a few extra compiles once per (matrix, shape) family.

    A candidate is an impl name or an (impl, kwargs) pair — the pair
    form tunes planner options the shape-based router cannot see, e.g.
    ("csr_ell", {"compact": "auto"}) vs plain "csr_ell".

    The default candidates leave out bsr_xla on a GPU, where XLA's plain
    BSR form does not finish compiling at thousands of blocks (PERF.md).
    """
    import numpy as np

    from spmm_denseblock_tpu.bench.timing import time_call

    if candidates is None:
        candidates = ("bsr_pallas",) + (
            () if auto_uses_kernel() else ("bsr_xla",)
        ) + ("csr_ell", "csr_xla", "hybrid", "windowed")
    report = {}
    best, best_t = None, float("inf")
    x = jnp.asarray(np.asarray(sample_dense))
    for cand in candidates:
        name, ckw = cand if isinstance(cand, tuple) else (cand, {})
        label = name if not ckw else f"{name}({', '.join(sorted(ckw))})"
        try:
            plan = spmm_plan(matrix, impl=name, block_size=block_size,
                             **{**kw, **ckw})
            t = time_call(plan, x, iters=3, warmup=1)["secs"]
        except Exception as e:  # impl not applicable to this matrix/backend
            report[label] = {"error": str(e)[:120]}
            continue
        report[label] = {"ms": t * 1e3}
        if t < best_t:
            best, best_t = plan, t
            report["best"] = label
    if best is None:
        raise RuntimeError(f"no candidate worked: {report}")
    return best, report
