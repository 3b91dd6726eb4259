"""Plan pytree API: composition, grads, and the GB-scale no-constants
property (ops/plan.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from spmm_denseblock_tpu.formats.bsr import random_bsr
from spmm_denseblock_tpu.formats.csr import random_csr
from spmm_denseblock_tpu.ops import (
    Plan,
    assert_allclose,
    bsr_spmm_pallas_plan,
    csr_spmm_ell_plan,
    spmm_plan,
    spmm_scipy,
    sum_plan,
)


def test_plan_is_pytree_and_callable(rng):
    csr = random_csr(0.08, 64, 64, seed=1)
    plan = csr_spmm_ell_plan(csr, grad=False)
    assert isinstance(plan, Plan)
    leaves, treedef = jax.tree.flatten(plan)
    assert all(hasattr(x, "dtype") for x in leaves)
    rebuilt = jax.tree.unflatten(treedef, leaves)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(plan(x)), np.asarray(rebuilt(x)))


def test_plan_passes_through_jit_as_argument(rng):
    """The point of the API: plan arrays become jit PARAMETERS, not HLO
    constants, when the plan is a jit argument."""
    bsr = random_bsr(0.3, 8, 8, block_size=16, seed=2)
    plan = bsr_spmm_pallas_plan(bsr, grad=False)
    x = jnp.asarray(rng.standard_normal((bsr.shape[1], 8)).astype(np.float32))

    as_arg = jax.jit(lambda p, v: p(v)).lower(plan, x).as_text()
    as_closure = jax.jit(lambda v: plan(v)).lower(x).as_text()
    # the (nnzb, 16, 16) block tensor must appear in the arg version's
    # entry parameters, and as an embedded constant in the closure one
    blocks_shape = "x".join(map(str, np.asarray(plan.arrays[2]).shape))
    entry_line = next(
        line for line in as_arg.splitlines() if "func.func public @main" in line
    )
    assert blocks_shape in entry_line, entry_line
    closure_entry = next(
        line
        for line in as_closure.splitlines()
        if "func.func public @main" in line
    )
    assert blocks_shape not in closure_entry, closure_entry

    # and both still compute the same thing
    got_arg = np.asarray(jax.jit(lambda p, v: p(v))(plan, x))
    assert_allclose(got_arg, np.asarray(plan(x)))


def test_sum_plan_and_grad_through_composition(rng):
    csr = random_csr(0.1, 48, 48, seed=3)
    p1 = csr_spmm_ell_plan(csr)  # grad wrapper
    p2 = csr_spmm_ell_plan(csr)
    s = sum_plan((p1, p2))
    x = jnp.asarray(rng.standard_normal((48, 6)).astype(np.float32))
    a = jnp.asarray(csr.to_dense())
    g1 = jax.grad(lambda v: jnp.sum(jnp.cos(s(v))))(x)
    g2 = jax.grad(lambda v: jnp.sum(jnp.cos(2.0 * (a @ v))))(x)
    assert_allclose(g1, g2, msg="grad through sum_plan")


def test_spmm_plan_returns_plans_for_main_tiers(rng):
    csr = random_csr(0.05, 96, 96, seed=4, values="ones")
    for impl in ("csr_xla", "csr_ell", "bsr_pallas", "windowed", "tiered"):
        p = spmm_plan(csr, impl=impl, block_size=16)
        assert isinstance(p, Plan), impl
        got = np.asarray(p(rng.standard_normal((96, 5)).astype(np.float32)))
        assert got.shape == (96, 5)


def test_ell_quarter_bucket_matches_oracle(rng):
    """bucket="quarter" (finer ELL classes, ~18% fewer padded slots at
    products scale) must be numerically identical to pow2 bucketing."""
    csr = random_csr(0.05, 96, 80, seed=7)
    x = rng.standard_normal((80, 16)).astype(np.float32)
    want = spmm_scipy(csr, x)
    for grad in (False, True):
        got = csr_spmm_ell_plan(csr, grad=grad, bucket="quarter")(x)
        assert_allclose(np.asarray(got), want)
    # the quarter layout really is smaller on a skewed-degree matrix
    from spmm_denseblock_tpu.ops.csr_spmm_ell import _ell_layout
    slots = lambda b: sum(m * k for m, k, *_ in _ell_layout(csr, b)[3])
    assert slots("quarter") <= slots("pow2")


def test_ell_compact_two_level_matches_oracle(rng):
    """compact="force" (two-level gather: unique sub-table + local
    indices) must match the oracle exactly — pattern-only and valued
    matrices, plain and grad plans, and through the int8 tier's layout
    path. Layout invariants: compacted entries are (uniq, local) pairs,
    local indices address the uniq array, uniq values address the
    (possibly zero-row-padded) table."""
    import importlib

    mod = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_ell")
    for valued in (True, False):
        csr = random_csr(0.06, 120, 100, seed=23)
        if not valued:
            csr = type(csr)(indptr=csr.indptr, indices=csr.indices,
                            data=None, shape=csr.shape)
        x = rng.standard_normal((100, 8)).astype(np.float32)
        want = spmm_scipy(csr, x)
        for grad in (False, True):
            plan = csr_spmm_ell_plan(csr, grad=grad, compact="force",
                                     compact_slots=64)
            assert_allclose(np.asarray(plan(x)), want)
        idx_chunks, _, _, layout, _ = mod._ell_layout(
            csr, compact="force", compact_slots=64
        )
        assert any(comp for *_, comp in layout)
        pad_limit = csr.n_cols + (0 if valued else 1)
        for ent, (m, K, mode, _, comp) in zip(idx_chunks, layout):
            assert comp and isinstance(ent, tuple)
            uniq, local = ent
            assert uniq.ndim == 1 and np.all(np.diff(uniq) > 0)
            assert uniq.max() < pad_limit
            assert local.max() < uniq.size and local.size == m * K
            # storage orientation invariant holds for compacted chunks
            assert local.shape[-1] == max(m, K), (local.shape, mode)

    # "auto" never fires on a small table (full table already fast)
    idx_chunks, _, _, layout, _ = mod._ell_layout(csr, compact="auto")
    assert all(not comp for *_, comp in layout)
    assert all(not isinstance(e, tuple) for e in idx_chunks)


def test_dispatch_forwards_feat_dim_and_compact(rng):
    """spmm_plan must forward feat_dim to the ELL/hybrid planners (the
    compaction rate model sizes its byte brackets with it) without
    leaking it to tiers that don't take it."""
    csr = random_csr(0.05, 96, 96, seed=31)
    x = rng.standard_normal((96, 8)).astype(np.float32)
    want = spmm_scipy(csr, x)
    for impl in ("csr_ell", "hybrid"):
        got = spmm_plan(csr, impl=impl, feat_dim=512, compact="force",
                        compact_slots=128, block_size=16)(x)
        assert_allclose(np.asarray(got), want, msg=impl)
    # feat_dim alone still works for the BSR route (steering heuristic)
    got = spmm_plan(csr, impl="auto", feat_dim=64, block_size=16)(x)
    assert_allclose(np.asarray(got), want)


def test_ell_compact_int8_matches_oracle(rng):
    """int8-table ELL with compact="force": the compacted sub-table is
    int8, pattern-only sums stay exact in int32, and the rescale
    commutes — quantization tolerance only."""
    from spmm_denseblock_tpu.ops import csr_spmm_ell_int8_plan

    csr = random_csr(0.08, 90, 70, seed=29)
    x = rng.standard_normal((70, 8)).astype(np.float32)
    want = spmm_scipy(csr, x)
    got = np.asarray(
        csr_spmm_ell_int8_plan(csr, compact="force", compact_slots=64)(x)
    )
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) <= 2e-2 * scale


def test_ell_scan_reduce_matches_oracle(rng):
    """reduce="scan" (transposed storage + K fused gather+add passes)
    must match the matsum form bit-for-bit in f32; the crossover guards
    (_chunk_mode) are bypassed by forcing the mode and shrinking the
    thresholds."""
    import importlib

    # the ops package re-exports a FUNCTION named csr_spmm_ell that
    # shadows the submodule attribute; import_module gets the module
    mod = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_ell")

    old = mod._SCAN_MIN_M
    mod._SCAN_MIN_M = 1
    try:
        csr = random_csr(0.08, 64, 48, seed=11)
        x = rng.standard_normal((48, 16)).astype(np.float32)
        want = spmm_scipy(csr, x)
        for grad in (False, True):
            got = csr_spmm_ell_plan(csr, grad=grad, reduce="scan")(x)
            assert_allclose(np.asarray(got), want)
        # the forced layout really contains scan chunks
        layout = mod._ell_layout(csr, reduce="scan")[3]
        assert any(mode == "scan" for _, _, mode, *_ in layout)
    finally:
        mod._SCAN_MIN_M = old


def test_ell_meancol_row_sort_matches_oracle(rng):
    """row_sort="meancol" permutes rows inside each degree class (for
    gather page locality); the position map must still restore caller
    order exactly, for plain and grad plans."""
    csr = random_csr(0.06, 128, 112, seed=19)
    x = rng.standard_normal((112, 8)).astype(np.float32)
    want = spmm_scipy(csr, x)
    for grad in (False, True):
        got = csr_spmm_ell_plan(csr, grad=grad, row_sort="meancol")(x)
        assert_allclose(np.asarray(got), want)
    # the sort really changes the intra-class emission order
    import importlib
    mod = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_ell")
    pos_keep = mod._ell_layout(csr)[2]
    pos_sort = mod._ell_layout(csr, row_sort="meancol")[2]
    assert not np.array_equal(pos_keep, pos_sort)


def test_ell_chunks_store_larger_dim_minor(rng):
    """Compile-safety invariant (ogbl-citation RESOURCE_EXHAUSTED,
    csr_spmm_ell._ell_spmm_device docstring): every ELL chunk is a 2D
    array whose minor dim is the larger of (m, K), so no parameter
    carries a narrow minor dim that a tiled device layout would pad
    64-128x. Checked for both plain and banded layouts on a skewed-
    degree matrix that produces K=1/2 classes with many rows."""
    import importlib

    mod = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_ell")
    csr = random_csr(0.04, 256, 256, seed=17)
    idx_chunks, _, _, layout, _ = mod._ell_layout(csr)
    assert idx_chunks and len(idx_chunks) == len(layout)
    for chunk, (m, K, mode, _, _) in zip(idx_chunks, layout):
        assert chunk.ndim == 2 and chunk.size == m * K, (chunk.shape, m, K)
        assert chunk.shape[-1] == max(m, K), (chunk.shape, mode)
        # storage orientation must match the mode the device code runs
        assert chunk.shape == ((m, K) if mode == "matsum" else (K, m)), mode
    bi, bv, _, blayout, _ = mod._ell_layout_banded(csr, 64, "quarter")
    for chunk, vchunk, (m, K, mode, start, _) in zip(bi, bv, blayout):
        assert start >= 0 and chunk.shape == vchunk.shape
        assert chunk.shape[-1] == max(m, K), (chunk.shape, mode)


def test_ell_banded_matches_oracle(rng):
    """Banded ELL (in-band gathers from a band slice + overflow plan,
    summed) must match the oracle for pattern-only AND valued matrices,
    including through grad_plan."""
    from spmm_denseblock_tpu.ops import csr_spmm_ell_banded_plan

    for valued in (False, True):
        csr = random_csr(0.07, 80, 96, seed=13)
        if not valued:
            csr = type(csr)(indptr=csr.indptr, indices=csr.indices,
                            data=None, shape=csr.shape)
        x = rng.standard_normal((96, 8)).astype(np.float32)
        want = spmm_scipy(csr, x)
        for grad in (False, True):
            plan = csr_spmm_ell_banded_plan(csr, band_rows=32, grad=grad)
            assert_allclose(np.asarray(plan(x)), want)
    # banded layout really has banded chunks
    import importlib
    mod = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_ell")
    layout = mod._ell_layout_banded(csr, 32, "quarter")[3]
    assert layout and all(start >= 0 for _, _, _, start, _ in layout)


def test_transb_plan_col_major_entry(rng):
    """operand_layout='col' (the reference's transB=1 axis,
    test_bsrmm.cu): the plan takes B^T and matches the row-major plan
    bit-for-bit, across tiers, through the Plan pytree machinery and
    through autodiff."""
    from spmm_denseblock_tpu.ops import transb_plan

    bsr = random_bsr(0.05, 12, 12, block_size=8, seed=7)
    csr = random_csr(0.08, 96, 96, seed=8)
    x = rng.standard_normal((96, 24)).astype(np.float32)
    for mat, impl in ((bsr, "bsr_pallas"), (bsr, "bsr_xla"),
                      (csr, "csr_ell"), (csr, "csr_xla")):
        row = spmm_plan(mat, impl=impl)
        col = spmm_plan(mat, impl=impl, operand_layout="col")
        assert isinstance(col, Plan)
        np.testing.assert_array_equal(
            np.asarray(row(x)), np.asarray(col(x.T))
        )
    # pytree round-trip + jit-as-argument (the no-constants property)
    col = spmm_plan(bsr, impl="bsr_pallas", operand_layout="col")
    leaves, treedef = jax.tree.flatten(col)
    rebuilt = jax.tree.unflatten(treedef, leaves)
    np.testing.assert_array_equal(
        np.asarray(col(x.T)), np.asarray(rebuilt(x.T))
    )

    @jax.jit
    def run(p, xt):
        return p(xt)

    np.testing.assert_array_equal(
        np.asarray(col(x.T)), np.asarray(run(col, x.T))
    )
    # autodiff: d/dB^T of sum(C) == (d/dB of sum(C))^T
    row = spmm_plan(bsr, impl="bsr_pallas")
    g_row = jax.grad(lambda b: row(b).sum())(jnp.asarray(x))
    g_col = jax.grad(lambda bt: col(bt).sum())(jnp.asarray(x.T))
    assert_allclose(np.asarray(g_col), np.asarray(g_row).T)
    # explicit wrapper round-trip on a hand-built plan
    wrapped = transb_plan(row)
    np.testing.assert_array_equal(
        np.asarray(wrapped(x.T)), np.asarray(row(x))
    )
    # bad layout rejected
    import pytest

    with pytest.raises(ValueError):
        spmm_plan(bsr, operand_layout="diag")
