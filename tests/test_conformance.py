"""Conformance matrix: EVERY planner tier x edge-case shapes vs the
scipy oracle (the check_result discipline applied uniformly).

Cases deliberately include: empty matrices, single row/col, rectangular
and non-block-divisible shapes, duplicate-free and valued matrices,
F=1 feature columns, rows with no nonzeros.
"""

import numpy as np
import pytest

from spmm_denseblock_tpu.formats.csr import CSR, random_csr
from spmm_denseblock_tpu.ops import PLANNERS, spmm_plan, spmm_scipy
from spmm_denseblock_tpu.ops.reference import assert_allclose

IMPLS = ["csr_xla", "csr_ell", "bcoo", "bsr_xla", "bsr_pallas", "hybrid", "windowed", "dense"]


def _cases():
    rng = np.random.default_rng(0)
    yield "square", random_csr(0.08, 48, 48, seed=1)
    yield "rect_wide", random_csr(0.08, 24, 72, seed=2)
    yield "rect_tall", random_csr(0.08, 72, 24, seed=3)
    yield "ones_adjacency", random_csr(0.1, 40, 40, seed=4, values="ones")
    yield "single_row", CSR.from_coo([0, 0], [3, 17], [1.0, 2.0], (1, 32))
    yield "single_col", CSR.from_coo([2, 9], [0, 0], [1.5, -2.0], (16, 1))
    yield "empty", CSR.from_coo([], [], None, (10, 12))
    # rows 0..4 empty, then a dense-ish band
    rows = np.repeat(np.arange(5, 20), 3)
    cols = (rows * 2 + np.tile(np.arange(3), 15)) % 21
    yield "empty_head_rows", CSR.from_coo(rows, cols, None, (25, 21))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_all_impls_match_oracle(impl, case, rng):
    name, csr = case
    if impl == "bcoo" and csr.nnz == 0:
        pytest.skip("BCOO requires nnz > 0 in this jax version")
    for f_dim in (1, 7, 16):
        x = rng.standard_normal((csr.n_cols, f_dim)).astype(np.float32)
        want = spmm_scipy(csr, x)
        kw = {}
        if impl == "windowed":
            kw = dict(tile_rows=8, window=8)
        try:
            plan = spmm_plan(csr, impl=impl, block_size=8, **kw)
        except Exception as e:
            pytest.fail(f"{impl} plan failed on {name}: {e}")
        got = np.asarray(plan(x))
        assert got.shape == want.shape, (impl, name, got.shape, want.shape)
        assert_allclose(got, want)


@pytest.mark.parametrize("impl", ["csr_ell_int8", "hybrid_int8",
                                  "bsr_int8", "windowed_int8"])
@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_int8_tiers_edge_shapes(impl, case, rng):
    """Quantized serving tiers across the SAME edge shapes as the f32
    matrix, at the quantization-noise tolerance (inference-only tiers;
    empty/ragged layouts must not break the int8 paths). Dynamic
    per-call scales: this matrix checks LAYOUT correctness — static
    calibration coverage (a sampling question, not a layout one) is
    exercised by the targeted tests in test_ops.py."""
    name, csr = case
    for f_dim in (1, 16):
        x = rng.standard_normal((csr.n_cols, f_dim)).astype(np.float32)
        want = spmm_scipy(csr, x)
        kw = {}
        if impl == "windowed_int8":
            kw.update(tile_rows=8, window=8)
        try:
            plan = spmm_plan(csr, impl=impl, block_size=8, **kw)
        except Exception as e:
            pytest.fail(f"{impl} plan failed on {name}: {e}")
        got = np.asarray(plan(x))
        assert got.shape == want.shape, (impl, name, got.shape, want.shape)
        denom = np.abs(want).max()
        if denom > 0:
            assert np.abs(got - want).max() / denom < 6e-2, (impl, name)
        else:
            assert np.abs(got).max() == 0.0, (impl, name)


@pytest.mark.parametrize("impl", ["bsr_xla", "bsr_pallas", "hybrid", "windowed"])
def test_bf16_tiers_match_loosely(impl, rng):
    """dtype=bf16 across the casting tiers: quantization-scale tolerance."""
    import jax.numpy as jnp

    csr = random_csr(0.08, 64, 64, seed=5)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    want = spmm_scipy(csr, x)
    kw = dict(tile_rows=8, window=16) if impl == "windowed" else {}
    plan = spmm_plan(csr, impl=impl, block_size=8, dtype=jnp.bfloat16, **kw)
    got = np.asarray(plan(x))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 3e-2, (impl, rel)


def test_csr_tier_accepts_bsr_input(rng):
    from spmm_denseblock_tpu.formats.bsr import random_bsr

    bsr = random_bsr(0.2, 6, 6, block_size=8, seed=2)
    x = rng.standard_normal((bsr.shape[1], 8)).astype(np.float32)
    plan = spmm_plan(bsr, impl="csr_xla")
    np.testing.assert_allclose(
        np.asarray(plan(x)), bsr.to_dense() @ x, atol=1e-4
    )


def test_check_result_analog():
    """The reference's check_result.cu verbatim discipline, scaled down:
    same random matrix through the CSR tier and the BSR tier, constant
    alternating +-0.5 dense operand (kills accumulation-order noise),
    elementwise |csr - bsr| < 1e-4 ABSOLUTE (check_result.cu:116)."""
    import numpy as np

    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
    from spmm_denseblock_tpu.ops import spmm_plan

    csr = random_csr(0.01, 1 << 11, seed=1234)  # same p, smaller m
    dim = 64
    y = np.where(
        (np.arange(csr.n_cols * dim).reshape(csr.n_cols, dim) % 2) == 0,
        0.5,
        -0.5,
    ).astype(np.float32)
    z1 = np.asarray(spmm_plan(csr, impl="csr_xla")(y))
    z2 = np.asarray(
        spmm_plan(csr_to_bsr(csr, 4), impl="bsr_xla")(y)
    )
    assert np.abs(z1 - z2).max() < 1e-4  # the hard gate
