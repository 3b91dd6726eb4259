"""Cross-oracle SpMM tests — the check_result.cu discipline (eps 1e-4,
seeded inputs) across every implementation tier."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from spmm_denseblock_tpu.formats import CSR, random_csr
from spmm_denseblock_tpu.convert import csr_to_bsr, divide
from spmm_denseblock_tpu.ops import (
    spmm_plan,
    spmm_scipy,
    assert_allclose,
    dense_block_gemm,
)


def _fixture(n=256, m=192, density=0.02, dim=64, seed=0):
    mat = sp.random(n, m, density=density, random_state=seed, format="csr")
    csr = CSR.from_scipy(mat)
    rng = np.random.default_rng(seed + 1)
    dense = rng.standard_normal((m, dim)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    return csr, dense, want


@pytest.mark.parametrize("impl", ["csr_xla", "bcoo", "dense"])
def test_csr_tier_matches_oracle(impl):
    csr, dense, want = _fixture()
    got = spmm_plan(csr, impl=impl)(dense)
    assert_allclose(got, want, msg=impl)


@pytest.mark.parametrize("b", [8, 32])
def test_bsr_xla_matches_oracle(b):
    csr, dense, want = _fixture(seed=b)
    got = spmm_plan(csr, impl="bsr_xla", block_size=b)(dense)
    assert_allclose(got, want, msg=f"bsr_xla b={b}")


@pytest.mark.parametrize("b,dim", [(8, 128), (16, 64), (32, 256)])
def test_bsr_pallas_matches_oracle(b, dim):
    csr, dense, want = _fixture(dim=dim, seed=b + dim)
    got = spmm_plan(csr, impl="bsr_pallas", block_size=b)(dense)
    assert_allclose(got, want, msg=f"bsr_pallas b={b} dim={dim}")


def test_bsr_pallas_nonmultiple_shapes():
    # shapes not multiples of b, feature dim not a multiple of 128
    csr, dense, want = _fixture(n=250, m=187, dim=50, seed=9)
    got = spmm_plan(csr, impl="bsr_pallas", block_size=16)(dense)
    assert got.shape == (250, 50)
    assert_allclose(got, want, msg="pallas ragged edges")


def test_bsr_pallas_empty_block_rows():
    # rows 64..127 empty: kernel must still write those output tiles as 0
    dense_a = np.zeros((128, 64), np.float32)
    dense_a[:32, :32] = np.arange(32 * 32, dtype=np.float32).reshape(32, 32) / 100
    csr = CSR.from_scipy(sp.csr_matrix(dense_a))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    got = spmm_plan(csr, impl="bsr_pallas", block_size=16)(x)
    assert_allclose(got, dense_a @ x, msg="empty rows")
    assert np.all(np.asarray(got[32:]) == 0)


def test_bsr_pallas_precision_override():
    """precision="high" (bf16x3: three bf16 tensor-core passes) is an
    opt-in override of the f32 HIGHEST default — near-f32 error, here
    exercised through plain and grad plans (the CPU interpreter runs it
    near-exactly; chip_smoke.py holds it to 1e-4 on the card)."""
    from spmm_denseblock_tpu.ops import bsr_spmm_pallas_plan

    csr, dense, want = _fixture(dim=64, seed=9)
    bsr = csr_to_bsr(csr, 16)
    for grad in (False, True):
        got = bsr_spmm_pallas_plan(bsr, grad=grad, precision="high")(dense)
        assert_allclose(got, want, eps=1e-3, msg=f"precision=high grad={grad}")


def test_bsr_pallas_bf16_inputs():
    # b=128: the headline block size, bf16 operands on the tensor cores
    csr, dense, want = _fixture(dim=128, seed=4)
    got = spmm_plan(csr, impl="bsr_pallas", block_size=128, dtype=jnp.bfloat16)(dense)
    # bf16 inputs, f32 accumulate: looser gate
    assert_allclose(got, want, eps=2e-2, msg="pallas bf16")


# fixture element density 0.05 -> per-block occupancy ~ N(0.05, 0.014) for
# 16x16 blocks; thresholds straddle it so both parts are nonempty.
@pytest.mark.parametrize("density", [0.04, 0.06])
def test_hybrid_matches_oracle(density):
    csr, dense, want = _fixture(density=0.05, seed=21)
    hyb = divide(csr, 16, density)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0
    for impl in ("pallas", "xla"):
        got = spmm_plan(hyb, impl="hybrid", dense_impl=impl)(dense)
        assert_allclose(got, want, msg=f"hybrid {impl} thr={density}")


def test_hybrid_compact_remainder_matches_oracle():
    """compact= forwards through the hybrid composition to the ELL
    remainder (two-level gather) without disturbing the dense part."""
    csr, dense, want = _fixture(density=0.05, seed=21)
    hyb = divide(csr, 16, 0.05)
    assert hyb.remainder.nnz > 0
    for grad in (False, True):
        got = spmm_plan(hyb, impl="hybrid", grad=grad, compact="force",
                        compact_slots=256)(dense)
        assert_allclose(got, want, msg=f"hybrid compact grad={grad}")


def test_dense_block_gemm_scatter_semantics():
    csr = random_csr(0.05, 64, seed=33)
    b = 8
    bsr = csr_to_bsr(csr, b)
    rng = np.random.default_rng(2)
    dim = 32
    dense = rng.standard_normal((64, dim)).astype(np.float32)
    out = dense_block_gemm(
        jnp.asarray(bsr.block_rows),
        jnp.asarray(bsr.block_cols),
        jnp.asarray(bsr.blocks),
        jnp.asarray(dense.reshape(8, b, dim)),
        bsr.n_block_rows,
    )
    got = np.asarray(out).reshape(64, dim)
    assert_allclose(got, spmm_scipy(csr, dense), msg="dense_block_gemm")


def test_duplicate_edges_sum():
    edges = np.array([[0, 1], [0, 1], [2, 3]])
    csr = CSR.from_edges(edges, n_rows=4)
    x = np.eye(4, dtype=np.float32)
    got = spmm_plan(csr, impl="csr_xla")(x)
    assert float(got[0, 1]) == 2.0


def test_bsr_spmm_pallas_grad_matches_dense(rng):
    """Training-path check the single-chip drive surfaced: the Pallas plan
    must be differentiable (custom VJP = A^T @ g on the same kernel)."""
    import jax
    import jax.numpy as jnp
    from spmm_denseblock_tpu.formats.bsr import random_bsr
    from spmm_denseblock_tpu.ops import bsr_spmm_pallas_plan, assert_allclose

    bsr = random_bsr(0.2, 6, 5, block_size=8, seed=9)
    dense = jnp.asarray(
        rng.standard_normal((bsr.shape[1], 12)).astype("float32")
    )
    plan = bsr_spmm_pallas_plan(bsr)
    a = jnp.asarray(bsr.to_dense())
    g1 = jax.grad(lambda x: jnp.sum(jnp.sin(plan(x))))(dense)
    g2 = jax.grad(lambda x: jnp.sum(jnp.sin(a @ x)))(dense)
    assert_allclose(g1, g2)


def test_bsr_spmm_pallas_flat_bf16(rng):
    import jax.numpy as jnp
    import numpy as np
    from spmm_denseblock_tpu.formats.bsr import random_bsr
    from spmm_denseblock_tpu.ops import bsr_spmm_pallas_plan

    bsr = random_bsr(0.2, 8, 8, block_size=16, seed=4)
    x = rng.standard_normal((bsr.shape[1], 32)).astype(np.float32)
    want = bsr.to_dense() @ x
    got = np.asarray(bsr_spmm_pallas_plan(bsr, dtype=jnp.bfloat16)(x))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 2e-2, rel


def test_gcn_remat_matches(rng):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from spmm_denseblock_tpu.models import gcn_apply, init_gcn

    params = init_gcn(jax.random.PRNGKey(0), [6, 8, 4])
    a = jnp.asarray(rng.standard_normal((20, 20)).astype(np.float32))
    spmm = lambda h: a @ h
    x = jnp.asarray(rng.standard_normal((20, 6)).astype(np.float32))
    base = gcn_apply(params, spmm, x)
    rem = gcn_apply(params, spmm, x, remat=True)
    np.testing.assert_allclose(np.asarray(base), np.asarray(rem), atol=1e-6)
    # gradients identical too
    loss = lambda p, remat: jnp.sum(gcn_apply(p, spmm, x, remat=remat) ** 2)
    g1 = jax.grad(loss)(params, False)
    g2 = jax.grad(loss)(params, True)
    for l1, l2 in zip(jax.tree.leaves(g1), jax.tree.leaves(g2)):
        np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=1e-5)


def test_spmm_tune_picks_a_winner(rng):
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.ops import spmm_scipy, assert_allclose
    from spmm_denseblock_tpu.ops.dispatch import spmm_tune

    csr = random_csr(0.05, 96, 96, seed=3, values="ones")
    x = rng.standard_normal((96, 16)).astype(np.float32)
    plan, report = spmm_tune(
        csr, x, candidates=("bsr_xla", "csr_xla"), block_size=16
    )
    assert report["best"] in ("bsr_xla", "csr_xla")
    assert_allclose(np.asarray(plan(x)), spmm_scipy(csr, x))

    # (impl, kwargs) candidates tune planner options the router can't
    # see — e.g. two-level compaction on vs off on the same tier
    plan, report = spmm_tune(
        csr, x,
        candidates=(
            "csr_ell",
            ("csr_ell", {"compact": "force", "compact_slots": 128}),
        ),
    )
    assert report["best"] in ("csr_ell", "csr_ell(compact, compact_slots)")
    assert_allclose(np.asarray(plan(x)), spmm_scipy(csr, x))


def test_windowed_spmm_matches_oracle(rng):
    """Windowed dense-tile SpMM vs scipy — banded (reordered-like) and
    adversarial (spread) graphs; captured + remainder must cover all nnz."""
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import CSR, random_csr
    from spmm_denseblock_tpu.formats.windowed import divide_windowed
    from spmm_denseblock_tpu.ops import (
        assert_allclose,
        spmm_plan,
        spmm_scipy,
        windowed_spmm_plan,
    )

    # banded graph: windows capture nearly everything
    n = 200
    rows = np.repeat(np.arange(n), 6)
    cols = (rows + np.tile(np.arange(-3, 3), n)) % n
    banded = CSR.from_coo(rows, cols, None, (n, n))
    wt = divide_windowed(banded, tile_rows=16, window=32)
    assert wt.captured_nnz() + wt.remainder.nnz == banded.nnz
    assert wt.captured_nnz() > banded.nnz // 2
    x = rng.standard_normal((n, 12)).astype(np.float32)
    assert_allclose(np.asarray(windowed_spmm_plan(wt)(x)), spmm_scipy(banded, x))
    np.testing.assert_allclose(wt.to_dense(), banded.to_dense(), atol=1e-6)

    # spread-out random graph: remainder carries the tail, still exact
    rnd = random_csr(0.02, 150, 90, seed=7)
    wt2 = divide_windowed(rnd, tile_rows=16, window=16, min_fill=0.01)
    x2 = rng.standard_normal((90, 9)).astype(np.float32)
    assert_allclose(np.asarray(windowed_spmm_plan(wt2)(x2)), spmm_scipy(rnd, x2))

    # dispatch path
    plan = spmm_plan(rnd, impl="windowed", tile_rows=16, window=16)
    assert_allclose(np.asarray(plan(x2)), spmm_scipy(rnd, x2))


def test_sddmm_matches_dense_oracle(rng):
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.ops import sddmm, sddmm_block_plan

    csr = random_csr(0.08, 30, 24, seed=11)
    x = rng.standard_normal((30, 7)).astype(np.float32)
    y = rng.standard_normal((24, 7)).astype(np.float32)
    full = x @ y.T
    rows, cols = csr.row_ids(), np.asarray(csr.indices)
    want = full[rows, cols]
    got = np.asarray(sddmm(csr, x, y))
    np.testing.assert_allclose(got, want, atol=1e-5)

    # block tier: score blocks equal the dense product restricted to blocks
    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr

    bsr = csr_to_bsr(csr, 8)
    plan = sddmm_block_plan(
        bsr.block_rows[: bsr.nnzb], bsr.block_cols[: bsr.nnzb], 8, 30, 24
    )
    blocks = np.asarray(plan(x, y))
    full_pad = np.zeros((32, 24 + 0))
    for k in range(bsr.nnzb):
        r = int(bsr.block_rows[k]) * 8
        c = int(bsr.block_cols[k]) * 8
        sub = np.zeros((8, 8), np.float32)
        rr = min(8, 30 - r)
        cc = min(8, 24 - c)
        sub[:rr, :cc] = full[r : r + rr, c : c + cc]
        np.testing.assert_allclose(blocks[k], sub, atol=1e-5)


def test_csr_ell_int8_quantized(rng):
    """int8-table ELL serving tier: quantization-noise tolerance.
    Covers valued + pattern-only layouts, forced scan + matsum chunk
    modes, and static (calibrated) vs dynamic per-call scales."""
    from spmm_denseblock_tpu.ops import csr_spmm_ell_int8_plan, spmm_plan

    n = 300
    a = sp.random(n, n, density=0.03, random_state=7, format="csr")
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    # calibration must cover the activation range: a larger batch makes
    # the per-column absmax estimate an upper bound w.h.p. (clipped
    # tails, not global misscale, are the static-scale failure mode)
    cal = rng.standard_normal((8 * n, 24)).astype(np.float32)

    valued = CSR.from_scipy(a)
    pattern = CSR(valued.indptr, valued.indices, None, valued.shape)
    want_v = a @ x
    want_p = (a != 0).astype(np.float32) @ x

    for csr, want in ((valued, want_v), (pattern, want_p)):
        for reduce in ("matsum", "scan"):
            for calib in (None, cal):
                got = np.asarray(
                    csr_spmm_ell_int8_plan(csr, calibration=calib,
                                           reduce=reduce)(x)
                )
                rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
                assert rel < 2e-2, (reduce, calib is None, rel)

    # via dispatch
    plan = spmm_plan(valued, impl="csr_ell_int8", calibration=cal)
    rel = np.abs(np.asarray(plan(x)) - want_v).max() / np.abs(want_v).max()
    assert rel < 2e-2, rel


def test_auto_routes_int8_variant(rng):
    """auto + dtype=int8 maps the chosen tier to its quantized variant
    (serving mode); quantization-noise envelope, not the f32 gate."""
    from spmm_denseblock_tpu.ops import spmm_plan

    a = sp.random(400, 400, density=0.02, random_state=1, format="csr")
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    csr = CSR.from_scipy(a)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    cal = rng.standard_normal((3200, 32)).astype(np.float32)
    plan = spmm_plan(csr, impl="auto", block_size=64, dtype=jnp.int8,
                     calibration=cal, bsr_bytes_budget=1 << 20)
    want = a @ x
    # sanity gate only (routing is what's under test): quantization
    # noise on a 3-term row sum can reach ~6e-2 of the global max
    rel = np.abs(np.asarray(plan(x)) - want).max() / np.abs(want).max()
    assert rel < 1e-1, rel
    # int8 output differs from the f32 tier's (proves quantized routing)
    f32 = np.asarray(spmm_plan(csr, impl="auto", block_size=64,
                               bsr_bytes_budget=1 << 20)(x))
    assert np.abs(f32 - want).max() / np.abs(want).max() < 1e-4
    assert not np.allclose(np.asarray(plan(x)), f32)

    # EXPLICIT impl + dtype=int8 remaps too: bsr_pallas + int8 routes
    # to the XLA int8 tier bsr_int8
    explicit = spmm_plan(csr, impl="bsr_pallas", block_size=64,
                         dtype=jnp.int8, calibration=cal)
    rel = np.abs(np.asarray(explicit(x)) - want).max() / np.abs(want).max()
    assert rel < 1e-1, rel


def test_hybrid_int8_quantized(rng):
    """hybrid_int8: int8 dense blocks + int8-table ELL remainder sum to
    the quantization-noise envelope; dispatch splits CSR input."""
    from spmm_denseblock_tpu.ops import hybrid_spmm_int8_plan, spmm_plan

    n = 256
    a = sp.random(n, n, density=0.04, random_state=3, format="csr")
    a.data[:] = rng.standard_normal(a.nnz).astype(np.float32)
    # a dense stripe so divide() actually captures blocks
    a = (a + sp.random(n, n, density=0.6, random_state=4,
                       format="csr").multiply(
             sp.block_diag([np.ones((32, 32))] * (n // 32)))).tocsr()
    csr = CSR.from_scipy(a)
    hyb = divide(csr, 32, 0.05)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0
    x = rng.standard_normal((n, 24)).astype(np.float32)
    cal = rng.standard_normal((8 * n, 24)).astype(np.float32)
    want = a @ x
    got = np.asarray(hybrid_spmm_int8_plan(hyb, calibration=cal)(x))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < 2e-2, rel

    plan = spmm_plan(csr, impl="hybrid_int8", block_size=32,
                     density_threshold=0.05, calibration=cal)
    rel = np.abs(np.asarray(plan(x)) - want).max() / np.abs(want).max()
    assert rel < 2e-2, rel


def test_bsr_spmm_int8_quantized(rng):
    """Inference tier: int8 x int8 -> int32 with per-block x per-column
    scales; quantization-noise tolerance, not the f32 gate."""
    import numpy as np
    from spmm_denseblock_tpu.formats.bsr import random_bsr
    from spmm_denseblock_tpu.ops import bsr_spmm_int8_plan
    from spmm_denseblock_tpu.ops.dispatch import spmm_plan

    bsr = random_bsr(0.2, 12, 10, block_size=16, seed=3)
    x = rng.standard_normal((bsr.shape[1], 40)).astype(np.float32)
    want = bsr.to_dense() @ x
    got = np.asarray(bsr_spmm_int8_plan(bsr)(x))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 2e-2, rel

    # via dispatch, from CSR
    from spmm_denseblock_tpu.formats.csr import random_csr

    csr = random_csr(0.05, 80, 80, seed=5)
    plan = spmm_plan(csr, impl="bsr_int8", block_size=16)
    x2 = rng.standard_normal((80, 8)).astype(np.float32)
    want2 = csr.to_dense() @ x2
    rel2 = np.abs(np.asarray(plan(x2)) - want2).max() / (np.abs(want2).max() + 1e-9)
    assert rel2 < 2e-2, rel2


def test_windowed_multi_window(rng):
    """n_windows=K captures strictly more than K=1 on a two-band graph;
    result stays oracle-exact."""
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.formats.windowed import divide_windowed
    from spmm_denseblock_tpu.ops import assert_allclose, spmm_scipy, windowed_spmm_plan

    n = 160
    rows = np.repeat(np.arange(n), 4)
    # two bands: near-diagonal and shifted by n//2
    cols = np.concatenate(
        [
            (np.repeat(np.arange(n), 2) + np.tile(np.arange(2), n)) % n,
            (np.repeat(np.arange(n), 2) + n // 2 + np.tile(np.arange(2), n)) % n,
        ]
    )
    rows = np.concatenate([np.repeat(np.arange(n), 2), np.repeat(np.arange(n), 2)])
    csr = CSR.from_coo(rows, cols, None, (n, n))

    w1 = divide_windowed(csr, tile_rows=16, window=16, n_windows=1)
    w3 = divide_windowed(csr, tile_rows=16, window=16, n_windows=3)
    assert w3.captured_nnz() > w1.captured_nnz()
    assert w3.captured_nnz() + w3.remainder.nnz == csr.nnz

    x = rng.standard_normal((n, 12)).astype(np.float32)
    want = spmm_scipy(csr, x)
    assert_allclose(np.asarray(windowed_spmm_plan(w1)(x)), want)
    assert_allclose(np.asarray(windowed_spmm_plan(w3)(x)), want)
    np.testing.assert_allclose(w3.to_dense(), csr.to_dense(), atol=1e-6)


def test_csr_spmm_chunked(rng):
    """nnz-chunked CSR plan (the ogbn-products single-chip memory path):
    forced tiny chunks must match the unchunked result exactly."""
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.ops import assert_allclose, spmm_scipy
    from spmm_denseblock_tpu.ops.csr_spmm import csr_spmm_plan

    csr = random_csr(0.05, 120, 90, seed=9)
    x = rng.standard_normal((90, 16)).astype(np.float32)
    want = spmm_scipy(csr, x)
    got = np.asarray(csr_spmm_plan(csr, chunk_nnz=37)(x))
    assert_allclose(got, want)


def test_windowed_int8(rng):
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.ops import spmm_plan, spmm_scipy

    n = 96
    rows = np.repeat(np.arange(n), 5)
    cols = (rows + np.tile(np.arange(5), n)) % n
    csr = CSR.from_coo(rows, cols, rng.random(rows.size).astype("float32"), (n, n))
    x = rng.standard_normal((n, 16)).astype(np.float32)
    want = spmm_scipy(csr, x)
    plan = spmm_plan(csr, impl="windowed_int8", tile_rows=8, window=16)
    got = np.asarray(plan(x))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 3e-2, rel


def test_tiered_spmm(rng):
    """Three-tier (windows + square blocks + CSR tail) oracle check on a
    graph with band + community + noise structure."""
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.ops import assert_allclose, spmm_plan, spmm_scipy

    n = 160
    band_r = np.repeat(np.arange(n), 3)
    band_c = (band_r + np.tile(np.arange(3), n)) % n
    comm_r = np.repeat(np.arange(32, 48), 12)
    comm_c = 32 + (comm_r * 5 + np.tile(np.arange(12), 16)) % 16
    noise_r = np.arange(0, n, 7)
    noise_c = (noise_r * 31 + 3) % n
    csr = CSR.from_coo(
        np.concatenate([band_r, comm_r, noise_r]),
        np.concatenate([band_c, comm_c, noise_c]),
        None, (n, n),
    )
    x = rng.standard_normal((n, 12)).astype(np.float32)
    plan = spmm_plan(csr, impl="tiered", tile_rows=16, window=16, block_size=8)
    assert_allclose(np.asarray(plan(x)), spmm_scipy(csr, x))


def test_int8_static_calibration_scales(rng):
    """Static-scale serving: calibrated plans match the dynamic ones on
    in-distribution operands; scales come from the batch."""
    import numpy as np
    from spmm_denseblock_tpu.formats.bsr import random_bsr
    from spmm_denseblock_tpu.ops import bsr_spmm_int8_plan
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import static_col_scale

    bsr = random_bsr(0.3, 8, 8, block_size=16, seed=6)
    cal = rng.standard_normal((bsr.shape[1], 24)).astype(np.float32)
    x = rng.standard_normal((bsr.shape[1], 24)).astype(np.float32)
    want = bsr.to_dense() @ x

    # same-batch calibration: quantization noise only (~1e-2)
    got = np.asarray(bsr_spmm_int8_plan(bsr, calibration=x)(x))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 3e-2, rel
    # cross-batch calibration: adds clipping of out-of-range tails
    got = np.asarray(bsr_spmm_int8_plan(bsr, calibration=cal)(x))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 1.5e-1, rel

    s = static_col_scale(cal)
    assert s.shape == (24,)
    assert np.all(s > 0)


def test_auto_tune_with_fallback(rng):
    """auto + tune_with=operand: when the threshold scorer's hybrid vs
    pure-ELL margin is thin (<15%), the router measures the finalists
    on the caller's operand instead of trusting the two-point-fit
    constants. Whatever it returns must be a working
    plan that matches the oracle."""
    from spmm_denseblock_tpu.ops import spmm_plan

    a = sp.random(512, 512, density=0.03, random_state=4, format="csr")
    a.data[:] = 1.0
    csr = CSR.from_scipy(a)
    x = rng.standard_normal((512, 16)).astype(np.float32)
    want = a @ x
    # tiny budget forces the densifying-route branch where the scorer +
    # tune fallback live
    for tw in (None, x):
        plan = spmm_plan(csr, impl="auto", block_size=64,
                         bsr_bytes_budget=1 << 16, tune_with=tw)
        got = np.asarray(plan(x))
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 1e-4, (tw is None, rel)

