"""Distributed SpMM tests on the 8-device virtual CPU mesh.

The reference has no distributed layer; the oracle discipline is the same
cross-check as check_result.cu (eps 1e-4) — scipy on the host vs the
sharded device computation.
"""

import jax
import numpy as np
import pytest

from spmm_denseblock_tpu.formats.bsr import random_bsr
from spmm_denseblock_tpu.formats.csr import random_csr
from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu.ops.reference import assert_allclose, spmm_scipy
from spmm_denseblock_tpu.parallel import (
    dist_bsr_spmm_plan,
    dist_csr_spmm_plan,
    make_mesh_1d,
    shard_bsr,
    shard_stats,
)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh_1d(8)


def _random_case(rng, b=8, nbr=16, nbc=16, f=24):
    bsr = random_bsr(0.15, nbr, nbc, block_size=b, seed=7)
    dense = rng.standard_normal((bsr.shape[1], f)).astype(np.float32)
    want = np.asarray(bsr.to_dense(), dtype=np.float64) @ dense.astype(np.float64)
    return bsr, dense, want.astype(np.float32)


def test_shard_bsr_partition_roundtrip(rng):
    bsr, _, _ = _random_case(rng)
    sh = shard_bsr(bsr, 4)
    # every real block appears exactly once with the right global position
    dense = np.zeros((sh.rows_per_shard * 4 * sh.b, sh.col_chunk * 4 * sh.b))
    for s in range(4):
        for j in range(sh.local_rows.shape[1]):
            r = (sh.local_rows[s, j] + s * sh.rows_per_shard) * sh.b
            c = sh.block_cols[s, j] * sh.b
            dense[r : r + sh.b, c : c + sh.b] += sh.blocks[s, j]
    np.testing.assert_allclose(
        dense[: bsr.shape[0], : bsr.shape[1]], bsr.to_dense(), atol=1e-6
    )
    stats = shard_stats(sh)
    assert sum(stats["nnzb_per_shard"]) == bsr.nnzb


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_dist_bsr_spmm_matches_oracle(mesh, rng, strategy):
    bsr, dense, want = _random_case(rng)
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy)
    got = np.asarray(run(dense))
    assert got.shape == want.shape
    assert_allclose(got, want)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_dist_bsr_spmm_ragged_shapes(mesh, rng, strategy):
    # shapes that do not divide the mesh: 13 block rows, 11 block cols
    bsr = random_bsr(0.2, 13, 11, block_size=8, seed=3)
    dense = rng.standard_normal((bsr.shape[1], 10)).astype(np.float32)
    want = bsr.to_dense() @ dense
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy)
    assert_allclose(np.asarray(run(dense)), want)


def test_dist_bsr_spmm_from_graph_csr(mesh, rng):
    csr = random_csr(0.02, 400, 384, seed=11, values="ones")
    bsr = csr_to_bsr(csr, 16)
    dense = rng.standard_normal((384, 32)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    for strategy in ("allgather", "ring"):
        run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy)
        assert_allclose(np.asarray(run(dense)), want)


def test_dist_csr_spmm_matches_oracle(mesh, rng):
    csr = random_csr(0.03, 300, 200, seed=5)
    dense = rng.standard_normal((200, 17)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    run = dist_csr_spmm_plan(csr, mesh=mesh)
    assert_allclose(np.asarray(run(dense)), want)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_dist_bsr_spmm_2d_mesh_feature_axis(rng, strategy):
    """2D (row=4, col=2) mesh with the feature dim tensor-parallel."""
    from spmm_denseblock_tpu.parallel import make_mesh

    mesh2d = make_mesh((4, 2))
    bsr, dense, want = _random_case(rng, b=8, nbr=16, nbc=16, f=16)
    run = dist_bsr_spmm_plan(
        bsr, mesh=mesh2d, strategy=strategy, feature_axis="col"
    )
    assert_allclose(np.asarray(run(dense)), want)


def test_dist_output_sharding(mesh, rng):
    """C must come back row-sharded (no host round-trip between layers)."""
    bsr, dense, _ = _random_case(rng, b=8, nbr=16, nbc=16, f=16)
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="allgather")
    out = run(dense)
    assert len(out.sharding.device_set) == 8


def test_dist_hybrid_spmm_matches_oracle(mesh, rng):
    from spmm_denseblock_tpu.convert.divide import divide
    from spmm_denseblock_tpu.parallel import dist_hybrid_spmm_plan

    csr = random_csr(0.04, 320, 256, seed=13, values="ones")
    hyb = divide(csr, 16, 0.05)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0  # both parts real
    dense = rng.standard_normal((256, 24)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    run = dist_hybrid_spmm_plan(hyb, mesh=mesh)
    assert_allclose(np.asarray(run(dense)), want)


def test_balanced_block_row_permutation(rng):
    from spmm_denseblock_tpu.parallel import balanced_block_row_permutation
    from spmm_denseblock_tpu.reorder import check_permutation

    # heavily skewed: first block-rows own most blocks
    nbr, b = 32, 8
    rows, cols = [], []
    r = np.random.default_rng(5)
    for i in range(nbr):
        k = max(1, int(40 / (i + 1)))
        rows += [i] * k
        cols += list(r.integers(0, nbr, size=k))
    key = np.unique(np.array(rows) * nbr + np.array(cols))
    rows, cols = key // nbr, key % nbr
    from spmm_denseblock_tpu.formats.bsr import BSR

    bsr = BSR.from_parts(
        rows.astype(np.int32), cols.astype(np.int32),
        np.ones((rows.size, b, b), np.float32), (nbr * b, nbr * b), b,
    )
    n_shards = 4
    perm = balanced_block_row_permutation(bsr, n_shards)
    check_permutation(perm, nbr)

    counts = np.bincount(np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr)
    rows_per = -(-nbr // n_shards)

    def imbalance(assign):
        loads = np.zeros(n_shards)
        for rr in range(nbr):
            loads[assign[rr] // rows_per] += counts[rr]
        return loads.max() / max(loads.mean(), 1)

    naive = imbalance(np.arange(nbr))
    balanced = imbalance(perm)
    assert balanced < naive
    assert balanced < 1.3, (naive, balanced)


def test_dist_windowed_spmm_matches_oracle(mesh, rng):
    from spmm_denseblock_tpu.formats.windowed import divide_windowed
    from spmm_denseblock_tpu.parallel import dist_windowed_spmm_plan

    # banded + some noise: tiles capture the band, remainder the noise
    n = 176
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + np.tile(np.arange(4), n)) % n
    noise_r = np.arange(0, n, 7)
    noise_c = (noise_r * 13 + 5) % n
    from spmm_denseblock_tpu.formats.csr import CSR

    csr = CSR.from_coo(
        np.concatenate([rows, noise_r]),
        np.concatenate([cols, noise_c]),
        None,
        (n, n),
    )
    wt = divide_windowed(csr, tile_rows=8, window=16)
    dense = rng.standard_normal((n, 12)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    run = dist_windowed_spmm_plan(wt, mesh=mesh)
    assert_allclose(np.asarray(run(dense)), want)


@pytest.mark.parametrize(
    "shape_case",
    [
        ("square", 16, 16),
        ("rect_wide", 9, 21),
        ("rect_tall", 21, 9),
        ("tiny", 2, 3),
    ],
    ids=lambda c: c[0],
)
@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_dist_conformance_shapes(mesh, rng, shape_case, strategy):
    """Distributed BSR SpMM across awkward block-grid shapes (fewer
    block-rows than devices, rectangular, etc.)."""
    _, nbr, nbc = shape_case
    bsr = random_bsr(0.3, nbr, nbc, block_size=8, seed=nbr * 31 + nbc)
    dense = rng.standard_normal((bsr.shape[1], 10)).astype(np.float32)
    want = bsr.to_dense() @ dense
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy)
    assert_allclose(np.asarray(run(dense)), want)


def test_permutation_spmm_property(mesh, rng):
    """P A P^T acting on permuted features equals permuted A @ X — the
    reorder/SpMM contract the whole pipeline rests on, checked through
    the distributed path."""
    from spmm_denseblock_tpu.reorder import permutate

    csr = random_csr(0.05, 96, 96, seed=17, values="ones")
    perm = np.random.default_rng(3).permutation(96)
    rcsr = permutate(perm, csr)
    x = rng.standard_normal((96, 12)).astype(np.float32)

    base = spmm_scipy(csr, x)
    run = dist_csr_spmm_plan(rcsr, mesh=mesh)
    got = np.asarray(run(x[np.argsort(perm)]))  # features in new order
    # undo the row permutation on the output
    assert_allclose(got[perm], base)


def test_dist_bsr_spmm_halo(mesh, rng):
    """Halo strategy: banded matrix -> O(1) neighbor exchange; scattered
    matrix -> transparent allgather fallback. Both oracle-exact."""
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr

    # banded: block col within +-1 chunk of its stripe (n=8 shards over
    # 32 block rows/cols -> cpc=4; band of +-2 block cols fits halo 1)
    n = 32 * 8
    rows = np.repeat(np.arange(n), 5)
    cols = (rows + np.tile(np.arange(-2 * 8, -2 * 8 + 5), n)) % n
    banded = CSR.from_coo(rows, cols, None, (n, n))
    bsr = csr_to_bsr(banded, 8)
    dense = rng.standard_normal((n, 12)).astype(np.float32)
    want = spmm_scipy(banded, dense)
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="halo")
    assert_allclose(np.asarray(run(dense)), want)

    # scattered: falls back to allgather, still exact
    scattered = random_bsr(0.15, 16, 16, block_size=8, seed=9)
    d2 = rng.standard_normal((scattered.shape[1], 10)).astype(np.float32)
    run2 = dist_bsr_spmm_plan(scattered, mesh=mesh, strategy="halo")
    assert_allclose(np.asarray(run2(d2)), scattered.to_dense() @ d2)


def test_dist_sddmm_matches_single(mesh, rng):
    from spmm_denseblock_tpu.ops import sddmm
    from spmm_denseblock_tpu.parallel import dist_sddmm_plan

    csr = random_csr(0.06, 100, 72, seed=21)
    x = rng.standard_normal((100, 9)).astype(np.float32)
    y = rng.standard_normal((72, 9)).astype(np.float32)
    want = np.asarray(sddmm(csr, x, y))
    run = dist_sddmm_plan(csr, mesh=mesh)
    got = np.asarray(run(x, y))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dist_strategy_auto(mesh, rng):
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr

    n = 32 * 8
    rows = np.repeat(np.arange(n), 3)
    cols = (rows + np.tile(np.arange(3), n)) % n
    banded = csr_to_bsr(CSR.from_coo(rows, cols, None, (n, n)), 8)
    d = rng.standard_normal((n, 8)).astype(np.float32)
    run = dist_bsr_spmm_plan(banded, mesh=mesh, strategy="auto")
    assert_allclose(np.asarray(run(d)), banded.to_dense() @ d)

    scattered = random_bsr(0.2, 16, 16, block_size=8, seed=4)
    d2 = rng.standard_normal((scattered.shape[1], 8)).astype(np.float32)
    run2 = dist_bsr_spmm_plan(scattered, mesh=mesh, strategy="auto")
    assert_allclose(np.asarray(run2(d2)), scattered.to_dense() @ d2)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_dist_bsr_spmm_bf16(mesh, rng, strategy):
    import jax.numpy as jnp

    bsr, dense, want = _random_case(rng, b=8, nbr=16, nbc=16, f=16)
    run = dist_bsr_spmm_plan(
        bsr, mesh=mesh, strategy=strategy, dtype=jnp.bfloat16
    )
    got = np.asarray(run(dense))
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < 3e-2, rel


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_dist_bsr_spmm_lpt_balance(mesh, rng, strategy):
    """LPT balancing auto-applies on a hub-skewed matrix (one stripe owns
    nearly all blocks under contiguous partition) and the output comes
    back in caller row order."""
    from spmm_denseblock_tpu.formats.bsr import BSR

    b, nbr, nbc = 8, 16, 12
    # all blocks piled on the first 2 block-rows -> contiguous stripes
    # are maximally imbalanced on the 8-way mesh
    rows = np.repeat(np.array([0, 1], dtype=np.int32), 12)
    cols = np.tile(np.arange(12, dtype=np.int32), 2)
    blocks = rng.standard_normal((24, b, b)).astype(np.float32)
    bsr = BSR.from_parts(rows, cols, blocks, (nbr * b - 3, nbc * b - 5), b)
    dense = rng.standard_normal((bsr.shape[1], 10)).astype(np.float32)
    want = bsr.to_dense() @ dense

    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy, balance="auto")
    assert_allclose(np.asarray(run(dense)), want)

    # forced balancing also stays exact
    run_f = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy, balance=True)
    assert_allclose(np.asarray(run_f(dense)), want)

    # balanced loads: after the LPT permutation, contiguous stripes hold
    # near-equal nnzb
    from spmm_denseblock_tpu.parallel import balanced_block_row_permutation

    perm = balanced_block_row_permutation(bsr, 8)
    counts = np.bincount(rows, minlength=nbr)
    loads = np.zeros(8, dtype=int)
    rows_per = -(-nbr // 8)
    for r in range(nbr):
        loads[perm[r] // rows_per] += counts[r]
    assert loads.max() - loads.min() <= max(3, counts.max())


def test_comms_model():
    """NVLink comms-volume model: halo is O(1) in mesh size,
    allgather/ring are (n-1)/n; efficiency hits 1.0 once per-device
    compute covers the exchange; min_nnzb inverts the model."""
    from spmm_denseblock_tpu.parallel.comms import (
        comms_bytes_per_device,
        efficiency_model,
        min_nnzb_for_efficiency,
    )

    K, F = 1 << 17, 512
    ag8 = comms_bytes_per_device("allgather", 8, K, F)
    ag16 = comms_bytes_per_device("allgather", 16, K, F)
    assert ag16 > ag8  # grows toward K*F*s
    h8 = comms_bytes_per_device("halo", 8, K, F)
    h16 = comms_bytes_per_device("halo", 16, K, F)
    assert h16 < h8  # O(1) volume / n stripes
    assert comms_bytes_per_device("ring", 8, K, F) == ag8
    assert comms_bytes_per_device("allgather", 1, K, F) == 0.0

    # at the headline shape (20.6k 128^2 blocks, B = 2^17 x 512) f32
    # stripes on CUDA cores compute longer than NVLink takes to move B...
    m32 = efficiency_model("allgather", 8, 20668, 128, K, F)
    assert m32["efficiency"] == 1.0 and m32["device"] == "H100 SXM", m32
    # ...but bf16 on the tensor cores is ~15x faster, so allgather's
    # exchange dominates while halo's O(1) volume keeps it ahead
    bf = dict(itemsize=2, dtype_flops="bf16")
    m = efficiency_model("allgather", 8, 20668, 128, K, F, **bf)
    assert m["efficiency"] < 0.5, m
    mh = efficiency_model("halo", 8, 20668, 128, K, F, **bf)
    assert mh["efficiency"] > 3 * m["efficiency"], (mh, m)
    # and allgather recovers the target once the graph is dense enough
    need = min_nnzb_for_efficiency("allgather", 8, 128, K, F, **bf)
    assert 20668 < need < 500_000, need
    big = efficiency_model("allgather", 8, need, 128, K, F, **bf)
    assert big["efficiency"] >= 0.8, big
    # the model is keyed by device_kind: an unknown card is an error
    with pytest.raises(KeyError, match="device_kind"):
        efficiency_model("halo", 8, 20668, 128, K, F, device_kind="not a card")


def test_dist_csr_ell_matches_segment_and_oracle(mesh, rng):
    """The scatter-free dist ELL tier (default) and the segment-sum tier
    agree with the scipy oracle on a degree-skewed valued matrix (hub
    rows put stripes in different class sets, exercising the
    cross-stripe-uniform capacity padding)."""
    csr = random_csr(0.03, 300, 200, seed=5)
    # graft two hub rows so class sets differ per stripe
    s = csr.to_scipy().tolil()
    s[0, :150] = 1.5
    s[299, ::2] = -0.5
    from spmm_denseblock_tpu.formats.csr import CSR

    csr = CSR.from_scipy(s.tocsr())
    dense = rng.standard_normal((200, 17)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    for impl in ("ell", "segment"):
        run = dist_csr_spmm_plan(csr, mesh=mesh, impl=impl)
        assert_allclose(np.asarray(run(dense)), want)


def test_dist_csr_ell_compact_matches_oracle(mesh, rng):
    """compact="force" (per-stripe-chunk two-level gathers, uniform
    cross-stripe unique capacities) matches the oracle — valued and
    pattern-only matrices, plus the layout invariants: compacted chunks
    carry positive u, local indices address the uniq slice, pad uniq
    slots hold the zero-row id."""
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.parallel.spmm import _ell_layout_stripes

    for valued in (True, False):
        csr = random_csr(0.04, 280, 190, seed=9)
        if not valued:
            csr = CSR(indptr=csr.indptr, indices=csr.indices, data=None,
                      shape=csr.shape)
        dense = rng.standard_normal((190, 9)).astype(np.float32)
        want = spmm_scipy(csr, dense)
        run = dist_csr_spmm_plan(csr, mesh=mesh, compact="force",
                                 compact_slots=128)
        assert_allclose(np.asarray(run(dense)), want)

    n = 8
    idx, _, _, layout, _, uniq = _ell_layout_stripes(
        csr, n, "force", 128
    )
    assert any(u > 0 for _, _, u in layout)
    assert uniq.shape[0] == n and uniq.max() <= csr.n_cols
    off = uoff = 0
    for m, K, u in layout:
        if u:
            local = idx[:, off: off + m * K]
            assert local.max() < u
            uoff += u
        off += m * K
    assert uoff == uniq.shape[1]
    # "auto" on a tiny table never compacts (full table already fast)
    _, _, _, layout_auto, _, _ = _ell_layout_stripes(csr, n, "auto")
    assert all(u == 0 for _, _, u in layout_auto)


def test_dist_csr_ell_bf16_gather(mesh, rng):
    """dtype=bf16 casts B before the all_gather (halves link + gather
    bytes); f32 accumulate keeps rel err ~1e-3 — outside the 1e-4 oracle
    gate, so it is opt-in (mirrors ops/csr_spmm_ell.py)."""
    import jax.numpy as jnp

    csr = random_csr(0.05, 256, 192, seed=9)
    dense = rng.standard_normal((192, 16)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    run = dist_csr_spmm_plan(csr, mesh=mesh, dtype=jnp.bfloat16)
    got = np.asarray(run(dense))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0 < rel < 5e-3, rel


def test_dist_csr_ell_int8_gather(mesh, rng):
    """dtype=int8 quantizes B once globally (per-column symmetric
    scales, calibrated or dynamic) — the all_gather and HBM gathers
    move int8 (4x fewer link bytes than f32). Quantization-noise tolerance;
    valued + pattern layouts."""
    import jax.numpy as jnp

    for values in ("random", "ones"):
        csr = random_csr(0.05, 256, 192, seed=9, values=values)
        dense = rng.standard_normal((192, 16)).astype(np.float32)
        cal = rng.standard_normal((1600, 16)).astype(np.float32)
        want = spmm_scipy(csr, dense)
        for calib in (None, cal):
            run = dist_csr_spmm_plan(csr, mesh=mesh, dtype=jnp.int8,
                                     calibration=calib)
            got = np.asarray(run(dense))
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert 0 < rel < 2e-2, (values, calib is None, rel)


def test_dist_hybrid_bf16_remainder(mesh, rng):
    """dist hybrid forwards dtype to both the dense stripes and the ELL
    remainder."""
    import jax.numpy as jnp

    from spmm_denseblock_tpu.convert.divide import divide
    from spmm_denseblock_tpu.parallel.spmm import dist_hybrid_spmm_plan

    csr = random_csr(0.05, 256, 256, seed=3)
    hyb = divide(csr, 16, 0.05)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0
    dense = rng.standard_normal((256, 16)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    run = dist_hybrid_spmm_plan(hyb, mesh=mesh, dtype=jnp.bfloat16)
    got = np.asarray(run(dense))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-3, rel


def test_dist_plans_are_plan_pytrees_no_hlo_constants(mesh, rng):
    """Every dist plan is a Plan pytree; passed as a jit argument, its
    sharded arrays enter the program as PARAMETERS, not constants — the
    GB-scale property (ops/plan.py) extended to the distributed layer."""
    import jax.numpy as jnp

    from spmm_denseblock_tpu.ops.plan import Plan
    from spmm_denseblock_tpu.parallel.spmm import dist_hybrid_spmm_plan
    from spmm_denseblock_tpu.convert.divide import divide

    csr = random_csr(0.05, 256, 256, seed=3)
    hyb = divide(csr, 16, 0.05)
    bsr = csr_to_bsr(csr, 16)
    plans = {
        "bsr_allgather": dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="allgather"),
        "bsr_ring": dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="ring"),
        "csr_ell": dist_csr_spmm_plan(csr, mesh=mesh),
        "csr_segment": dist_csr_spmm_plan(csr, mesh=mesh, impl="segment"),
        "hybrid": dist_hybrid_spmm_plan(hyb, mesh=mesh),
    }
    x = jnp.asarray(rng.standard_normal((256, 16)).astype(np.float32))
    want = spmm_scipy(csr, x)
    for name, plan in plans.items():
        assert isinstance(plan, Plan), name
        lowered = jax.jit(lambda p, v: p(v)).lower(plan, x).as_text()
        entry = next(
            l for l in lowered.splitlines() if "func.func public @main" in l
        )
        # the largest plan leaf must be an entry parameter, not a constant
        leaves = jax.tree.leaves(plan)
        big = max(leaves, key=lambda a: a.size)
        shape_str = "x".join(map(str, big.shape))
        assert shape_str in entry, (name, shape_str, entry)
        # and passing through jit computes the right thing
        got = np.asarray(jax.jit(lambda p, v: p(v))(plan, x))
        assert_allclose(got, want)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_dist_bsr_spmm_int8(mesh, rng, strategy):
    """dtype=int8 on the dist BSR tier: per-block quantized A (plan
    time) x one global per-column operand quantization; every
    collective moves int8. Quantization-noise tolerance (~1e-2), with
    and without plan-time calibration scales."""
    import jax.numpy as jnp

    bsr, dense, want = _random_case(rng, b=8, nbr=16, nbc=16, f=16)
    cal = rng.standard_normal((400, 16)).astype(np.float32)
    for calib in (None, cal):
        run = dist_bsr_spmm_plan(
            bsr, mesh=mesh, strategy=strategy, dtype=jnp.int8,
            calibration=calib,
        )
        got = np.asarray(run(dense))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert 0 < rel < 3e-2, (strategy, calib is None, rel)


def test_dist_bsr_spmm_int8_halo(mesh, rng):
    """int8 on the halo strategy: the O(1) neighbor exchange moves int8
    chunks (banded fixture from test_dist_bsr_spmm_halo)."""
    import jax.numpy as jnp

    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr

    n = 32 * 8
    rows = np.repeat(np.arange(n), 5)
    cols = (rows + np.tile(np.arange(-2 * 8, -2 * 8 + 5), n)) % n
    banded = CSR.from_coo(rows, cols, None, (n, n))
    bsr = csr_to_bsr(banded, 8)
    dense = rng.standard_normal((n, 12)).astype(np.float32)
    want = spmm_scipy(banded, dense)
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="halo",
                             dtype=jnp.int8)
    got = np.asarray(run(dense))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0 < rel < 3e-2, rel


def test_dist_windowed_int8(mesh, rng):
    """int8 dist windowed: per-(tile,slot) quantized tiles, one global
    operand quantization, int8 all_gather; the int8 remainder rides the
    dist ELL tier under the same calibration."""
    import jax.numpy as jnp

    from spmm_denseblock_tpu.formats.windowed import divide_windowed
    from spmm_denseblock_tpu.parallel.spmm import dist_windowed_spmm_plan

    csr = random_csr(0.05, 256, 256, seed=3)
    wt = divide_windowed(csr, tile_rows=16, window=32)
    dense = rng.standard_normal((256, 16)).astype(np.float32)
    cal = rng.standard_normal((1600, 16)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    for calib in (None, cal):
        run = dist_windowed_spmm_plan(wt, mesh=mesh, dtype=jnp.int8,
                                      calibration=calib)
        got = np.asarray(run(dense))
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert 0 < rel < 3e-2, (calib is None, rel)


def test_dist_hybrid_int8(mesh, rng):
    """dist hybrid forwards dtype=int8 + calibration to both parts."""
    import jax.numpy as jnp

    from spmm_denseblock_tpu.convert.divide import divide
    from spmm_denseblock_tpu.parallel.spmm import dist_hybrid_spmm_plan

    csr = random_csr(0.05, 256, 256, seed=3)
    hyb = divide(csr, 16, 0.05)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0
    dense = rng.standard_normal((256, 16)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    run = dist_hybrid_spmm_plan(hyb, mesh=mesh, dtype=jnp.int8)
    got = np.asarray(run(dense))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0 < rel < 3e-2, rel


def test_dist_int8_rejects_mismatched_calibration(mesh, rng):
    """calibration= without dtype=int8 is a contract error on every
    dist tier that accepts it (mirrors the single-chip tiers)."""
    bsr, _, _ = _random_case(rng, b=8, nbr=16, nbc=16, f=16)
    cal = rng.standard_normal((10, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="calibration"):
        dist_bsr_spmm_plan(bsr, mesh=mesh, calibration=cal)


def test_balanced_contiguous_halo(mesh, rng):
    """Contiguous equal-load stripes keep a banded-but-imbalanced
    matrix halo-eligible (LPT would scatter rows and lose the O(1)
    exchange): boundaries balance nnzb, bucket_halo still succeeds at
    variable boundaries, and the end-to-end plan is oracle-exact."""
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
    from spmm_denseblock_tpu.parallel.shard import (
        balanced_contiguous_boundaries,
        bucket_halo,
        shard_bsr,
    )

    # banded adjacency with a density gradient: early rows carry 8
    # neighbors, late rows 2 -> contiguous uniform stripes are ~2.4x
    # imbalanced, but the band (|col-row| <= 8) stays narrow everywhere
    n = 64 * 8
    rows_l, cols_l = [], []
    for r in range(n):
        k = 8 if r < n // 3 else (4 if r < 2 * n // 3 else 2)
        for j in range(k):
            rows_l.append(r)
            cols_l.append(min(n - 1, max(0, r - 4 + j)))
    csr = CSR.from_coo(np.array(rows_l), np.array(cols_l), None, (n, n))
    bsr = csr_to_bsr(csr, 8)

    bounds = balanced_contiguous_boundaries(bsr, 8)
    assert bounds[0] == 0 and bounds[-1] == bsr.n_block_rows
    assert (np.diff(bounds) > 0).all()
    sh = shard_bsr(bsr, 8, boundaries=bounds)
    # balanced: stripe loads within ~30% of each other
    per = np.asarray(sh.nnzb_per_shard, dtype=np.float64)
    assert per.max() / per.mean() < 1.3, per.tolist()
    # still halo-eligible at the variable boundaries
    assert bucket_halo(sh, 1) is not None

    dense = rng.standard_normal((n, 12)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    for bal in ("contiguous", "auto"):
        run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="halo",
                                 balance=bal)
        assert_allclose(np.asarray(run(dense)), want)
    # auto strategy takes the same path (banded + imbalanced)
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="auto")
    assert_allclose(np.asarray(run(dense)), want)


def test_balanced_contiguous_halo_int8(mesh, rng):
    """int8 composes with the contiguous-balanced halo path."""
    import jax.numpy as jnp

    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr

    n = 64 * 8
    rows_l, cols_l = [], []
    for r in range(n):
        k = 8 if r < n // 3 else 2
        for j in range(k):
            rows_l.append(r)
            cols_l.append(min(n - 1, max(0, r - 4 + j)))
    csr = CSR.from_coo(np.array(rows_l), np.array(cols_l), None, (n, n))
    bsr = csr_to_bsr(csr, 8)
    dense = rng.standard_normal((n, 12)).astype(np.float32)
    want = spmm_scipy(csr, dense)
    run = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy="halo",
                             balance="contiguous", dtype=jnp.int8)
    got = np.asarray(run(dense))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert 0 < rel < 3e-2, rel


def test_index_payload_pipeline_bitwise(rng):
    """The metadata-only plan path (shard/bucket on an index payload,
    values gathered once at the end) produces BITWISE the layout and
    values of the value-mode pipeline at every stage."""
    from spmm_denseblock_tpu.formats.bsr import BSR
    from spmm_denseblock_tpu.parallel.shard import (
        block_index_payload,
        bucket_by_col_chunk,
        bucket_halo,
        materialize_packed,
        shard_bsr,
    )

    bsr = random_bsr(2e-2, 48, 48, block_size=8, seed=3)
    pay = block_index_payload(bsr.nnzb)
    blocks = np.asarray(bsr.blocks[: bsr.nnzb])
    shv = shard_bsr(bsr, 4)
    shp = shard_bsr(bsr, 4, payload=pay)
    assert np.array_equal(shv.local_rows, shp.local_rows)
    assert np.array_equal(shv.block_cols, shp.block_cols)
    assert np.array_equal(
        shv.blocks, materialize_packed(shp.blocks, blocks)
    )
    lv = bucket_by_col_chunk(shv)
    lp = bucket_by_col_chunk(shp)
    assert np.array_equal(lv[0], lp[0])
    assert np.array_equal(lv[1], lp[1])
    assert np.array_equal(lv[2], materialize_packed(lp[2], blocks))

    # halo buckets on a banded fixture agree too (eligibility + layout)
    n_br, b = 48, 8
    rows_b = np.repeat(np.arange(n_br), 3)
    cols_b = np.clip(
        np.arange(n_br)[:, None] + np.array([-1, 0, 1]), 0, n_br - 1
    ).reshape(-1)
    vals = rng.standard_normal((rows_b.size, b, b)).astype(np.float32)
    band = BSR.from_parts(
        rows_b.astype(np.int32), cols_b.astype(np.int32), vals,
        (n_br * b, n_br * b), b,
    )
    pay2 = block_index_payload(band.nnzb)
    blocks2 = np.asarray(band.blocks[: band.nnzb])
    hv = bucket_halo(shard_bsr(band, 8), 1)
    hp = bucket_halo(shard_bsr(band, 8, payload=pay2), 1)
    assert (hv is None) == (hp is None) and hv is not None
    assert np.array_equal(hv[0], hp[0])
    assert np.array_equal(hv[1], hp[1])
    assert np.array_equal(hv[2], materialize_packed(hp[2], blocks2))
