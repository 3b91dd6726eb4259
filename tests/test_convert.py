import numpy as np
import scipy.sparse as sp

from spmm_denseblock_tpu.formats import CSR, random_csr
from spmm_denseblock_tpu.convert import csr_to_bsr, bsr_to_csr, divide, repack_bsr


def _rand_csr(n=200, m=160, density=0.03, seed=0):
    mat = sp.random(n, m, density=density, random_state=seed, format="csr")
    return CSR.from_scipy(mat)


def test_csr_to_bsr_exact():
    csr = _rand_csr()
    for b in (4, 16, 32):
        bsr = csr_to_bsr(csr, b)
        np.testing.assert_allclose(bsr.to_dense(), csr.to_dense(), rtol=1e-6)


def test_csr_to_bsr_nnzb_matches_scipy():
    csr = _rand_csr(seed=1)
    b = 8
    bsr = csr_to_bsr(csr, b)
    ref = csr.to_scipy().tobsr(blocksize=(b, b))
    ref.eliminate_zeros()
    # scipy keeps zero-filled blocks unless eliminated; compare counts of
    # truly-nonzero blocks (the cusparseXcsr2bsrNnz semantic).
    ref_nnzb = sum(1 for k in range(ref.indptr[-1]) if np.any(ref.data[k]))
    assert bsr.nnzb == ref_nnzb


def test_bsr_csr_roundtrip_nnz_accounting():
    csr = _rand_csr(seed=2)
    b = 4
    bsr = csr_to_bsr(csr, b)
    back = bsr_to_csr(bsr)
    # cusparseSbsr2csr keeps nnz = nnzb*b^2 including zero fill
    # (/root/reference/bsr2csr.cu round-trip driver)
    assert back.nnz == bsr.nnzb * b * b - _clipped(bsr)
    np.testing.assert_allclose(back.to_dense(), csr.to_dense(), atol=1e-6)


def _clipped(bsr):
    """cells of edge blocks that padded past the logical shape"""
    b = bsr.b
    rows = np.asarray(bsr.block_rows[: bsr.nnzb])
    cols = np.asarray(bsr.block_cols[: bsr.nnzb])
    r_over = np.maximum(0, (rows + 1) * b - bsr.shape[0])
    c_over = np.maximum(0, (cols + 1) * b - bsr.shape[1])
    return int(np.sum(b * b - (b - r_over) * (b - c_over)))


def test_divide_partition_is_exact():
    csr = random_csr(0.02, 256, seed=11)
    for density in (0.0, 0.1, 0.5, 1.1):
        hyb = divide(csr, 16, density)
        np.testing.assert_allclose(hyb.to_dense(), csr.to_dense(), atol=1e-6)
    # threshold 0.0 -> everything dense; > 1 -> everything remainder
    assert divide(csr, 16, 0.0).remainder.nnz == 0
    assert divide(csr, 16, 1.1).dense.nnzb == 0


def test_divide_threshold_semantics():
    # one fully dense 4x4 block + one single-entry block
    dense = np.zeros((8, 8), np.float32)
    dense[:4, :4] = 1.0
    dense[5, 5] = 1.0
    csr = CSR.from_scipy(sp.csr_matrix(dense))
    hyb = divide(csr, 4, density=0.5)
    assert hyb.dense.nnzb == 1  # only the full block passes >= 0.5
    assert hyb.remainder.nnz == 1


def test_repack_bsr_exact():
    csr = _rand_csr(seed=3)
    small = csr_to_bsr(csr, 8)
    big = repack_bsr(small, 32)
    assert big.b == 32
    np.testing.assert_allclose(big.to_dense(), csr.to_dense(), rtol=1e-6)
    assert big.nnzb <= small.nnzb


def test_device_csr_to_bsr_matches_host(rng):
    """On-device conversion (cuSPARSE two-phase analog) vs the host
    converter, same padded-BSR contract."""
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
    from spmm_denseblock_tpu.ops.device_convert import (
        count_nnzb_device,
        csr_to_bsr_on_device,
    )
    import numpy as np
    import jax.numpy as jnp

    csr = random_csr(0.03, 100, 90, seed=8)
    host = csr_to_bsr(csr, 16)
    nbc = -(-csr.shape[1] // 16)
    nnzb_dev = int(
        count_nnzb_device(
            jnp.asarray(csr.row_ids()),
            jnp.asarray(np.asarray(csr.indices, np.int32)),
            nbc,
            16,
        )
    )
    assert nnzb_dev == host.nnzb
    dev = csr_to_bsr_on_device(csr, 16)
    assert dev.nnzb == host.nnzb
    np.testing.assert_allclose(dev.to_dense(), host.to_dense(), atol=1e-6)

    # overfull capacity keeps the result intact (padding parked on last row)
    dev2 = csr_to_bsr_on_device(csr, 16, nnzb_max=host.nnzb + 7)
    np.testing.assert_allclose(dev2.to_dense(), host.to_dense(), atol=1e-6)


def test_device_csr_to_bsr_feeds_spmm(rng):
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.ops.device_convert import csr_to_bsr_on_device
    from spmm_denseblock_tpu.ops import bsr_spmm_xla_plan, spmm_scipy, assert_allclose
    import numpy as np

    csr = random_csr(0.05, 64, 64, seed=2)
    bsr = csr_to_bsr_on_device(csr, 8)
    x = rng.standard_normal((64, 12)).astype(np.float32)
    assert_allclose(np.asarray(bsr_spmm_xla_plan(bsr)(x)), spmm_scipy(csr, x))


def test_auto_threshold_and_repack_dispatch(rng):
    """Analytics-driven hybrid threshold + small-b supertile repack."""
    import numpy as np
    from spmm_denseblock_tpu.convert import auto_threshold, divide
    from spmm_denseblock_tpu.formats.csr import random_csr, CSR
    from spmm_denseblock_tpu.formats.bsr import random_bsr
    from spmm_denseblock_tpu.ops import spmm_plan, spmm_scipy, assert_allclose

    # dense diagonal band -> threshold should admit dense blocks
    n, b = 64, 8
    rows = np.repeat(np.arange(n), 5)
    cols = (rows + np.tile(np.arange(5), n)) % n
    banded = CSR.from_coo(rows, cols, None, (n, n))
    thr = auto_threshold(banded, b)
    assert 0 < thr <= 1
    hyb = divide(banded, b, thr)
    assert hyb.dense.nnzb > 0

    # sparse uniform graph at b=128 -> everything CSR
    sparse = random_csr(0.001, 256, seed=3, values="ones")
    assert auto_threshold(sparse, 128) == 1.0

    # repack_to: small-b BSR through the big-tile path, oracle-checked
    small = random_bsr(0.15, 16, 16, block_size=8, seed=5)
    x = rng.standard_normal((small.shape[1], 16)).astype(np.float32)
    plan = spmm_plan(small, impl="bsr_xla", repack_to=32)
    want = small.to_dense() @ x
    assert_allclose(np.asarray(plan(x)), want)


def test_device_convert_huge_block_grid_no_overflow():
    """Regression: a fused int32 brow*nbc+bcol key wraps once the block
    grid exceeds 2^31 cells and silently merges distinct blocks; the
    two-pass sort must count and place them exactly."""
    import jax.numpy as jnp
    import numpy as np
    from spmm_denseblock_tpu.ops.device_convert import (
        count_nnzb_device,
        csr_to_bsr_device,
    )

    b = 16
    nbc = 2**20  # grid cells = nbr * nbc >> 2^31 for nbr ~ 2^20
    # two elements in DIFFERENT blocks whose fused int32 keys collide:
    # (brow=2^11, bcol=0) vs (brow=0, bcol=0) differ by 2^11 * 2^20 = 2^31
    row_ids = jnp.asarray([0, (2**11) * b], jnp.int32)
    col_ids = jnp.asarray([0, 0], jnp.int32)
    assert int(count_nnzb_device(row_ids, col_ids, nbc, b)) == 2

    brows, bcols, blocks, nnzb = csr_to_bsr_device(
        row_ids, col_ids, None, 2**20, nbc, b, 4
    )
    assert int(nnzb) == 2
    placed = sorted(
        (int(r), int(c))
        for r, c, blk in zip(brows, bcols, blocks)
        if float(jnp.sum(blk)) > 0
    )
    assert placed == [(0, 0), (2**11, 0)]
    np.testing.assert_array_equal(np.asarray(blocks[:2, 0, 0]), [1.0, 1.0])


def test_device_convert_empty_matrix():
    import jax.numpy as jnp
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.ops.device_convert import count_nnzb_device

    empty = CSR.from_coo([], [], None, (16, 16))
    n = int(
        count_nnzb_device(
            jnp.asarray(empty.row_ids()), jnp.asarray(empty.indices), 2, 8
        )
    )
    assert n == 0


def test_pad_dense_rows():
    import numpy as np
    from spmm_denseblock_tpu.convert import pad_dense_rows

    x = np.ones((5, 3), np.float32)
    y = pad_dense_rows(x, 8)
    assert y.shape == (8, 3) and y[5:].sum() == 0
    assert pad_dense_rows(x, 5) is x


def test_score_thresholds_dense_structure(rng):
    """A graph with genuinely dense blocks + a sparse tail must pick a
    threshold; a uniform low-degree graph must return None (pure ELL)."""
    import numpy as np

    from spmm_denseblock_tpu.convert.divide import (
        ell_padded_slots,
        score_thresholds,
    )
    from spmm_denseblock_tpu.formats.csr import CSR, random_csr

    b, nb = 16, 32
    n = b * nb
    # 8 fully dense diagonal blocks + uniform sparse background
    rr, cc = np.meshgrid(np.arange(b), np.arange(b), indexing="ij")
    rows = [(rr + i * b).ravel() for i in range(8)]
    cols = [(cc + i * b).ravel() for i in range(8)]
    bg = random_csr(0.01, n, n, seed=5, values="ones")
    rows.append(bg.row_ids())
    cols.append(np.asarray(bg.indices))
    dense_csr = CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), None, (n, n)
    )
    thr, report = score_thresholds(dense_csr, b, slots_per_block=64.0)
    assert thr is not None
    by_thr = {r["thr"]: r for r in report}
    assert by_thr[thr]["nnzb"] >= 8

    uniform = random_csr(0.005, n, n, seed=6, values="ones")
    thr_u, _ = score_thresholds(uniform, b)
    assert thr_u is None

    # padded-slot arithmetic: zeros drop out; default quarter buckets
    # pad to multiples of next_pow2/4 (3->3, 5->6, 9->12), pow2 to the
    # full power of two
    deg = np.array([0, 1, 2, 3, 5, 9])
    assert ell_padded_slots(deg, bucket="pow2") == 1 + 2 + 4 + 8 + 16
    assert ell_padded_slots(deg) == 1 + 2 + 3 + 6 + 12


def test_score_thresholds_budget(rng):
    """Candidates whose dense part exceeds the byte budget are skipped."""
    import numpy as np

    from spmm_denseblock_tpu.convert.divide import score_thresholds
    from spmm_denseblock_tpu.formats.csr import random_csr

    csr = random_csr(0.3, 256, 256, seed=7, values="ones")
    thr, report = score_thresholds(csr, 16, dense_bytes_budget=0)
    assert thr is None
    assert all(r["score"] is None for r in report if r["thr"] is not None)
