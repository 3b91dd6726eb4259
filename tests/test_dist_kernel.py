"""The distributed BSR plans with the Pallas kernel in their stripes, as
they run on a GPU: here the kernel runs in interpret mode on the
8-device CPU mesh (parallel.spmm.on_gpu is patched to say "GPU"; the
kernel's own backend check still picks the interpreter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmm_denseblock_tpu.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu.ops.reference import assert_allclose
from spmm_denseblock_tpu.parallel import dist_bsr_spmm_plan, make_mesh_1d
from spmm_denseblock_tpu.parallel import spmm as dist


@pytest.fixture
def kernel_stripes(monkeypatch):
    monkeypatch.setattr(dist, "on_gpu", lambda: True)


def _banded(nbr, b, seed):
    rows = np.repeat(np.arange(nbr), 3)
    cols = np.clip(rows + np.tile([-1, 0, 1], nbr), 0, nbr - 1)
    key = np.unique(rows * nbr + cols)
    blocks = np.random.default_rng(seed).standard_normal(
        (key.size, b, b)).astype(np.float32)
    return BSR.from_parts((key // nbr).astype(np.int32),
                          (key % nbr).astype(np.int32), blocks,
                          (nbr * b, nbr * b), b)


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _stripes(plan):
    """The (fwd) inner plan of a possibly wrapped distributed plan."""
    while not plan.statics:
        plan = plan.arrays[0]
    return plan


@pytest.mark.parametrize("dtype", [None, "int8"])
@pytest.mark.parametrize("strategy", ["allgather", "ring", "halo"])
def test_kernel_stripes_match_dense(kernel_stripes, strategy, dtype):
    """b=8 is repacked to the kernel's 16 (32 for int8) before sharding;
    13 block-rows do not divide the mesh."""
    mesh = make_mesh_1d(4)
    bsr = (_banded(13, 8, seed=1) if strategy == "halo"
           else random_bsr(0.3, 13, 11, block_size=8, seed=3))
    x = np.random.default_rng(0).standard_normal(
        (bsr.shape[1], 20)).astype(np.float32)
    want = bsr.to_dense().astype(np.float64) @ x
    plan = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy, dtype=dtype,
                              calibration=x if dtype else None)
    inner = _stripes(plan)
    assert inner.statics[0] == strategy
    assert inner.statics[1][-1] is True  # the kernel, interpreted
    got = plan(x)
    assert got.shape == want.shape
    if dtype is None:
        assert_allclose(np.asarray(got), want)
    else:
        assert _rel(got, want) < 5e-2


def test_kernel_stripes_skip_padding_blocks():
    """Row pointers cover the real blocks only: the padding that evens
    out the stripes' lists lies past the last row's extent."""
    from spmm_denseblock_tpu.parallel.shard import block_index_payload

    bsr = random_bsr(0.3, 8, 8, block_size=16, seed=5)
    sh = dist.shard_bsr(bsr, 4, payload=block_index_payload(bsr.nnzb))
    rp = dist._row_ptrs(sh.local_rows, sh.blocks, sh.rows_per_shard)
    assert rp.shape == (4, sh.rows_per_shard + 1)
    np.testing.assert_array_equal(rp[:, -1], sh.nnzb_per_shard)
    np.testing.assert_array_equal(np.diff(rp, axis=1) >= 0, True)


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
def test_kernel_stripes_gradient_matches_dense(kernel_stripes, strategy):
    """The kernel has no autodiff rule of its own: the plan's custom VJP
    runs a second distributed plan on A^T. Non-symmetric A."""
    mesh = make_mesh_1d(4)
    bsr = random_bsr(0.4, 6, 5, block_size=16, seed=8)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(
        (bsr.shape[1], 16)).astype(np.float32))
    a = jnp.asarray(bsr.to_dense())
    assert not np.allclose(bsr.to_dense()[:80, :80], bsr.to_dense()[:80, :80].T)
    plan = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy)
    with jax.default_matmul_precision("highest"):
        g1 = jax.grad(lambda v: jnp.sum(jnp.sin(plan(v))))(x)
        g2 = jax.grad(lambda v: jnp.sum(jnp.sin(a @ v)))(x)
    assert_allclose(np.asarray(g1), np.asarray(g2))


def test_kernel_stripes_reblock_odd_block_sizes(kernel_stripes):
    mesh = make_mesh_1d(4)
    bsr = random_bsr(0.3, 9, 9, block_size=12, seed=4)
    x = np.random.default_rng(2).standard_normal(
        (bsr.shape[1], 8)).astype(np.float32)
    plan = dist_bsr_spmm_plan(bsr, mesh=mesh, grad=False)
    assert _stripes(plan).statics[1][6] == 16  # b, re-blocked
    assert_allclose(np.asarray(plan(x)), bsr.to_dense() @ x)


def test_xla_stripes_off_the_gpu():
    """Without a GPU the stripes run XLA's plain form and need no VJP
    wrapper (it differentiates natively)."""
    bsr = random_bsr(0.3, 8, 8, block_size=8, seed=6)
    plan = dist_bsr_spmm_plan(bsr, mesh=make_mesh_1d(4))
    assert plan.statics[0] == "allgather" and plan.statics[1][-1] is None
