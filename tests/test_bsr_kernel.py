"""The Pallas (Triton) BSR kernel in interpret mode, its wrapper, its
routing, and the backend, hardware-table and compile-cache helpers it
relies on. On the card the same kernel runs compiled: chip_smoke.py."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmm_denseblock_tpu.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu.ops import (
    assert_allclose,
    bsr_spmm_pallas_plan,
    spmm_plan,
)

kernel = importlib.import_module("spmm_denseblock_tpu.ops.bsr_spmm_pallas")

REPO = Path(__file__).resolve().parents[1]


def _case(b, f, seed=0, n_block_rows=3, n_block_cols=3, p=0.5):
    bsr = random_bsr(p, n_block_rows, n_block_cols, block_size=b, seed=seed)
    x = np.random.default_rng(seed).standard_normal(
        (bsr.shape[1], f)).astype(np.float32)
    return bsr, x, bsr.to_dense().astype(np.float64) @ x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [1, 7, 128, 200])
@pytest.mark.parametrize("b", [8, 16, 32, 64, 128])
def test_kernel_matches_dense(b, f, dtype):
    """b=8 is repacked to 16 (pl.dot needs >= 16); F is padded to the
    F-tile; bf16 operands accumulate in f32."""
    bsr, x, want = _case(b, f, seed=b + f)
    plan = bsr_spmm_pallas_plan(
        bsr, grad=False, dtype=None if dtype == "float32" else dtype
    )
    got = np.asarray(plan(x))
    assert got.shape == want.shape and got.dtype == np.float32
    if dtype == "float32":
        assert_allclose(got, want, msg=f"b={b} f={f}")
    else:
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 2e-2, (b, f, rel)


def test_kernel_empty_block_rows_store_zeros():
    """Rows with no block (and a whole empty matrix) come back as exact
    zeros: each program stores its tile once, whatever its row holds."""
    b = 16
    rows = np.array([1, 1, 4], np.int32)
    cols = np.array([0, 2, 1], np.int32)
    blocks = np.random.default_rng(3).standard_normal((3, b, b)).astype(
        np.float32)
    bsr = BSR.from_parts(rows, cols, blocks, (6 * b, 3 * b), b)
    x = np.random.default_rng(4).standard_normal((3 * b, 24)).astype(
        np.float32)
    got = np.asarray(bsr_spmm_pallas_plan(bsr, grad=False)(x))
    assert_allclose(got, bsr.to_dense() @ x)
    empty_rows = [0, 2, 3, 5]
    for r in empty_rows:
        assert np.all(got[r * b:(r + 1) * b] == 0)
    none = BSR.from_parts(np.zeros(0, np.int32), np.zeros(0, np.int32),
                          np.zeros((0, b, b), np.float32), (2 * b, b), b)
    assert np.all(np.asarray(bsr_spmm_pallas_plan(none, grad=False)(
        x[:b])) == 0)


@pytest.mark.parametrize("shape", [(70, 33), (33, 70), (100, 100)])
def test_kernel_rectangular_ragged(shape):
    """Shapes that are not multiples of the block size, both ways."""
    import scipy.sparse as sp

    from spmm_denseblock_tpu.convert import csr_to_bsr
    from spmm_denseblock_tpu.formats import CSR

    a = sp.random(*shape, density=0.1, random_state=5, format="csr",
                  dtype=np.float32)
    bsr = csr_to_bsr(CSR.from_scipy(a), 16)
    x = np.random.default_rng(5).standard_normal((shape[1], 9)).astype(
        np.float32)
    got = np.asarray(bsr_spmm_pallas_plan(bsr, grad=False)(x))
    assert got.shape == (shape[0], 9)
    assert_allclose(got, a @ x)


@pytest.mark.parametrize("b", [16, 32])
def test_kernel_vjp_matches_dense_gradient(b):
    """The custom VJP runs the same kernel on the transposed layout."""
    bsr, x, _ = _case(b, 12, seed=7, n_block_rows=4, n_block_cols=3)
    plan = bsr_spmm_pallas_plan(bsr)
    a = jnp.asarray(bsr.to_dense())
    g1 = jax.grad(lambda v: jnp.sum(jnp.sin(plan(v))))(jnp.asarray(x))
    g2 = jax.grad(lambda v: jnp.sum(jnp.sin(a @ v)))(jnp.asarray(x))
    assert_allclose(g1, g2)


@pytest.mark.parametrize(
    "dtype,precision",
    [("float32", None), ("bfloat16", None), ("float32", "high"),
     ("int8", None)],
)
def test_kernel_lowers_for_cuda(dtype, precision):
    """The kernel lowers to a Triton call for the CUDA platform with no
    interpreter involved: every primitive in it has a Triton lowering
    (IEEE f32 with its K-split, bf16x3, bf16, int8)."""
    bsr = random_bsr(0.5, 4, block_size=128, seed=1)
    lay = kernel.kernel_layout(bsr)
    rows = np.asarray(lay.block_rows[: lay.nnzb])
    row_ptr = np.searchsorted(rows, np.arange(lay.n_block_rows + 1)).astype(
        np.int32)
    cols = np.asarray(lay.block_cols[: lay.nnzb], np.int32)
    blocks = np.asarray(lay.blocks[: lay.nnzb]).astype(dtype)
    dense = np.zeros((lay.n_block_cols * 128, 256), dtype)
    scales = (np.ones(blocks.shape[0], np.float32) if dtype == "int8"
              else None)
    ft, warps, stages, kc = kernel.tile_config(
        128, 256, blocks.dtype.itemsize, precision)
    lowered = kernel.bsr_spmm_triton.trace(
        row_ptr, cols, blocks, dense, scales, ft=ft, num_warps=warps,
        num_stages=stages, kc=kc, precision=precision, interpret=False,
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text.lower() and "bsr_spmm" in text


@pytest.mark.parametrize("b,f,itemsize", [
    (16, 1, 4), (128, 512, 4), (128, 512, 2), (64, 200, 2), (128, 7, 4),
])
def test_tile_config_fits_shared_memory(b, f, itemsize):
    ft, warps, stages, kc = kernel.tile_config(b, f, itemsize)
    assert ft >= 16 and ft & (ft - 1) == 0
    assert warps in (4, 8) and 1 <= stages <= 3
    assert stages * (b * b + b * ft) * itemsize <= 200 * 1024 or stages == 1
    # only IEEE f32 splits blocks along K, into a power of two >= 16
    assert b % kc == 0 and kc >= 16 and (kc == b or itemsize == 4)
    # bf16x3 takes the tiles measured best on the card (PERF.md)
    high = kernel.tile_config(b, f, itemsize, "high")
    assert high[1:] == (8, 2, b) and ft <= high[0] <= max(128, ft)


def test_kernel_layout_repacks_small_and_refuses_odd_blocks():
    small = random_bsr(0.3, 6, block_size=8, seed=2)
    lay = kernel.kernel_layout(small)
    assert lay.b == 16
    np.testing.assert_array_equal(
        lay.to_dense()[: small.shape[0], : small.shape[1]], small.to_dense())
    odd = random_bsr(0.5, 2, block_size=24, seed=2)
    with pytest.raises(ValueError, match="power-of-two"):
        bsr_spmm_pallas_plan(odd, grad=False)
    with pytest.raises(ValueError, match="precision"):
        bsr_spmm_pallas_plan(small, grad=False, precision="highest")


@pytest.mark.parametrize("b,b_new", [(12, 16), (24, 32), (32, 32)])
def test_pow2_blocks_reblocks_exactly(b, b_new):
    bsr = random_bsr(0.4, 5, 4, block_size=b, seed=b)
    lay = kernel.pow2_blocks(bsr)
    assert lay.b == b_new and lay.shape == bsr.shape
    np.testing.assert_array_equal(
        lay.to_dense()[: bsr.shape[0], : bsr.shape[1]], bsr.to_dense())


@pytest.mark.parametrize("on_card", [False, True])
def test_spmm_tune_leaves_out_bsr_xla_on_a_gpu(monkeypatch, on_card):
    from spmm_denseblock_tpu.ops import dispatch

    monkeypatch.setattr(dispatch, "auto_uses_kernel", lambda: on_card)
    bsr, x, _ = _case(16, 8, seed=2, n_block_rows=2, n_block_cols=2)
    _, report = dispatch.spmm_tune(bsr, x, block_size=16)
    assert ("bsr_xla" in report) is not on_card
    assert "bsr_pallas" in report and "csr_ell" in report


def test_auto_routes_to_bsr_xla_off_the_gpu():
    """On the CPU `auto` never picks the kernel: it would only run in
    the interpreter there."""
    assert kernel.auto_uses_kernel() is False
    bsr = random_bsr(0.3, 4, block_size=64, seed=3)
    plan = spmm_plan(bsr, impl="auto", feat_dim=512, grad=False)
    assert plan.apply_fn.__name__ == "_bsr_xla_apply"


@pytest.mark.parametrize("b", [24, 64])
def test_auto_kernel_options_on_a_gpu(monkeypatch, b):
    """On a GPU auto takes the kernel at every block size (odd sizes are
    re-blocked to a power of two), f32 at its IEEE default: bf16x3
    (precision="high") only when asked for."""
    monkeypatch.setattr(kernel, "on_gpu", lambda: True)
    assert kernel.auto_uses_kernel() is True
    bsr, x, want = _case(b, 20, seed=b, n_block_rows=3, n_block_cols=2)
    plan = spmm_plan(bsr, impl="auto", grad=False)
    assert plan.apply_fn.__name__ == "_pallas_apply"
    assert plan.statics[3] is None  # IEEE f32
    assert_allclose(np.asarray(plan(x)), want)
    from spmm_denseblock_tpu.convert import bsr_to_csr

    plan = spmm_plan(bsr_to_csr(bsr), impl="auto", block_size=b, grad=False)
    assert plan.apply_fn.__name__ == "_pallas_apply"
    assert_allclose(np.asarray(plan(x)), want)


@pytest.mark.gpu
def test_auto_serves_through_the_kernel_on_the_card():
    bsr, x, want = _case(128, 256, seed=11, n_block_rows=8, n_block_cols=8,
                         p=0.3)
    plan = spmm_plan(bsr, impl="auto", grad=False)
    assert plan.apply_fn.__name__ == "_pallas_apply"
    assert plan.statics[3] is None
    assert_allclose(np.asarray(plan(x)), want)


@pytest.mark.parametrize("impl,tier", [
    ("auto", "_int8_xla_apply"),  # off the GPU auto is XLA
    ("bsr_xla", "_int8_xla_apply"),
    ("bsr_pallas", "_pallas_apply"),  # the kernel's int8 plan
])
def test_int8_routes_to_bsr_int8(impl, tier):
    """dtype=int8 maps each BSR tier to its quantized variant."""
    bsr = random_bsr(0.3, 4, block_size=32, seed=4)
    x = np.random.default_rng(4).standard_normal(
        (bsr.shape[1], 16)).astype(np.float32)
    plan = spmm_plan(bsr, impl=impl, dtype=jnp.int8, calibration=x)
    assert plan.apply_fn.__name__ == tier
    want = bsr.to_dense() @ x
    rel = np.abs(np.asarray(plan(x)) - want).max() / np.abs(want).max()
    assert rel < 5e-2, rel


@pytest.mark.parametrize("b", [16, 32, 128])
@pytest.mark.parametrize("calibrated", [False, True])
def test_kernel_int8_matches_xla_int8(b, calibrated):
    """The kernel's int8 plan shares bsr_int8's quantization (per-block
    and per-column scales), so the two agree up to accumulation order;
    b=16 is repacked to the int8 minimum of 32."""
    from spmm_denseblock_tpu.ops import bsr_spmm_int8_plan

    bsr, x, want = _case(b, 40, seed=b, n_block_rows=4, n_block_cols=3)
    cal = x if calibrated else None
    got = np.asarray(kernel.bsr_spmm_pallas_int8_plan(bsr, calibration=cal)(x))
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert got.shape == want.shape and rel < 5e-2, rel
    if b >= 32:  # same block grid, same quantized values
        ref = np.asarray(bsr_spmm_int8_plan(bsr, calibration=cal)(x))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="inference-only"):
        kernel.bsr_spmm_pallas_int8_plan(bsr, grad=True)


def test_hybrid_int8_dense_part_is_bsr_int8():
    from spmm_denseblock_tpu.convert import divide
    from spmm_denseblock_tpu.formats import random_csr
    from spmm_denseblock_tpu.ops.plan import Plan

    csr = random_csr(0.3, 64, seed=6)
    hyb = divide(csr, 16, 0.3)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0
    plan = spmm_plan(hyb, impl="hybrid_int8")
    parts = [p.apply_fn.__name__ for p in jax.tree.leaves(
        plan.arrays, is_leaf=lambda p: isinstance(p, Plan))
        if isinstance(p, Plan)]
    assert "_int8_xla_apply" in parts, parts


def test_backend_raises_off_the_gpu_unless_interpret_asked(monkeypatch):
    from spmm_denseblock_tpu import backend

    assert backend.pallas_interpret() is True  # conftest asked for it
    monkeypatch.setitem(backend._INTERPRET, "on", False)
    with pytest.raises(RuntimeError, match="'cpu'"):
        backend.pallas_interpret()
    with pytest.raises(RuntimeError, match="set_interpret"):
        bsr_spmm_pallas_plan(random_bsr(0.5, 2, block_size=16), grad=False)


def test_hardware_table_is_keyed_by_device_kind():
    from spmm_denseblock_tpu.hardware import DEFAULT_KIND, device_spec

    h100 = device_spec(DEFAULT_KIND)
    assert h100.flops_bf16 == 989e12 and h100.hbm_bytes_per_s == 3.35e12
    assert h100.link_bytes_per_s == 450e9
    with pytest.raises(KeyError, match="device_kind"):
        device_spec("cpu")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_follows_env(env_set, monkeypatch, tmp_path):
    from spmm_denseblock_tpu.utils import compile_cache

    updates = {}
    monkeypatch.setattr(
        compile_cache.jax.config, "update",
        lambda k, v: updates.__setitem__(k, v),
    )
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert updates == {}  # JAX reads the variable itself
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = compile_cache.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert updates["jax_compilation_cache_dir"] == got
        assert ".jax_cache/" in (REPO / ".gitignore").read_text()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(alone, tmp_path):
    """On the CPU (and with no library beside it) chip_smoke.py exits
    non-zero and never prints a result."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
