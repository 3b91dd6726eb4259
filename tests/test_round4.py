"""Regression pins: dtype casts before collectives, jitted applies, and
the harness fields.

- ring/halo dist plans must move the CASTED operand over the links
  (a bf16 ring that ppermuted f32 would move 2x the documented bytes —
  silent because results only got more precise). Pinned via jaxpr
  inspection.
- every plan family's apply is jitted: pytree plans whose apply_fn
  lacks __wrapped__ would mean an eager (unfused) apply.
- conformance_fields harness contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmm_denseblock_tpu.formats.bsr import random_bsr
from spmm_denseblock_tpu.formats.csr import random_csr


def _collect_eqns(jaxpr, out):
    def recurse(v):
        if hasattr(v, "eqns"):  # raw Jaxpr (e.g. shard_map's param)
            _collect_eqns(v, out)
        elif hasattr(v, "jaxpr"):  # ClosedJaxpr
            _collect_eqns(v.jaxpr, out)
        elif isinstance(v, (list, tuple)):
            for vv in v:
                recurse(vv)

    for eqn in jaxpr.eqns:
        out.append(eqn)
        for v in eqn.params.values():
            recurse(v)
    return out


@pytest.mark.parametrize("strategy", ["ring", "halo", "allgather"])
def test_dist_bf16_collective_moves_bf16(strategy):
    """The collective (ppermute / all_gather) must see bf16, not f32."""
    from spmm_denseblock_tpu.parallel import dist_bsr_spmm_plan, make_mesh_1d

    bsr = random_bsr(0.2, 16, block_size=8, seed=0)
    mesh = make_mesh_1d(2)
    plan = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy,
                              dtype=jnp.bfloat16)
    x = np.random.default_rng(0).standard_normal(
        (bsr.shape[1], 16)).astype(np.float32)
    jaxpr = jax.make_jaxpr(lambda d: plan(d))(x)
    eqns = _collect_eqns(jaxpr.jaxpr, [])
    coll = [e for e in eqns
            if e.primitive.name in ("ppermute", "all_gather")]
    assert coll, "no collective found (single-strategy fallback?)"
    for e in coll:
        for var in e.invars:
            if hasattr(var, "aval") and var.aval.dtype in (
                jnp.float32, np.float32
            ):
                raise AssertionError(
                    f"{strategy}: {e.primitive.name} moves f32 "
                    f"(2x the documented link bytes) — the dtype cast "
                    f"is missing before the collective"
                )


def test_every_plan_family_apply_is_jitted():
    """A Plan whose apply_fn lacks __wrapped__ dispatches its pre-ops
    eagerly, one launch each."""
    from spmm_denseblock_tpu.ops import spmm_plan
    from spmm_denseblock_tpu.ops.plan import Plan

    csr = random_csr(0.02, 256, seed=1)
    bsr = random_bsr(0.1, 8, block_size=32, seed=1)

    def check(plan, label):
        if isinstance(plan, Plan):
            assert hasattr(plan.apply_fn, "__wrapped__"), (
                f"{label}: apply {plan.apply_fn} is not jitted"
            )
            for child in jax.tree.leaves(
                plan.arrays, is_leaf=lambda x: isinstance(x, Plan)
            ):
                if isinstance(child, Plan):
                    check(child, label + ">child")

    for impl in ("csr_ell", "csr_xla", "csr_ell_int8",
                 "hybrid", "windowed", "windowed_int8", "csr_ell_banded"):
        check(spmm_plan(csr, impl=impl, grad=False, block_size=64),
              impl)
    for impl in ("bsr_pallas", "bsr_xla", "bsr_int8"):
        check(spmm_plan(bsr, impl=impl, grad=False), impl)
    # grad combinator
    check(spmm_plan(csr, impl="csr_ell", grad=True), "csr_ell+grad")
    from spmm_denseblock_tpu.ops.plan import transb_plan

    check(transb_plan(spmm_plan(csr, impl="csr_ell", grad=False)),
          "transb")


def test_conformance_fields_per_dtype():
    from spmm_denseblock_tpu.bench.harness import conformance_fields

    ref = np.ones((4, 4), np.float32)
    out = ref * 1.001  # 1e-3 rel err: bf16-expected, f32-failing
    bf = conformance_fields(out, ref, "bfloat16")
    f32 = conformance_fields(out, ref, "float32")
    assert bf["gate_ok"] and not f32["gate_ok"]
    assert bf["tol"] == 5e-3 and f32["tol"] == 1e-4
    i8 = conformance_fields(ref * 1.03, ref, "int8")
    assert i8["gate_ok"] and i8["tol"] == 5e-2


def test_auto_small_b_repack_routing():
    """auto must repack small-b BSR to 128-supertiles exactly when the
    two-rate score says so."""
    from spmm_denseblock_tpu.ops import spmm_plan
    from spmm_denseblock_tpu.ops.dispatch import _prefer_repack128
    from spmm_denseblock_tpu.ops.reference import spmm_scipy

    # dense small-b grid (the b=2, p=2e-2 regime): repack must win
    dense_case = random_bsr(0.02, 512, block_size=2, seed=3)
    assert _prefer_repack128(dense_case)
    # ultra-sparse small-b grid (b=2, p=2e-4 regime): direct must win
    sparse_case = random_bsr(0.0002, 2048, block_size=2, seed=3)
    assert not _prefer_repack128(sparse_case)
    # end-to-end: auto on the dense case stays oracle-exact
    x = np.random.default_rng(0).standard_normal(
        (dense_case.shape[1], 32)).astype(np.float32)
    plan = spmm_plan(dense_case, impl="auto", feat_dim=32, grad=False)
    got = np.asarray(plan(x))
    ref = spmm_scipy(dense_case, x)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err < 1e-4, err
