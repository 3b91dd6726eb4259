"""Plan: a callable pytree of (device arrays, apply function).

A plan built as a plain Python closure re-embeds its captured device
arrays as HLO *constants* whenever an OUTER jit traces through it — e.g.
a training step calling plan(x) inside jax.jit. Constants are
serialized into the program, which caps training at ~100s-of-MB sparse
operands.

The fix is structural: a plan IS a pytree whose leaves are its device
arrays and whose treedef carries the apply function + static config. A
jitted step then takes the plan as an ARGUMENT —

    @jax.jit
    def step(plan, params, x): ... plan(x) ...

— so XLA sees the arrays as runtime parameters (zero-copy, donatable),
never as constants, and GB-scale operands train fine. Calling a Plan
directly (`plan(x)`) still works exactly like the old closures, so
nothing downstream changes.

Plans nest: a composed executor (hybrid = dense-block part + CSR tail,
chunked = sum of row-band fragments) is a Plan whose children are
sub-Plans. jit cache keys include the treedef, i.e. (apply_fn, statics,
child structure) — module-level apply functions keep retraces shared
across plans of the same family.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class Plan:
    """Callable pytree executor: apply_fn(statics, arrays, dense)."""

    def __init__(self, arrays: Any, apply_fn: Callable, statics: Tuple = ()):
        self.arrays = arrays
        self.apply_fn = apply_fn
        self.statics = statics

    def __call__(self, dense):
        return self.apply_fn(self.statics, self.arrays, dense)

    def tree_flatten(self):
        return (self.arrays,), (self.apply_fn, self.statics)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])

    def __repr__(self):
        name = getattr(self.apply_fn, "__name__", "apply")
        return f"Plan({name}, statics={self.statics!r})"


@functools.partial(jax.jit, static_argnames="statics")
def _sum_apply(statics, plans, dense):
    """Sum of sub-plan outputs (chunked executors: partial row sums add).

    Jitted at THIS level: the eager form paid one dispatch per sub-plan
    plus eager adds. One program also lets XLA's buffer assignment reuse the partial
    temporaries (the _ell_banded_device lesson: sum-of-two-subplans kept
    four (n, F) buffers alive across program boundaries). The plans
    tuple is a jit ARGUMENT (Plan is a pytree), so sub-plan arrays stay
    runtime parameters, never HLO constants."""
    dense = jnp.asarray(dense)
    out = plans[0](dense)
    for p in plans[1:]:
        out = out + p(dense)
    return out


def sum_plan(plans) -> Plan:
    return Plan(tuple(plans), _sum_apply)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _vjp_apply(statics, fwd_plan, bwd_plan, dense):
    return fwd_plan(dense)


def _vjp_fwd(statics, fwd_plan, bwd_plan, dense):
    proto = jnp.zeros((0,), jnp.asarray(dense).dtype)
    return fwd_plan(dense), (fwd_plan, bwd_plan, proto)


def _zero_cotangent(x):
    # integer/bool leaves take float0 cotangents (JAX's tangent type for
    # non-differentiable arrays); float leaves get DCE-able zeros
    import numpy as np

    if jnp.issubdtype(jnp.asarray(x).dtype, jnp.inexact):
        return jnp.zeros_like(x)
    return np.zeros(jnp.shape(x), jax.dtypes.float0)


def _vjp_bwd(statics, res, g):
    fwd_plan, bwd_plan, proto = res
    # plan arrays are constants of the computation: zero cotangents
    # (XLA DCEs them — they are never consumed by an optimizer)
    zf = jax.tree.map(_zero_cotangent, fwd_plan)
    zb = jax.tree.map(_zero_cotangent, bwd_plan)
    return zf, zb, bwd_plan(g).astype(proto.dtype)


_vjp_apply.defvjp(_vjp_fwd, _vjp_bwd)


@functools.partial(jax.jit, static_argnames="statics")
def _grad_apply(statics, plans, dense):
    fwd_plan, bwd_plan = plans
    return _vjp_apply((), fwd_plan, bwd_plan, dense)


def grad_plan(fwd_plan: Plan, bwd_plan: Plan) -> Plan:
    """Differentiable plan: dC/dB flows as A^T @ g through bwd_plan
    (the same kernel family on the transposed layout)."""
    return Plan((fwd_plan, bwd_plan), _grad_apply)


@functools.partial(jax.jit, static_argnames="statics")
def _transb_apply(statics, plans, dense_t):
    (inner,) = plans
    return inner(jnp.asarray(dense_t).T)


def transb_plan(inner: Plan) -> Plan:
    """Column-major operand entry: the returned plan takes B^T of shape
    (F, K) and computes the same C = A @ B, with the transpose fused
    into the jitted program (never materialized on the host).

    This is the reference's transB axis (test_bsrmm.cu sweeps
    transB in {0,1} with cusparse op(B)) as a first-class entry point.
    Its cost against row-major entry is not yet measured on the H100.
    Autodiff flows through (the cotangent of B^T is the transposed
    cotangent of B)."""
    return Plan((inner,), _transb_apply)
