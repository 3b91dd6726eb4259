"""Training loop pieces: masked node-classification loss + jitted step.

Single-chip counterpart of parallel/train.py. Everything is a pure
function of (params, opt_state, batch) so the whole step jits into one
XLA program: SpMM aggregation (Pallas/XLA), dense layers, softmax CE,
backward, and the optax update.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax

from spmm_denseblock_tpu.models.gnn import SpMM


def masked_cross_entropy(logits, labels, mask):
    """Mean softmax CE over mask (train-split nodes)."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    per_node = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    w = mask.astype(logits.dtype)
    return jnp.sum(per_node * w) / jnp.maximum(jnp.sum(w), 1.0)


def accuracy(logits, labels, mask):
    hit = (jnp.argmax(logits, axis=-1) == labels).astype(jnp.float32)
    w = mask.astype(jnp.float32)
    return jnp.sum(hit * w) / jnp.maximum(jnp.sum(w), 1.0)


def make_train_step(
    apply_fn: Callable, spmm: SpMM, optimizer: optax.GradientTransformation
):
    """Returns (step, init_state). step is jitted end-to-end.

    GB-scale note (ops/plan.py): when `spmm` is a Plan
    pytree, it enters the jitted step as an ARGUMENT, so its device
    arrays are runtime parameters — not HLO constants — and
    products-scale sparse operands train without blowing up the program
    upload. Plain-callable spmm still works (closure semantics)."""
    from spmm_denseblock_tpu.ops.plan import Plan

    def loss_fn(params, spmm_arg, x, y, mask):
        logits = apply_fn(params, spmm_arg, x)
        return masked_cross_entropy(logits, y, mask), logits

    @jax.jit
    def _step(spmm_arg, params, opt_state, x, y, mask):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, spmm_arg, x, y, mask
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "acc": accuracy(logits, y, mask)}

    if isinstance(spmm, Plan):
        def step(params, opt_state, x, y, mask):
            return _step(spmm, params, opt_state, x, y, mask)
    else:
        @jax.jit
        def step(params, opt_state, x, y, mask):
            (loss, logits), grads = jax.value_and_grad(
                lambda p, x, y, m: loss_fn(p, spmm, x, y, m), has_aux=True
            )(params, x, y, mask)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, {
                "loss": loss, "acc": accuracy(logits, y, mask)
            }

    def init_state(params):
        return optimizer.init(params)

    return step, init_state


def make_eval_step(apply_fn: Callable, spmm: SpMM):
    """Jitted inference metrics: (params, x, y, mask) -> {loss, acc}."""
    from spmm_denseblock_tpu.ops.plan import Plan

    @jax.jit
    def _evaluate(spmm_arg, params, x, y, mask):
        logits = apply_fn(params, spmm_arg, x)
        return {
            "loss": masked_cross_entropy(logits, y, mask),
            "acc": accuracy(logits, y, mask),
        }

    if isinstance(spmm, Plan):
        return lambda params, x, y, mask: _evaluate(spmm, params, x, y, mask)

    @jax.jit
    def evaluate(params, x, y, mask):
        logits = apply_fn(params, spmm, x)
        return {
            "loss": masked_cross_entropy(logits, y, mask),
            "acc": accuracy(logits, y, mask),
        }

    return evaluate
