"""GNN model family over the framework's SpMM ops.

Models are pure functions over plain pytree params; the sparse
aggregation is INJECTED as an ``spmm`` closure (any plan from
ops/dispatch.py or parallel/spmm.py), so the same model runs on one card
(Pallas BSR kernel) or several (shard_map halo exchange) without
changing model code. The dense transforms (H @ W) are plain jnp matmuls —
XLA fuses the bias/activation epilogues into them.

The reference repo stops at the SpMM benchmark (its point is that A @ X
with a block-densified A is the GNN hot loop); these models complete the
story end-to-end: GCN (Kipf-Welling), GraphSAGE (mean), GIN.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import jax
import jax.numpy as jnp

SpMM = Callable[[jax.Array], jax.Array]


def _glorot(key, shape, dtype=jnp.float32):
    fan_in, fan_out = shape[0], shape[-1]
    scale = jnp.sqrt(2.0 / (fan_in + fan_out))
    return scale * jax.random.normal(key, shape, dtype)


def init_linear(key, d_in: int, d_out: int) -> dict:
    return {"w": _glorot(key, (d_in, d_out)), "b": jnp.zeros((d_out,))}


def linear(p: dict, x: jax.Array) -> jax.Array:
    return x @ p["w"] + p["b"]


# -- GCN ---------------------------------------------------------------------


def init_gcn(key, dims: Sequence[int]) -> List[dict]:
    """dims = [in, hidden..., out]; expects spmm built from
    sym_norm_adjacency (models/graph.py)."""
    keys = jax.random.split(key, len(dims) - 1)
    return [init_linear(k, a, b) for k, a, b in zip(keys, dims[:-1], dims[1:])]


def gcn_apply(
    params: List[dict], spmm: SpMM, x: jax.Array, remat: bool = False
) -> jax.Array:
    """remat=True wraps each layer in jax.checkpoint: activations are
    recomputed in the backward pass instead of stored — trades FLOPs for
    device memory on deep stacks / large graphs."""

    def layer(p, h, act):
        h = linear(p, spmm(h))
        return jax.nn.relu(h) if act else h

    if remat:
        layer = jax.checkpoint(layer, static_argnums=(2,))
    h = x
    for i, p in enumerate(params):
        h = layer(p, h, i < len(params) - 1)
    return h


# -- GraphSAGE (mean aggregator) --------------------------------------------


def init_sage(key, dims: Sequence[int]) -> List[dict]:
    """expects spmm built from mean_adjacency."""
    keys = jax.random.split(key, 2 * (len(dims) - 1))
    return [
        {
            "self": init_linear(keys[2 * i], dims[i], dims[i + 1]),
            "neigh": init_linear(keys[2 * i + 1], dims[i], dims[i + 1]),
        }
        for i in range(len(dims) - 1)
    ]


def sage_apply(params: List[dict], spmm: SpMM, x: jax.Array) -> jax.Array:
    h = x
    for i, p in enumerate(params):
        h = linear(p["self"], h) + linear(p["neigh"], spmm(h))
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


# -- GIN ---------------------------------------------------------------------


def init_gin(key, dims: Sequence[int], mlp_hidden: int = 0) -> List[dict]:
    """expects spmm built from the raw adjacency (sum aggregator)."""
    layers = []
    keys = jax.random.split(key, 2 * (len(dims) - 1))
    for i in range(len(dims) - 1):
        hid = mlp_hidden or dims[i + 1]
        layers.append(
            {
                "eps": jnp.zeros(()),
                "mlp1": init_linear(keys[2 * i], dims[i], hid),
                "mlp2": init_linear(keys[2 * i + 1], hid, dims[i + 1]),
            }
        )
    return layers


def gin_apply(params: List[dict], spmm: SpMM, x: jax.Array) -> jax.Array:
    h = x
    for i, p in enumerate(params):
        h = (1.0 + p["eps"]) * h + spmm(h)
        h = linear(p["mlp2"], jax.nn.relu(linear(p["mlp1"], h)))
        if i < len(params) - 1:
            h = jax.nn.relu(h)
    return h


MODELS = {
    "gcn": (init_gcn, gcn_apply),
    "sage": (init_sage, sage_apply),
    "gin": (init_gin, gin_apply),
}


# -- graph-level readout (ogbg-style classification) -------------------------


def init_graph_classifier(key, dims: Sequence[int], n_graph_classes: int):
    """GIN trunk + mean-pool readout + linear head, for batched
    block-diagonal molecule graphs (io/datasets.synthetic_molecules)."""
    k1, k2 = jax.random.split(key)
    return {
        "gin": init_gin(k1, dims),
        "head": init_linear(k2, dims[-1], n_graph_classes),
    }


def graph_classifier_apply(
    params, spmm: SpMM, x: jax.Array, graph_ids: jax.Array, n_graphs: int
) -> jax.Array:
    """Returns (n_graphs, n_classes) logits. Mean pooling via two
    segment-sums (sum / count) — sorted graph_ids, static n_graphs."""
    h = gin_apply(params["gin"], spmm, x)
    sums = jax.ops.segment_sum(
        h, graph_ids, num_segments=n_graphs, indices_are_sorted=True
    )
    counts = jax.ops.segment_sum(
        jnp.ones((h.shape[0], 1), h.dtype),
        graph_ids,
        num_segments=n_graphs,
        indices_are_sorted=True,
    )
    pooled = sums / jnp.maximum(counts, 1.0)
    return linear(params["head"], pooled)
