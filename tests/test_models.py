"""Model family tests: forward parity vs dense-math oracle, training step
convergence (single-chip and over the 8-device mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from spmm_denseblock_tpu.formats.csr import random_csr
from spmm_denseblock_tpu.models import (
    MODELS,
    accuracy,
    gcn_apply,
    init_gcn,
    make_train_step,
    mean_adjacency,
    sym_norm_adjacency,
)
from spmm_denseblock_tpu.ops import spmm_plan
from spmm_denseblock_tpu.parallel import make_mesh
from spmm_denseblock_tpu.parallel.train import make_dist_train_step, random_problem


def _graph(n=96, p=0.06, seed=2):
    return random_csr(p, n, seed=seed, values="ones")


def test_sym_norm_adjacency_rows():
    csr = _graph()
    a = sym_norm_adjacency(csr)
    d = a.to_dense()
    # symmetric normalization of a symmetric-ish matrix keeps values in [0,1]
    assert d.min() >= 0.0 and d.max() <= 1.0 + 1e-6
    # self loops present
    assert np.all(np.diag(d) > 0)


def test_mean_adjacency_rows_sum_to_one():
    a = mean_adjacency(_graph(), self_loops=True)
    s = a.to_dense().sum(axis=1)
    np.testing.assert_allclose(s, np.ones_like(s), atol=1e-5)


@pytest.mark.parametrize("name", ["gcn", "sage", "gin"])
def test_model_forward_matches_dense_oracle(name, rng):
    csr = _graph()
    norm = {
        "gcn": sym_norm_adjacency(csr),
        "sage": mean_adjacency(csr, self_loops=True),
        "gin": csr,
    }[name]
    dims = [12, 16, 5]
    init_fn, apply_fn = MODELS[name]
    params = init_fn(jax.random.PRNGKey(0), dims)
    x = rng.standard_normal((csr.n_rows, dims[0])).astype(np.float32)

    a_dense = jnp.asarray(norm.to_dense())
    spmm_oracle = lambda h: a_dense @ h
    spmm_fast = spmm_plan(norm, impl="bsr_xla", block_size=16)

    want = np.asarray(apply_fn(params, spmm_oracle, x))
    got = np.asarray(apply_fn(params, spmm_fast, x))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_train_step_reduces_loss(rng):
    csr = _graph(n=64)
    norm = sym_norm_adjacency(csr)
    dims = [8, 16, 3]
    params = init_gcn(jax.random.PRNGKey(1), dims)
    spmm = spmm_plan(norm, impl="csr_xla")
    opt = optax.adam(5e-2)
    step, init_state = make_train_step(gcn_apply, spmm, opt)
    opt_state = init_state(params)

    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = rng.integers(0, 3, size=64).astype(np.int32)
    mask = np.ones(64, dtype=np.float32)
    losses = []
    for _ in range(60):
        params, opt_state, m = step(params, opt_state, x, y, mask)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.6, losses[:3] + losses[-3:]


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_dist_train_step(mesh_shape, rng):
    mesh = make_mesh(mesh_shape)
    dims = [8, 16, 4]
    adj, x, y, mask = random_problem(128, dims, p=0.05, seed=3)
    params, opt_state, step = make_dist_train_step(
        adj, mesh, dims, model="gcn", block_size=16
    )
    losses = []
    for _ in range(10):
        params, opt_state, m = step(params, opt_state, x, y, mask)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_dist_matches_single_chip(rng):
    """Same seed, same data: the 2D-mesh step must track the single-chip
    step (check_result discipline applied to training)."""
    mesh = make_mesh((4, 2))
    dims = [8, 12, 3]
    adj, x, y, mask = random_problem(96, dims, p=0.06, seed=4)

    d_params, d_opt, d_step = make_dist_train_step(
        adj, mesh, dims, model="gcn", block_size=16, seed=7
    )
    s_params = init_gcn(jax.random.PRNGKey(7), dims)
    spmm = spmm_plan(adj, impl="bsr_xla", block_size=16)
    opt = optax.adam(1e-2)
    s_step, s_init = make_train_step(gcn_apply, spmm, opt)
    s_opt = s_init(s_params)

    for i in range(3):
        d_params, d_opt, dm = d_step(d_params, d_opt, x, y, mask)
        s_params, s_opt, sm = s_step(s_params, s_opt, x, y, mask)
        np.testing.assert_allclose(
            float(dm["loss"]), float(sm["loss"]), rtol=1e-4, atol=1e-5
        )


def test_checkpoint_roundtrip_resumes_training(tmp_path, rng):
    """Save mid-training, restore into fresh templates, training continues
    bit-identically (the reference's restart-from-disk property)."""
    import optax
    from spmm_denseblock_tpu.models import save_checkpoint, load_checkpoint

    csr = _graph(n=48)
    norm = sym_norm_adjacency(csr)
    dims = [6, 8, 3]
    spmm = spmm_plan(norm, impl="csr_xla")
    opt = optax.adam(1e-2)
    step, init_state = make_train_step(gcn_apply, spmm, opt)

    params = init_gcn(jax.random.PRNGKey(2), dims)
    opt_state = init_state(params)
    x = rng.standard_normal((48, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=48).astype(np.int32)
    mask = np.ones(48, dtype=np.float32)

    for _ in range(3):
        params, opt_state, _ = step(params, opt_state, x, y, mask)
    ckpt = str(tmp_path / "ck.npz")
    save_checkpoint(ckpt, params, opt_state, step=3)

    # continue directly
    p_direct, o_direct = params, opt_state
    p_direct, o_direct, m_direct = step(p_direct, o_direct, x, y, mask)

    # restore into fresh templates and continue
    t_params = init_gcn(jax.random.PRNGKey(99), dims)
    t_opt = init_state(t_params)
    p_rest, o_rest, at = load_checkpoint(ckpt, t_params, t_opt)
    assert at == 3
    p_rest, o_rest, m_rest = step(p_rest, o_rest, x, y, mask)
    np.testing.assert_allclose(
        float(m_rest["loss"]), float(m_direct["loss"]), rtol=1e-6
    )


def test_checkpoint_extensionless_path(tmp_path):
    """save('ckpt')/load('ckpt') must agree even though np.savez appends
    '.npz' and np.load does not."""
    from spmm_denseblock_tpu.models import save_checkpoint, load_checkpoint

    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    path = str(tmp_path / "ckpt")  # no extension
    save_checkpoint(path, params, step=7)
    got, _, at = load_checkpoint(path, {"w": np.zeros((2, 3), np.float32)})
    assert at == 7
    np.testing.assert_array_equal(got["w"], params["w"])


def test_graph_classifier_on_molecule_batch(rng):
    """ogbg-style pipeline: block-diagonal molecule batch, per-molecule
    reorder, GIN + mean-pool readout trains."""
    import optax
    from spmm_denseblock_tpu.io.datasets import synthetic_molecules
    from spmm_denseblock_tpu.models import (
        graph_classifier_apply,
        init_graph_classifier,
    )
    from spmm_denseblock_tpu.reorder import (
        check_permutation,
        permutate,
        reorder_per_component,
    )
    from spmm_denseblock_tpu.reorder.greedy import greedy_closest

    csr, graph_ids = synthetic_molecules(n_graphs=12, mean_nodes=10, seed=3)
    n_graphs = int(graph_ids.max()) + 1
    # per-molecule reorder keeps each molecule contiguous
    perm = reorder_per_component(csr, greedy_closest)
    check_permutation(perm, csr.n_rows)
    rcsr = permutate(perm, csr)
    assert rcsr.nnz == csr.nnz

    dims = [5, 8, 8]
    params = init_graph_classifier(jax.random.PRNGKey(0), dims, 2)
    spmm = spmm_plan(rcsr, impl="csr_xla")
    x = rng.standard_normal((csr.n_rows, 5)).astype(np.float32)
    y = rng.integers(0, 2, size=n_graphs).astype(np.int32)
    gids = jnp.asarray(graph_ids)

    import optax as _optax

    opt = _optax.adam(2e-2)

    def loss_fn(p):
        logits = graph_classifier_apply(p, spmm, x, gids, n_graphs)
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, y[:, None], axis=1))

    state = opt.init(params)
    losses = []
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for _ in range(40):
        loss, grads = grad_fn(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_gat_trains(rng):
    import optax
    from spmm_denseblock_tpu.models import init_gat, make_gat_apply

    csr = _graph(n=56, p=0.1, seed=8)
    dims = [6, 8, 3]
    params = init_gat(jax.random.PRNGKey(0), dims, heads=2)
    apply = make_gat_apply(csr, heads=2)
    x = rng.standard_normal((56, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=56).astype(np.int32)

    out = apply(params, x)
    assert out.shape == (56, 3)
    assert np.isfinite(np.asarray(out)).all()

    def loss_fn(p):
        lp = jax.nn.log_softmax(apply(p, x))
        return -jnp.mean(jnp.take_along_axis(lp, y[:, None], axis=1))

    opt = optax.adam(2e-2)
    state = opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    losses = []
    for _ in range(40):
        loss, g = grad_fn(params)
        up, state = opt.update(g, state, params)
        params = optax.apply_updates(params, up)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


@pytest.mark.parametrize("model", ["sage", "gin"])
def test_dist_train_other_models(model, rng):
    """The distributed step factory serves the whole model family."""
    mesh = make_mesh((4, 2))
    dims = [8, 12, 4]
    adj, x, y, mask = random_problem(96, dims, p=0.06, seed=11)
    params, opt_state, step = make_dist_train_step(
        adj, mesh, dims, model=model, block_size=16
    )
    l0 = None
    for _ in range(6):
        params, opt_state, m = step(params, opt_state, x, y, mask)
        if l0 is None:
            l0 = float(m["loss"])
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) < l0


def test_eval_step(rng):
    from spmm_denseblock_tpu.models import make_eval_step

    csr = _graph(n=40)
    norm = sym_norm_adjacency(csr)
    spmm = spmm_plan(norm, impl="csr_xla")
    params = init_gcn(jax.random.PRNGKey(0), [4, 6, 3])
    ev = make_eval_step(gcn_apply, spmm)
    x = rng.standard_normal((40, 4)).astype(np.float32)
    y = rng.integers(0, 3, size=40).astype(np.int32)
    m = ev(params, x, y, np.ones(40, np.float32))
    assert np.isfinite(float(m["loss"])) and 0 <= float(m["acc"]) <= 1


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_dist_train_step_hybrid(mesh_shape, rng):
    """Hybrid adjacency (dense stripes + dist ELL remainder) through the
    full distributed train step — the north-star aggregation path for
    gather-bound graphs where BSR-ification is infeasible."""
    from spmm_denseblock_tpu.convert.divide import divide

    mesh = make_mesh(mesh_shape)
    dims = [8, 16, 4]
    adj, x, y, mask = random_problem(128, dims, p=0.05, seed=3)
    hyb = divide(adj, 16, 0.05)
    assert hyb.remainder.nnz > 0  # the ELL tier must actually run
    params, opt_state, step = make_dist_train_step(
        hyb, mesh, dims, model="gcn", block_size=16
    )
    losses = []
    for _ in range(10):
        params, opt_state, m = step(params, opt_state, x, y, mask)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
