"""Proof that the library's main path runs on an NVIDIA GPU.

    python chip_smoke.py             # one card: the four phases below
    python chip_smoke.py --cards 4   # four cards: the distributed path only

One process drives the card(s). Every phase compares what the library
serves with a plain reference and fails the run when it is out of
tolerance (f32 1e-4, bf16 5e-3, int8 5e-2: bench/harness.DTYPE_TOL):

  serve_headline   2^17-square BSR, b=128, block density 2e-2, F=512,
                   through spmm_plan(impl="auto") in f32, bf16 and int8;
                   reference float64 numpy products of 64 sampled
                   block-rows (8,192 rows x 512)
  train_gcn_ddi    5 GCN steps (dims 128-256-40) on the ogbl-ddi
                   stand-in through impl="auto" and the custom VJP;
                   reference the same steps on the dense matrix. Then
                   the VJP on a non-symmetric 6144-square BSR (b=128)
                   against jax.grad of the dense product
  serve_arxiv_auto the full ogbn-arxiv stand-in, rcmk order, F=128,
                   through impl="auto" (the ELL / hybrid routes);
                   reference float64 scipy
  kernel_vs_xla    host-clock medians of the kernel's f32 / bf16x3 /
                   bf16 / int8 plans at the serve_headline shape, and of
                   the kernel against bsr_xla and bsr_int8 at a shape
                   XLA's plain form compiles for

XLA's plain forms (bsr_xla, bsr_int8) do not finish compiling at the
serve_headline shape on the H100 (PERF.md), so they are not run there.

--cards 4 runs dist_bsr_spmm_plan (allgather, ring; halo on a banded
matrix of the same size) and dist_csr_spmm_plan on the serve_headline
matrix in f32 and int8, each against the one-card plan's product, and
two make_dist_train_step steps (2 x 2 mesh) on the ogbl-ddi stand-in
against the same steps on one card.

The last line of standard output is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed.
Without a GPU it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 1234
HEADLINE = dict(p=2e-2, n_block_rows=1024, b=128, f=512)
# XLA's plain BSR form compiles quickly only at small shapes on the H100
# (PERF.md): the kernel-vs-XLA timing runs here.
SMALL = dict(p=0.3, n_block_rows=8, b=128, f=200)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


_TIER_OF = {
    "_pallas_apply": "bsr_pallas",
    "_bsr_xla_apply": "bsr_xla",
    "_int8_xla_apply": "bsr_int8",
}


def _impls(plan) -> list:
    """Names of the leaf tiers a (possibly composed) plan runs."""
    import jax

    from spmm_denseblock_tpu.ops.plan import Plan

    subs = [x for x in jax.tree.leaves(
        plan.arrays, is_leaf=lambda x: isinstance(x, Plan))
        if isinstance(x, Plan)]
    if subs:
        return sorted({name for sub in subs for name in _impls(sub)})
    fn = getattr(plan.apply_fn, "__name__", repr(plan.apply_fn))
    return [_TIER_OF.get(fn, fn)]


def _rel_err(got, want) -> float:
    """max |got - want| / max |want| (bench/harness.conformance_fields)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _exact_rows(bsr, x, block_rows) -> np.ndarray:
    """float64 numpy product for the given block-rows of A @ x."""
    b = bsr.b
    rows = np.asarray(bsr.block_rows[: bsr.nnzb])
    cols = np.asarray(bsr.block_cols[: bsr.nnzb])
    blocks = bsr.blocks
    out = np.zeros((len(block_rows) * b, x.shape[1]))
    for i, r in enumerate(block_rows):
        for k in np.nonzero(rows == r)[0]:
            c = int(cols[k])
            out[i * b:(i + 1) * b] += (
                blocks[k].astype(np.float64) @ x[c * b:(c + 1) * b]
            )
    return out


def _row_slice(out, block_rows, b) -> np.ndarray:
    idx = (np.asarray(block_rows)[:, None] * b + np.arange(b)).reshape(-1)
    return np.asarray(out)[idx]


def headline_problem(p, n_block_rows, b, f, seed=SEED):
    from spmm_denseblock_tpu.formats.bsr import random_bsr

    bsr = random_bsr(p, n_block_rows, block_size=b, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsr.shape[1], f)).astype(np.float32)
    # static int8 scales (calibration=) fitted on the served batch itself:
    # the error is then quantization noise alone, not clipping
    return bsr, x, x


def phase_serve_headline(p, n_block_rows, b, f) -> bool:
    import jax

    from spmm_denseblock_tpu.bench.harness import dtype_tolerance
    from spmm_denseblock_tpu.ops import spmm_plan

    bsr, x, cal = headline_problem(p, n_block_rows, b, f)
    print(f"serve_headline: shape={bsr.shape} b={b} nnzb={bsr.nnzb} F={f}")
    xd = jax.device_put(x)
    sample = np.random.default_rng(SEED).choice(
        bsr.n_block_rows, min(64, bsr.n_block_rows), replace=False
    )
    exact = _exact_rows(bsr, x.astype(np.float64), sample)
    ok = True
    for dtype, kw in (
        ("float32", {}),
        ("bfloat16", {"dtype": "bfloat16"}),
        ("int8", {"dtype": "int8", "calibration": cal}),
    ):
        plan = spmm_plan(bsr, impl="auto", feat_dim=f, grad=False, **kw)
        out = np.asarray(plan(xd))
        tol = dtype_tolerance(dtype)
        e_f64 = _rel_err(_row_slice(out, sample, b), exact)
        good = out.shape == (bsr.shape[0], f) and np.isfinite(out).all() and (
            e_f64 <= tol
        )
        print(f"  {dtype}: auto chose {_impls(plan)} "
              f"err_vs_f64_rows={e_f64:.2e} tol={tol:.0e}"
              f" {'ok' if good else 'FAILED'}")
        ok &= bool(good)
        del plan, out
    return bool(ok)


def phase_train_gcn_ddi(steps=5, dims=(128, 256, 40), scale=1.0) -> bool:
    import jax
    import optax

    from spmm_denseblock_tpu.io.datasets import load_dataset
    from spmm_denseblock_tpu.models import (
        gcn_apply,
        init_gcn,
        make_train_step,
        sym_norm_adjacency,
    )
    from spmm_denseblock_tpu.ops import spmm_plan
    from spmm_denseblock_tpu.reorder import reorder

    csr = load_dataset("ogbl-ddi", scale=scale)
    adj = sym_norm_adjacency(reorder(csr, "rcmk")[0])
    n = adj.n_rows
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], size=n).astype(np.int32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    print(f"train_gcn_ddi: n={n} nnz={adj.nnz} dims={list(dims)} "
          f"steps={steps}")
    losses = {}
    # x @ W in the model would run in TF32 on this card otherwise
    with jax.default_matmul_precision("highest"):
        for label in ("auto", "dense"):
            spmm = spmm_plan(adj, impl=label, block_size=128,
                             feat_dim=dims[1])
            if label == "auto":
                print(f"  auto chose {_impls(spmm)}")
            params = init_gcn(jax.random.PRNGKey(0), list(dims))
            step, init_state = make_train_step(
                gcn_apply, spmm, optax.adam(1e-2)
            )
            opt_state = init_state(params)
            ls = []
            for _ in range(steps):
                params, opt_state, m = step(params, opt_state, x, y, mask)
                ls.append(float(m["loss"]))
            losses[label] = np.asarray(ls)
    ok = True
    print(f"  losses dense={np.round(losses['dense'], 6).tolist()}")
    for label in ("auto",):
        err = float(np.max(np.abs(losses[label] - losses["dense"])
                           / np.abs(losses["dense"])))
        good = np.isfinite(losses[label]).all() and err <= 1e-4
        print(f"  losses {label}={np.round(losses[label], 6).tolist()} "
              f"max rel diff {err:.2e} (tol 1e-04) "
              f"{'ok' if good else 'FAILED'}")
        ok &= bool(good)
    return ok and _check_vjp_nonsymmetric()


def _check_vjp_nonsymmetric(nb=48, b=128, f=256) -> bool:
    """The custom VJP on a square matrix with A != A^T, where a fault in
    the transposed backward layout would show (the GCN adjacency above
    is symmetric): the input gradient of sum(sin(A @ X)) through the
    kernel's plans against jax.grad of the dense product, at the f32
    gate."""
    import jax
    import jax.numpy as jnp

    from spmm_denseblock_tpu.formats.bsr import random_bsr
    from spmm_denseblock_tpu.ops import bsr_spmm_pallas_plan, spmm_plan

    bsr = random_bsr(0.1, nb, block_size=b, seed=SEED)
    dense_a = bsr.to_dense()
    asym = float(np.abs(dense_a - dense_a.T).max() / np.abs(dense_a).max())
    x = jnp.asarray(np.random.default_rng(SEED).standard_normal(
        (bsr.shape[1], f)).astype(np.float32))
    a = jnp.asarray(dense_a)
    print(f"  vjp, non-symmetric A: shape={bsr.shape} b={b} nnzb={bsr.nnzb} "
          f"F={f} max|A - A^T|/max|A|={asym:.2f}")
    ok = asym > 0.5
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda v: jnp.sum(jnp.sin(a @ v)))(x)
        for label, plan in (
            ("auto", spmm_plan(bsr, impl="auto")),
            ("bsr_pallas precision=high (bf16x3)",
             bsr_spmm_pallas_plan(bsr, precision="high")),
        ):
            got = jax.grad(lambda v: jnp.sum(jnp.sin(plan(v))))(x)
            err = _rel_err(got, want)
            good = got.shape == want.shape and err <= 1e-4
            print(f"    dX {label} ({_impls(plan)}): err_vs_dense_grad="
                  f"{err:.2e} (tol 1e-04) {'ok' if good else 'FAILED'}")
            ok &= bool(good)
    return bool(ok)


def phase_serve_arxiv_auto(f=128, scale=1.0) -> bool:
    import jax

    from spmm_denseblock_tpu.io.datasets import load_dataset
    from spmm_denseblock_tpu.ops import assert_allclose, spmm_plan
    from spmm_denseblock_tpu.reorder import reorder

    rcsr = reorder(load_dataset("ogbn-arxiv", scale=scale), "rcmk")[0]
    x = np.random.default_rng(SEED).standard_normal(
        (rcsr.n_cols, f)).astype(np.float32)
    plan = spmm_plan(rcsr, impl="auto", feat_dim=f, grad=False)
    out = np.asarray(plan(jax.device_put(x)))
    # float64: scipy's f32 accumulation over hub rows (degree ~1e4) is
    # itself ~6e-4 off
    want = rcsr.to_scipy().astype(np.float64) @ x.astype(np.float64)
    print(f"serve_arxiv_auto: n={rcsr.n_rows} nnz={rcsr.nnz} F={f} "
          f"auto chose {_impls(plan)}")
    try:
        assert_allclose(out, want, msg="arxiv auto")
    except AssertionError as e:
        print(f"  FAILED: {e}")
        return False
    print(f"  vs float64 scipy: {_rel_err(out, want):.2e} (max-normalised) ok")
    return True


def _time_cases(label, shape, cases, iters) -> bool:
    """Time each plan on one problem (median host-clock ms after
    warm-up) and check it against float64 rows at its dtype's gate."""
    import jax

    from spmm_denseblock_tpu.bench.harness import dtype_tolerance
    from spmm_denseblock_tpu.bench.timing import time_call

    bsr, x, cal = headline_problem(**shape)
    b, f = shape["b"], shape["f"]
    xd = jax.device_put(x)
    flops = 2.0 * bsr.nnzb * b * b * f
    sample = np.arange(0, bsr.n_block_rows, max(1, bsr.n_block_rows // 8))
    exact = _exact_rows(bsr, x.astype(np.float64), sample)
    print(f"  {label}: nnzb={bsr.nnzb} b={b} F={f} "
          f"(median of {iters} host-clock calls after warm-up)")
    ok = True
    for name, dtype, build in cases:
        plan = build(bsr, cal)
        t = time_call(plan, xd, iters=iters)
        err = _rel_err(_row_slice(plan(xd), sample, b), exact)
        good = np.isfinite(t["secs"]) and err <= dtype_tolerance(dtype)
        ok &= bool(good)
        print(f"    {name}: {t['secs'] * 1e3:.3f} ms "
              f"(min {t['secs_min'] * 1e3:.3f}, max {t['secs_max'] * 1e3:.3f})"
              f" {flops / t['secs'] / 1e9:.1f} GFLOP/s err {err:.1e}"
              f" {'ok' if good else 'FAILED'}")
        del plan
    return ok


def phase_kernel_vs_xla(headline, small, iters=10) -> bool:
    from spmm_denseblock_tpu.ops import (
        bsr_spmm_int8_plan,
        bsr_spmm_pallas_int8_plan,
        bsr_spmm_pallas_plan,
        bsr_spmm_xla_plan,
    )

    kernel = (
        ("bsr_pallas f32 (IEEE)", "float32",
         lambda m, c: bsr_spmm_pallas_plan(m, grad=False)),
        ("bsr_pallas f32 high (bf16x3)", "float32",
         lambda m, c: bsr_spmm_pallas_plan(m, grad=False, precision="high")),
        ("bsr_pallas bf16", "bfloat16",
         lambda m, c: bsr_spmm_pallas_plan(m, grad=False, dtype="bfloat16")),
        ("bsr_int8_pallas", "int8",
         lambda m, c: bsr_spmm_pallas_int8_plan(m, calibration=c)),
    )
    xla = (
        ("bsr_xla f32", "float32", lambda m, c: bsr_spmm_xla_plan(m)),
        ("bsr_xla bf16", "bfloat16",
         lambda m, c: bsr_spmm_xla_plan(m, dtype="bfloat16")),
        ("bsr_int8", "int8",
         lambda m, c: bsr_spmm_int8_plan(m, calibration=c)),
    )
    print("kernel_vs_xla:")
    ok = _time_cases("serve_headline shape, kernel plans", headline,
                     kernel, iters)
    print("  serve_headline shape, bsr_xla / bsr_int8: not run (XLA's "
          "plain form does not finish compiling there; PERF.md)")
    ok &= _time_cases("small shape, kernel and XLA", small,
                      kernel[1:] + xla, iters)
    return ok


def phase_distributed(p, n_block_rows, b, f, n_cards=4) -> bool:
    """dist_* plans on n_cards against the single-card reference, at the
    serve_headline shape, and a distributed GCN training step on the
    ogbl-ddi stand-in against the same steps on one card."""
    import jax

    from spmm_denseblock_tpu.bench.harness import dtype_tolerance
    from spmm_denseblock_tpu.convert.csr2bsr import bsr_to_csr
    from spmm_denseblock_tpu.formats.bsr import BSR
    from spmm_denseblock_tpu.ops import spmm_plan
    from spmm_denseblock_tpu.parallel import make_mesh_1d
    from spmm_denseblock_tpu.parallel.spmm import (
        dist_bsr_spmm_plan,
        dist_csr_spmm_plan,
    )

    bsr, x, cal = headline_problem(p, n_block_rows, b, f)
    devices = jax.devices()[:n_cards]
    mesh = make_mesh_1d(n_cards, devices=devices)
    print(f"distributed: {n_cards} card(s), shape={bsr.shape} b={b} "
          f"nnzb={bsr.nnzb} F={f}")
    ok = True

    def single_card(m):
        """The one-card plan's f32 product, itself checked against
        float64 rows at the f32 gate."""
        nonlocal ok
        plan = spmm_plan(m, impl="auto", grad=False)
        out = np.asarray(plan(jax.device_put(x, devices[0])))
        sample = np.arange(0, m.n_block_rows, max(1, m.n_block_rows // 16))
        err = _rel_err(_row_slice(out, sample, m.b),
                       _exact_rows(m, x.astype(np.float64), sample))
        good = err <= dtype_tolerance("float32")
        print(f"  single card ({_impls(plan)}): err_vs_f64_rows={err:.2e} "
              f"{'ok' if good else 'FAILED'}")
        ok &= bool(good)
        return out

    def check(label, plan, dtype, ref):
        nonlocal ok
        t0 = time.perf_counter()
        out = plan(x)
        out.block_until_ready()
        first = time.perf_counter() - t0
        spread = len(out.sharding.device_set)
        stripes = {d.id for leaf in jax.tree.leaves(plan)
                   for d in leaf.sharding.device_set}
        err = _rel_err(np.asarray(out), ref)
        tol = dtype_tolerance(dtype)
        good = err <= tol and spread == n_cards and len(stripes) == n_cards
        inner = plan
        while not inner.statics:  # LPT-balanced wrapper around the plan
            inner = inner.arrays[0]
        if isinstance(inner.statics[0], str):
            ran = (f"{inner.statics[0]}, stripes "
                   f"{'kernel' if inner.statics[1][-1] is False else 'xla'}")
        else:
            ran = "ell"
        print(f"  {label} (ran {ran}): err_vs_single_card={err:.2e} "
              f"tol={tol:.0e} output on {spread} devices, plan arrays on "
              f"{len(stripes)}, first call {first:.1f} s "
              f"{'ok' if good else 'FAILED'}", flush=True)
        ok &= bool(good)

    ref = single_card(bsr)
    for strategy in ("allgather", "ring"):
        check(f"dist_bsr {strategy} f32",
              dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy,
                                 grad=False), "float32", ref)
        check(f"dist_bsr {strategy} int8",
              dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy,
                                 dtype="int8", calibration=cal), "int8", ref)
    csr = bsr_to_csr(bsr)
    check("dist_csr f32", dist_csr_spmm_plan(csr, mesh=mesh), "float32", ref)
    check("dist_csr int8", dist_csr_spmm_plan(
        csr, mesh=mesh, dtype="int8", calibration=cal), "int8", ref)
    del csr, ref

    # halo needs a banded matrix (a random one falls back to allgather):
    # blocks on the diagonal and its two neighbours, same b and F
    nbr = n_block_rows
    rows = np.repeat(np.arange(nbr), 3)
    cols = np.clip(rows + np.tile([-1, 0, 1], nbr), 0, nbr - 1)
    key = np.unique(rows * nbr + cols)
    rng = np.random.default_rng(SEED)
    band = BSR.from_parts(
        (key // nbr).astype(np.int32), (key % nbr).astype(np.int32),
        rng.random((key.size, b, b), dtype=np.float32), bsr.shape, b)
    ref = single_card(band)
    for dtype, kw in (("float32", {}),
                      ("int8", {"dtype": "int8", "calibration": cal})):
        if n_cards < 4:  # halo needs more stripes than its 3-chunk window
            break
        check(f"dist_bsr halo {dtype} (banded)",
              dist_bsr_spmm_plan(band, mesh=mesh, strategy="halo",
                                 grad=False, **kw), dtype, ref)
    del ref
    return bool(ok and _dist_train_ddi(devices))


def _dist_train_ddi(devices, steps=2, dims=(128, 256, 40)) -> bool:
    """make_dist_train_step (row x col mesh, ring strategy, b=128) on the
    ogbl-ddi stand-in against the same steps on one card's dense
    matrix."""
    import jax
    import optax

    from spmm_denseblock_tpu.io.datasets import load_dataset
    from spmm_denseblock_tpu.models import (
        gcn_apply,
        init_gcn,
        make_train_step,
        sym_norm_adjacency,
    )
    from spmm_denseblock_tpu.ops import spmm_plan
    from spmm_denseblock_tpu.parallel import make_mesh
    from spmm_denseblock_tpu.parallel.train import make_dist_train_step
    from spmm_denseblock_tpu.reorder import reorder

    adj = sym_norm_adjacency(reorder(load_dataset("ogbl-ddi"), "rcmk")[0])
    n = adj.n_rows
    rng = np.random.default_rng(SEED)
    xs = rng.standard_normal((n, dims[0])).astype(np.float32)
    ys = rng.integers(0, dims[-1], size=n).astype(np.int32)
    ms = (rng.random(n) < 0.7).astype(np.float32)
    n_cards = len(devices)
    shape = (n_cards // 2, 2) if n_cards >= 2 else (1, 1)
    with jax.default_matmul_precision("highest"):
        params, opt, step = make_dist_train_step(
            adj, make_mesh(shape, devices=devices), list(dims), model="gcn",
            block_size=128, strategy="ring")
        l_dist = []
        for _ in range(steps):
            params, opt, m = step(params, opt, xs, ys, ms)
            l_dist.append(float(m["loss"]))
        params1 = init_gcn(jax.random.PRNGKey(0), list(dims))
        step1, init1 = make_train_step(
            gcn_apply, spmm_plan(adj, impl="dense"), optax.adam(1e-2))
        opt1 = init1(params1)
        l_one = []
        for _ in range(steps):
            params1, opt1, m = step1(params1, opt1, xs, ys, ms)
            l_one.append(float(m["loss"]))
    err = float(np.max(np.abs(np.subtract(l_dist, l_one)) / np.abs(l_one)))
    good = bool(np.isfinite(l_dist).all() and err <= 1e-4)
    print(f"  dist train step, ogbl-ddi stand-in n={n} dims={list(dims)} "
          f"mesh={shape}: losses {l_dist} vs single card {l_one} "
          f"rel diff {err:.2e} {'ok' if good else 'FAILED'}")
    return good


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.cards:
        print(f"chip_smoke.py needs {args.cards} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        return 2

    from spmm_denseblock_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    print(f"card: {_card_line()}")
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind} "
          f"(compile cache {cache})")

    if args.cards == 1:
        phases = (
            ("serve_headline", lambda: phase_serve_headline(**HEADLINE)),
            ("train_gcn_ddi", phase_train_gcn_ddi),
            ("serve_arxiv_auto", phase_serve_arxiv_auto),
            ("kernel_vs_xla", lambda: phase_kernel_vs_xla(HEADLINE, SMALL)),
        )
    else:
        phases = (
            ("distributed", lambda: phase_distributed(
                **HEADLINE, n_cards=args.cards)),
        )
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            good = run()
        except Exception:
            traceback.print_exc()
            good = False
        print(f"[{name}] {'ok' if good else 'FAILED'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if not good:
            failed.append(name)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
