"""Distributed SpMM over a jax.sharding Mesh via shard_map.

The reference is single-GPU; this layer realizes the target's north-star
design (BASELINE.json): row/block-partition A across devices, exchange
the dense operand's rows over collectives (NVLink on a multi-card
host), overlap with local block GEMMs.

Two strategies (both produce C = A @ B with A row-striped over `axis`):

  allgather — B is row-sharded; one tiled all_gather materializes the
      full padded B per device, then the local stripe of A multiplies it.
      One collective, maximal overlap left to XLA. Memory: O(K·F) per
      device. The right choice while B fits in HBM.

  ring — B stays sharded in n chunks; at step s each device multiplies
      the blocks whose block-col lands in its currently-held chunk, then
      ppermutes the chunk to its ring neighbor. XLA overlaps the ppermute
      with the step's block GEMMs — the halo-exchange/compute overlap the
      reference could never express. Memory: O(K·F / n).

Local per-stripe compute is the Pallas BSR kernel on a GPU
(ops/bsr_spmm_pallas.py) and the flat-BSR batched-matmul + segment-sum
formulation (ops/bsr_spmm_xla.py) elsewhere; accumulation is f32.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spmm_denseblock_tpu.backend import on_gpu, pallas_interpret
from spmm_denseblock_tpu.formats.bsr import BSR
from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.parallel.mesh import make_mesh_1d
from spmm_denseblock_tpu.ops.plan import Plan, grad_plan, sum_plan
from spmm_denseblock_tpu.parallel.shard import (
    balanced_contiguous_boundaries,
    bucket_by_col_chunk,
    bucket_halo,
    shard_bsr,
    shard_csr,
)


def _stripe_product(kern, row_ptr, rows, cols, blocks, dense, rows_per,
                    scales):
    """One stripe's (rows_per * b, F) f32 product from its row-sorted
    block list and the (K, F) operand rows its block columns index.
    The kernel's shard_maps run with check_vma=False: a pallas_call
    carries no varying-axes types.

    kern=None runs XLA's plain form (ops/bsr_spmm_xla.block_products:
    gather, batched matmul, segment-sum over `rows`); otherwise the
    Pallas kernel (ops/bsr_spmm_pallas.kernel_product) walks `row_ptr`,
    with interpret=kern. int8 blocks rescale by the per-block `scales`
    (the separable per-column operand scale is applied once by the
    caller)."""
    b = blocks.shape[1]
    f = dense.shape[1]
    scales = scales if blocks.dtype == jnp.int8 else None
    if kern is None:
        from spmm_denseblock_tpu.ops.bsr_spmm_xla import block_products

        out = block_products(rows, cols, blocks, dense.reshape(-1, b, f),
                             rows_per, scales=scales)
        return out.reshape(rows_per * b, f)
    from spmm_denseblock_tpu.ops.bsr_spmm_pallas import kernel_product

    return kernel_product(row_ptr, cols, blocks, dense, scales,
                          interpret=kern)


def _row_ptrs(local_rows, idx_payload, rows_per) -> np.ndarray:
    """Kernel row pointers (..., rows_per + 1) for stacked row-sorted
    block lists (..., m). Padding blocks (index payload 0) sit after the
    real blocks of the last row, so no row's extent covers them."""
    lr = np.asarray(local_rows).reshape(-1, local_rows.shape[-1])
    real = (np.asarray(idx_payload)[..., 0, 0] > 0).reshape(lr.shape)
    out = np.zeros((lr.shape[0], rows_per + 1), np.int32)
    for i in range(lr.shape[0]):
        k = int(real[i].sum())
        assert real[i, :k].all(), "padding is not at the end of the list"
        out[i] = np.searchsorted(lr[i, :k], np.arange(rows_per + 1))
    return out.reshape(local_rows.shape[:-1] + (rows_per + 1,))


# ---------------------------------------------------------------------------
# Module-level apply functions: every dist plan is a Plan PYTREE (arrays as
# leaves, apply + hashable statics in the treedef), so a jitted train step
# can take the plan as an ARGUMENT — its sharded device arrays stay runtime
# parameters instead of being re-embedded as HLO constants when an outer jit
# traces through the plan (the GB-scale failure mode, ops/plan.py). Each
# apply routes through a module-level jit keyed on the statics tuple, so
# direct plan(x) calls stay compiled and retraces are shared per family.
# ---------------------------------------------------------------------------


def _quantize_operand(dense, cs):
    """Shared int8 entry: quantize the FULL operand once with global
    per-column scales (ops/bsr_spmm_int8.quantize_per_column) so every
    stripe agrees, and move int8 over the links (4x less than f32). Returns
    (q_int8, col_scale); the caller applies col_scale to the output."""
    from spmm_denseblock_tpu.ops.bsr_spmm_int8 import quantize_per_column

    return quantize_per_column(dense.astype(jnp.float32), cs)


@functools.partial(jax.jit, static_argnames="statics")
def _ag_run(statics, rp, lr, bc, bv, sc, cs, dense):
    (mesh, axis, feature_axis, rows_per, cpc, n, b, n_rows, k_padded,
     dtype_key, kern) = statics
    b_spec = P(axis, feature_axis)
    int8_mode = dtype_key == "int8"
    col_scale = None
    if int8_mode:
        dense, col_scale = _quantize_operand(dense, cs)
    elif dtype_key is not None:
        dense = dense.astype(dtype_key)
    dense = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    dense = jax.lax.with_sharding_constraint(dense, NamedSharding(mesh, b_spec))

    def stripe_fn(rp, lr, bc, bv, sc, b_local):
        # (1, m) locals -> (m,); B local stripe (k_padded/n, F)
        b_full = jax.lax.all_gather(b_local, axis, tiled=True)
        return _stripe_product(kern, rp[0], lr[0], bc[0], bv[0], b_full,
                               rows_per, sc[0])

    fn = jax.shard_map(
        stripe_fn,
        mesh=mesh,
        in_specs=(P(axis),) * 5 + (b_spec,),
        out_specs=b_spec,
        check_vma=kern is None,
    )
    out = fn(rp, lr, bc, bv, sc, dense)[:n_rows].astype(jnp.float32)
    return out * col_scale[None, :] if int8_mode else out


@functools.partial(jax.jit, static_argnames="statics")
def _ring_run(statics, rp, lr, cc, bv, sc, cs, dense):
    (mesh, axis, feature_axis, rows_per, cpc, n, b, n_rows,
     k_padded, dtype_key, kern) = statics
    b_spec = P(axis, feature_axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    int8_mode = dtype_key == "int8"
    col_scale = None
    if int8_mode:
        dense, col_scale = _quantize_operand(dense, cs)
    elif dtype_key is not None:
        # same cast as _ag_run: without it the ring ppermute moves f32
        # (2x the documented link bytes) and the local kernels run mixed
        # bf16-blocks x f32-operand instead of the bf16 path
        dense = dense.astype(dtype_key)

    def stripe_fn(rp, lr, cc, bv, sc, b_local):
        rp, lr, cc, bv, sc = rp[0], lr[0], cc[0], bv[0], sc[0]  # (n, mb...)
        me = jax.lax.axis_index(axis)
        f_dim = b_local.shape[1]
        acc0 = jnp.zeros((rows_per * b, f_dim), jnp.float32)
        # mark the carry as device-varying so the fori_loop carry type
        # matches its (axis_index-dependent) output (shard_map vma rule);
        # it varies over the feature axis too when B is tp-sharded
        vary = (axis,) + ((feature_axis,) if feature_axis else ())
        acc0 = jax.lax.pcast(acc0, vary, to="varying")

        def step(s, carry):
            b_chunk, acc = carry
            c = jax.lax.rem(me - s + n, n)  # chunk currently held
            acc = acc + _stripe_product(
                kern, *(jnp.take(a, c, axis=0) for a in (rp, lr, cc, bv)),
                b_chunk, rows_per, jnp.take(sc, c, axis=0),
            )
            b_chunk = jax.lax.ppermute(b_chunk, axis, perm)
            return b_chunk, acc

        _, acc = jax.lax.fori_loop(0, n, step, (b_local, acc0))
        return acc

    fn = jax.shard_map(
        stripe_fn, mesh=mesh,
        in_specs=(P(axis),) * 5 + (b_spec,),
        out_specs=b_spec,
        check_vma=kern is None,
    )
    dense = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    dense = jax.lax.with_sharding_constraint(dense, NamedSharding(mesh, b_spec))
    out = fn(rp, lr, cc, bv, sc, dense)[:n_rows].astype(jnp.float32)
    return out * col_scale[None, :] if int8_mode else out


@functools.partial(jax.jit, static_argnames="statics")
def _halo_run(statics, rp, lr, cc, bv, sc, cs, bp_idx, out_idx, dense):
    (mesh, axis, feature_axis, rows_per, cpc, n, b, n_rows, k_padded,
     halo, dtype_key, kern) = statics
    b_spec = P(axis, feature_axis)
    width = 2 * halo + 1
    int8_mode = dtype_key == "int8"
    col_scale = None
    if int8_mode:
        dense, col_scale = _quantize_operand(dense, cs)
    elif dtype_key is not None:
        # same cast as _ag_run (halo ppermutes and local kernels must
        # see the documented dtype, not mixed bf16-blocks x f32-operand)
        dense = dense.astype(dtype_key)

    def stripe_fn(rp, lr, cc, bv, sc, b_local):
        rp, lr, cc, bv, sc = rp[0], lr[0], cc[0], bv[0], sc[0]
        out = jnp.zeros((rows_per * b, b_local.shape[1]), jnp.float32)
        for h in range(width):
            off = h - halo
            if off == 0:
                chunk = b_local
            else:
                perm_h = [(src, (src - off) % n) for src in range(n)]
                chunk = jax.lax.ppermute(b_local, axis, perm_h)
            out = out + _stripe_product(
                kern, rp[h], lr[h], cc[h], bv[h], chunk, rows_per, sc[h],
            )
        return out

    fn = jax.shard_map(
        stripe_fn, mesh=mesh,
        in_specs=(P(axis),) * 5 + (b_spec,),
        out_specs=b_spec,
        check_vma=kern is None,
    )
    if bp_idx is not None:
        # variable contiguous stripes (balanced_contiguous_boundaries):
        # build the uniform padded-stripe view of B — stripe s holds
        # B[bounds[s]*b : bounds[s+1]*b] padded to rows_per*b with the
        # appended zero row. One extra pass over B in device memory; the
        # halo exchange stays O(1) in mesh size.
        dz = jnp.pad(dense, ((0, 1), (0, 0)))
        dense = jnp.take(dz, bp_idx, axis=0)  # (n * rows_per * b, F)
    else:
        dense = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    dense = jax.lax.with_sharding_constraint(dense, NamedSharding(mesh, b_spec))
    out = fn(rp, lr, cc, bv, sc, dense).astype(jnp.float32)
    # caller-order rows: variable stripes need the index unpad
    out = out[:n_rows] if out_idx is None else jnp.take(out, out_idx, axis=0)
    return out * col_scale[None, :] if int8_mode else out


def _dist_bsr_apply(statics, arrays, dense):
    run, inner_statics, dtype_key = statics
    dense = jnp.asarray(dense)
    # the cast happens INSIDE the jitted run fn (one fused dispatch)
    return {"allgather": _ag_run, "ring": _ring_run, "halo": _halo_run}[run](
        inner_statics, *arrays, dense
    )


@functools.partial(jax.jit, static_argnames="statics")
def _undo_apply(statics, arrays, dense):
    """LPT-balance wrapper: inner plan on the permuted matrix, then gather
    output rows back to caller order — all inside the same program."""
    inner, undo = arrays
    return jnp.take(inner(dense), undo, axis=0)


def dist_bsr_spmm_plan(
    bsr: BSR,
    mesh: Optional[Mesh] = None,
    axis: str = "row",
    strategy: str = "allgather",
    dtype=None,
    feature_axis: Optional[str] = None,
    halo: int = 1,
    balance="auto",
    calibration=None,
    grad: bool = True,
):
    """Host shard prep once -> jitted C = f(B) over the mesh.

    Per-stripe compute: on a GPU the Pallas kernel
    (ops/bsr_spmm_pallas.py; f32 in IEEE f32), on a block grid it takes
    (power-of-two blocks, at least 16 wide, 32 for int8), walking each
    stripe's row pointers; elsewhere XLA's batched-matmul + segment-sum
    form (ops/bsr_spmm_xla.py). Each ring/halo chunk's partial product
    accumulates in f32.

    grad=True (default) makes the kernel's plan differentiable the way
    the single-card plan is: dB = A^T @ dC runs a second distributed
    plan on the transposed matrix, built here (ops/plan.grad_plan).
    XLA's form differentiates natively; int8 plans serve only.

    dtype=int8 (inference only): blocks quantized per block at plan
    time, the operand quantized ONCE globally per call with per-column
    symmetric scales (calibration= fixes them at plan time — the same
    contract as the other int8 tiers, ops/bsr_spmm_int8.py), and every
    collective (all_gather / ring ppermute / halo ppermute) moves int8 —
    4x fewer link bytes than f32. int8 x int8 -> int32.

    B may be passed with any sharding (it is constrained to the row-
    sharded layout on entry); C comes back row-sharded over `axis`.
    With feature_axis set (2D mesh), B's feature dim is additionally
    sharded over that axis (tensor parallelism): every collective stays
    within its own mesh axis, so the "row" exchange never touches the
    feature-parallel groups.

    balance: LPT block-row balancing (balanced_block_row_permutation),
    applied transparently — the permuted matrix is sharded, and the
    output rows are gathered back to caller order inside the same jit.
    "auto" (default) fires when the contiguous partition's stripe loads
    are >1.25x imbalanced AND the matrix is not halo-eligible (the LPT
    permutation scatters block-rows, which would destroy the banded
    structure that gives halo its O(1) comms). True forces it, False
    disables. Community-reordered graphs are DELIBERATELY non-uniform
    (SURVEY.md §7); this is the distributed answer.
    """
    if mesh is None:
        mesh = make_mesh_1d()
    dtype_key = None if dtype is None else jnp.dtype(dtype).name
    int8_mode = dtype_key == "int8"
    # the stripes' product: the kernel on a GPU, where XLA's plain form
    # does not finish compiling at thousands of blocks (PERF.md)
    kern = pallas_interpret() if on_gpu() else None
    if kern is not None:
        from spmm_denseblock_tpu.ops.bsr_spmm_pallas import (
            MIN_BLOCK,
            MIN_BLOCK_INT8,
            kernel_layout,
            pow2_blocks,
        )

        bsr = kernel_layout(pow2_blocks(bsr),
                            MIN_BLOCK_INT8 if int8_mode else MIN_BLOCK)
        if grad and not int8_mode:
            kw = dict(mesh=mesh, axis=axis, strategy=strategy, dtype=dtype,
                      feature_axis=feature_axis, halo=halo, balance=balance,
                      calibration=calibration, grad=False)
            return grad_plan(dist_bsr_spmm_plan(bsr, **kw),
                             dist_bsr_spmm_plan(bsr.transpose(), **kw))

    # Metadata-only shard/bucket/pack: every layout stage runs on an
    # 8-byte index payload instead of the (nnzb, b, b) value array, and
    # the values are gathered once into the final packed layout
    # (shard.block_index_payload docstring).
    from spmm_denseblock_tpu.parallel.shard import (
        block_index_payload,
        materialize_packed,
    )

    _payload = block_index_payload(bsr.nnzb)
    _blocks_src = np.asarray(bsr.blocks[: bsr.nnzb])

    sh_bal, bounds = None, None
    if (
        balance
        and strategy in ("auto", "halo")
        and bsr.shape[0] == bsr.shape[1]
    ):
        # contiguous equal-load stripes FIRST: unlike LPT (which
        # scatters block-rows and destroys bandedness), prefix-sum
        # boundaries keep row order, so an imbalanced BANDED graph gets
        # both load balance and halo's O(1) comms.
        n_dev = int(mesh.shape[axis])
        nbr = bsr.n_block_rows
        counts = np.bincount(
            np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr
        ).astype(np.int64)
        rows_per0 = -(-nbr // n_dev)
        pad = n_dev * rows_per0 - nbr
        loads = np.pad(counts, (0, pad)).reshape(n_dev, rows_per0).sum(1)
        imb = loads.max() / max(loads.mean(), 1e-9)
        if balance == "contiguous" or imb > 1.25:
            cand = balanced_contiguous_boundaries(bsr, n_dev)
            sh_c = shard_bsr(bsr, n_dev, boundaries=cand, payload=_payload)
            if bucket_halo(sh_c, halo) is not None:
                sh_bal, bounds, strategy = sh_c, cand, "halo"

    if balance and strategy != "halo":
        n_dev = int(mesh.shape[axis])
        nbr = bsr.n_block_rows
        counts = np.bincount(
            np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr
        ).astype(np.int64)
        rows_per0 = -(-nbr // n_dev)
        pad = n_dev * rows_per0 - nbr
        stripe_loads = np.pad(counts, (0, pad)).reshape(n_dev, rows_per0).sum(1)
        imbalance = stripe_loads.max() / max(stripe_loads.mean(), 1e-9)
        halo_eligible = (
            strategy in ("auto",)
            and bucket_halo(shard_bsr(bsr, n_dev, payload=_payload), halo)
            is not None
        )
        if balance is True or (imbalance > 1.25 and not halo_eligible):
            perm = balanced_block_row_permutation(bsr, n_dev)
            b = bsr.b
            # LPT assigns into n_dev stripes of rows_per0 slots each —
            # the permuted grid must cover ALL slots (perm values reach
            # n_dev*rows_per0 - 1 when nbr doesn't divide the mesh)
            nbr_pad = n_dev * rows_per0
            permuted = BSR.from_parts(
                perm[np.asarray(bsr.block_rows[: bsr.nnzb])].astype(np.int32),
                np.asarray(bsr.block_cols[: bsr.nnzb]),
                np.asarray(bsr.blocks[: bsr.nnzb]),
                (nbr_pad * b, bsr.shape[1]),
                b,
            )
            inner = dist_bsr_spmm_plan(
                permuted, mesh=mesh, axis=axis, strategy=strategy,
                dtype=dtype, feature_axis=feature_axis,
                halo=halo, balance=False, calibration=calibration,
                grad=False,
            )
            rows = np.arange(bsr.shape[0], dtype=np.int64)
            undo = jnp.asarray(
                (perm[rows // b] * b + rows % b).astype(np.int32)
            )
            return Plan((inner, undo), _undo_apply)
    n = int(mesh.shape[axis])
    b = bsr.b
    sh = sh_bal if sh_bal is not None else shard_bsr(bsr, n, payload=_payload)
    if strategy == "auto":
        # halo when the (reordered) matrix is banded enough for O(1)
        # neighbor exchange; else the one-collective allgather
        strategy = "halo" if bucket_halo(sh, halo) is not None else "allgather"
    rows_per, cpc = sh.rows_per_shard, sh.col_chunk
    k_padded = n * cpc * b
    n_rows, n_cols = bsr.shape

    stripe = NamedSharding(mesh, P(axis))
    if calibration is not None and not int8_mode:
        raise ValueError(
            "calibration= only applies to dtype=int8 serving plans; "
            f"got dtype={dtype_key!r}"
        )
    cs = None
    if int8_mode and calibration is not None:
        from spmm_denseblock_tpu.ops.bsr_spmm_int8 import static_col_scale

        cs = jnp.asarray(static_col_scale(calibration))

    def put_blocks(idx_payload):
        """Takes the PACKED INDEX PAYLOAD (..., 1, 1) from the
        metadata-only pipeline and materializes device blocks from the
        source values in one gather. Returns (bv_dev, sc_dev); sc is a
        per-stripe dummy (leading dims kept, block dims dropped to 1)
        when not int8 so every strategy shares one shard_map arity and
        indexing pattern.

        int8 mode quantizes the UNPADDED source list once
        (quantize_blocks scheme) and gathers int8 + per-slot scales
        through the payload — 4x less gather traffic than
        materialize-then-quantize; pad slots get (q=0, s=1)."""
        idx = np.asarray(idx_payload)[..., 0, 0]
        if int8_mode:
            from spmm_denseblock_tpu.ops.bsr_spmm_int8 import (
                quantize_blocks,
            )

            q_src, s_src = quantize_blocks(_blocks_src)
            nz = idx > 0
            q = np.zeros(idx.shape + (b, b), np.int8)
            q[nz] = q_src[idx[nz] - 1]
            s = np.ones(idx.shape, np.float32)
            s[nz] = s_src[idx[nz] - 1]
            return (jax.device_put(jnp.asarray(q), stripe),
                    jax.device_put(jnp.asarray(s), stripe))
        # float path: cast the SOURCE list to the plan dtype on host
        # first (one pass over the unpadded list), then gather — the
        # packed bf16 array ships half the bytes of gather-then-cast.
        # numpy's ml_dtypes bf16 cast and XLA's convert are both
        # round-to-nearest-even, so values are identical.
        src = _blocks_src
        if dtype is not None:
            src = src.astype(jnp.dtype(dtype))
        bv_h = materialize_packed(idx_payload, src)
        sc = jax.device_put(
            jnp.zeros(bv_h.shape[:-3] + (1,), jnp.float32), stripe
        )
        return jax.device_put(jnp.asarray(bv_h), stripe), sc

    def put_row_ptrs(local_rows, idx_payload):
        return jax.device_put(
            _row_ptrs(local_rows, idx_payload, rows_per), stripe)

    if strategy == "allgather":
        rp = put_row_ptrs(sh.local_rows, sh.blocks)
        lr = jax.device_put(sh.local_rows, stripe)
        bc = jax.device_put(sh.block_cols, stripe)
        bv, sc = put_blocks(sh.blocks)
        inner = (mesh, axis, feature_axis, rows_per, cpc, n, b, n_rows,
                 k_padded, dtype_key, kern)
        return Plan((rp, lr, bc, bv, sc, cs), _dist_bsr_apply,
                    ("allgather", inner, dtype_key))

    if strategy == "ring":
        lr_b, cc_b, bv_b = bucket_by_col_chunk(sh)  # (n, n, mb, ...)
        rp = put_row_ptrs(lr_b, bv_b)
        lr = jax.device_put(lr_b, stripe)
        cc = jax.device_put(cc_b, stripe)
        bv, sc = put_blocks(bv_b)
        inner = (mesh, axis, feature_axis, rows_per, cpc, n, b, n_rows,
                 k_padded, dtype_key, kern)
        return Plan((rp, lr, cc, bv, sc, cs), _dist_bsr_apply,
                    ("ring", inner, dtype_key))

    if strategy == "halo":
        # true halo exchange: each stripe receives only its 2*halo
        # neighbor chunks of B (O(1) comms in mesh size) — valid when the
        # (reordered) matrix is banded enough that every block's column
        # falls within its stripe's halo; falls back to allgather when not.
        buckets = bucket_halo(sh, halo)
        if buckets is None:
            return dist_bsr_spmm_plan(
                bsr, mesh=mesh, axis=axis, strategy="allgather",
                dtype=dtype, feature_axis=feature_axis,
                calibration=calibration, grad=False,
            )  # matrix not banded within the requested halo
        lr_b, cc_b, bv_b = buckets  # (n, 2h+1, mb, ...)
        rp = put_row_ptrs(lr_b, bv_b)
        lr = jax.device_put(lr_b, stripe)
        cc = jax.device_put(cc_b, stripe)
        bv, sc = put_blocks(bv_b)
        bp_d = oi_d = None
        if sh.boundaries is not None:
            # variable contiguous stripes: index maps for the padded
            # B-stripe view and the caller-order output unpad
            bounds = np.asarray(sh.boundaries)
            bp = np.full((n, rows_per * b), n_cols, np.int64)
            for s in range(n):
                g0, g1 = int(bounds[s]) * b, int(bounds[s + 1]) * b
                seg = np.arange(g0, g1, dtype=np.int64)
                bp[s, : g1 - g0] = np.where(seg >= n_cols, n_cols, seg)
            rows_all = np.arange(n_rows, dtype=np.int64)
            s_of = np.searchsorted(bounds, rows_all // b, side="right") - 1
            oi = s_of * rows_per * b + (rows_all - bounds[s_of] * b)
            bp_d = jax.device_put(
                jnp.asarray(bp.reshape(-1).astype(np.int32)), stripe
            )
            oi_d = jnp.asarray(oi.astype(np.int32))
        inner = (mesh, axis, feature_axis, rows_per, cpc, n, b, n_rows,
                 k_padded, halo, dtype_key, kern)
        return Plan((rp, lr, cc, bv, sc, cs, bp_d, oi_d), _dist_bsr_apply,
                    ("halo", inner, dtype_key))

    raise ValueError(
        f"unknown strategy {strategy!r}; use 'allgather', 'ring', or 'halo'"
    )


def _ell_layout_stripes(csr: CSR, n_shards: int, compact: str = "off",
                        compact_slots: int = None, itemsize: int = 4,
                        feat_dim: int = 128):
    """Cross-stripe-uniform degree-bucketed ELL layouts for shard_map.

    shard_map traces ONE program for every device, so per-stripe layouts
    must agree statically: each degree class K is padded to its maximum
    row count over all stripes (capacity), and every stripe carries the
    same (slots,) index buffer with pad slots pointing at column n_cols
    (a zero row of the padded operand — no zero-row concat on device).

    Returns (idx, vals, positions, layout, has_vals, uniq): idx/vals
    are (n_shards, slots); positions (n_shards, rows_per) maps each
    local row to its row in the class-concatenated output; layout is
    the shared tuple of (m, K, u) chunks (same CHUNK_SLOTS splitting as
    the single-chip tier, ops/csr_spmm_ell.py). u > 0 marks a chunk the
    two-level compaction chose (compact="auto"/"force", same byte-rate
    model as the single-chip tier): that chunk's idx slots hold LOCAL
    positions into its uniq row-slice, `uniq` is the (n_shards, sum_u)
    concatenation of per-chunk unique column ids, padded per stripe to
    the cross-stripe max with the zero-row id n_cols (shard_map traces
    one program, so capacities must agree — the uniform-capacity trick
    the class layouts already use)."""
    from spmm_denseblock_tpu.ops.csr_spmm_ell import CHUNK_SLOTS, _row_widths
    from spmm_denseblock_tpu.reorder.simple import _ragged_arange

    n_rows, n_cols = csr.shape
    rows_per = -(-n_rows // n_shards)
    n_tot = n_shards * rows_per
    indptr = np.asarray(csr.indptr, np.int64)
    deg = np.zeros(n_tot, np.int64)
    deg[:n_rows] = np.diff(indptr)
    cols = np.asarray(csr.indices, np.int64)
    has_vals = csr.data is not None
    vals = np.asarray(csr.data, np.float32) if has_vals else None

    # quarter-step classes (see ops/csr_spmm_ell._row_widths): ~18%
    # fewer padded slots than pow2 at products scale, and the finer
    # classes also shrink the cross-stripe max-capacity padding
    K_r = _row_widths(deg, "quarter").reshape(n_shards, rows_per)
    Ks = np.unique(K_r)
    counts = np.stack([(K_r == K).sum(axis=1) for K in Ks], axis=1)
    caps = counts.max(axis=0)  # class capacity = max count over stripes

    slot_off = np.concatenate([[0], np.cumsum(caps * Ks)])
    cat_off = np.concatenate([[0], np.cumsum(caps)])
    slots = int(slot_off[-1])

    idx = np.full((n_shards, slots), n_cols, dtype=np.int32)
    val = np.zeros((n_shards, slots), np.float32) if has_vals else None
    pos = np.zeros((n_shards, rows_per), np.int32)
    starts = np.zeros(n_tot, np.int64)
    starts[:n_rows] = indptr[:-1]
    for s in range(n_shards):
        for j, K in enumerate(Ks):
            loc = np.nonzero(K_r[s] == K)[0]
            if loc.size == 0:
                continue
            g_rows = s * rows_per + loc
            d = deg[g_rows]
            base = slot_off[j] + np.arange(loc.size, dtype=np.int64) * K
            tgt = np.repeat(base, d) + _ragged_arange(d)
            src = np.repeat(starts[g_rows], d) + _ragged_arange(d)
            idx[s, tgt] = cols[src]
            if has_vals:
                val[s, tgt] = vals[src]
            pos[s, loc] = cat_off[j] + np.arange(loc.size, dtype=np.int64)

    if compact not in ("off", "auto", "force"):
        raise ValueError(f"unknown compact mode: {compact!r}")
    from spmm_denseblock_tpu.ops.csr_spmm_ell import (
        COMPACT_SLOTS,
        _COMPACT_MIN_GAIN,
        _gather_ns_per_slot,
    )

    span = CHUNK_SLOTS
    if compact != "off":
        span = min(CHUNK_SLOTS, compact_slots or COMPACT_SLOTS)
    layout = []
    for j, K in enumerate(Ks):
        max_m = max(1, span // int(K))
        m_k = int(caps[j])
        for t in range(0, m_k, max_m):
            layout.append((int(min(max_m, m_k - t)), int(K)))

    if compact == "off":
        layout = tuple((m, K, 0) for m, K in layout)
        return idx, val, pos, layout, has_vals, np.zeros((n_shards, 1),
                                                         np.int32)

    from spmm_denseblock_tpu import native

    # every stripe gathers from the all-gathered FULL table, so the
    # big/small rate brackets are exactly the single-chip ones
    r_big = _gather_ns_per_slot((n_cols + 1) * feat_dim * itemsize, itemsize)
    n_vals = n_cols + 1  # pad slots hold n_cols (the zero row)
    out_layout, uniq_parts = [], []
    off = 0
    for m, K in layout:
        S = m * K
        us, invs = [], []
        for sh in range(n_shards):
            seg = idx[sh, off: off + S]
            res = native.unique_inverse(seg, n_vals)
            u, inv = res if res is not None else np.unique(
                seg, return_inverse=True
            )
            us.append(u)
            invs.append(inv)
        u_cap = max(u.size for u in us)
        r_sub = _gather_ns_per_slot(u_cap * feat_dim * itemsize, itemsize)
        win = u_cap * r_big + S * r_sub <= _COMPACT_MIN_GAIN * S * r_big
        if compact == "force" or win:
            arr = np.full((n_shards, u_cap), n_cols, np.int32)
            for sh in range(n_shards):
                arr[sh, : us[sh].size] = us[sh]
                idx[sh, off: off + S] = invs[sh].astype(np.int32)
            uniq_parts.append(arr)
            out_layout.append((m, K, int(u_cap)))
        else:
            out_layout.append((m, K, 0))
        off += S
    uniq = (
        np.concatenate(uniq_parts, axis=1)
        if uniq_parts
        else np.zeros((n_shards, 1), np.int32)
    )
    return idx, val, pos, tuple(out_layout), has_vals, uniq


@functools.partial(jax.jit, static_argnames="statics")
def _dist_ell_run(statics, idx, val, pos, col_scale, uniq, dense):
    (mesh, axis, layout, has_vals, dtype_key, n_rows, k_padded) = statics
    stripe = NamedSharding(mesh, P(axis))
    int8_mode = dtype_key == "int8"

    def stripe_fn(idx, val, pos, uniq, b_local):
        if dtype_key is not None and not int8_mode:
            b_local = b_local.astype(dtype_key)
        b_full = jax.lax.all_gather(b_local, axis, tiled=True)
        outs = []
        off = 0
        uoff = 0
        for m, K, u in layout:
            if u:
                # two-level: one big-table gather of the chunk's unique
                # rows, then the slot gather reads the compact sub-table
                # at the small-table rate (pad rows re-read the zero row)
                urow = jax.lax.dynamic_slice_in_dim(uniq[0], uoff, u)
                src = jnp.take(b_full, urow, axis=0)
                uoff += u
            else:
                src = b_full
            sl = jax.lax.dynamic_slice_in_dim(idx[0], off, m * K)
            g = jnp.take(src, sl, axis=0)
            if g.dtype == jnp.int8:
                # int8 pays in the all_gather (4x fewer link bytes vs f32) and
                # the HBM gather; widen for the value multiply/sum
                g = g.astype(jnp.float32)
            if has_vals:
                v = jax.lax.dynamic_slice_in_dim(val[0], off, m * K)
                g = g * v[:, None].astype(g.dtype)
            outs.append(
                g.reshape(m, K, b_full.shape[1]).sum(axis=1, dtype=jnp.float32)
            )
            off += m * K
        cat = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
        return jnp.take(cat, pos[0], axis=0)

    fn = jax.shard_map(
        stripe_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis, None)),
        out_specs=P(axis, None),
    )
    dense = dense.astype(jnp.float32)
    if int8_mode:
        # quantize ONCE globally (same per-column symmetric scheme as
        # ops/bsr_spmm_int8.py) so every stripe shares the scales; the
        # padded zero rows stay zero in q
        from spmm_denseblock_tpu.ops.bsr_spmm_int8 import (
            quantize_per_column,
        )

        dense, col_scale = quantize_per_column(dense, col_scale)
    dense = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    dense = jax.lax.with_sharding_constraint(dense, stripe)
    out = fn(idx, val, pos, uniq, dense)[:n_rows]
    if int8_mode:
        out = out * col_scale[None, :]
    return out


def _dist_ell_apply(statics, arrays, dense):
    return _dist_ell_run(statics, *arrays, jnp.asarray(dense))


@functools.partial(jax.jit, static_argnames="statics")
def _dist_segment_run(statics, lr, ci, va, dense):
    (mesh, axis, rows_per, n_rows, k_padded) = statics
    stripe = NamedSharding(mesh, P(axis))

    def stripe_fn(lr, ci, va, b_local):
        b_full = jax.lax.all_gather(b_local, axis, tiled=True)
        gathered = jnp.take(b_full, ci[0], axis=0) * va[0][:, None]
        return jax.ops.segment_sum(gathered, lr[0], num_segments=rows_per)

    fn = jax.shard_map(
        stripe_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis, None)),
        out_specs=P(axis, None),
    )
    dense = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    dense = jax.lax.with_sharding_constraint(dense, stripe)
    return fn(lr, ci, va, dense)[:n_rows].astype(jnp.float32)


def _dist_segment_apply(statics, arrays, dense):
    return _dist_segment_run(statics, *arrays, jnp.asarray(dense))


@functools.partial(jax.jit, static_argnames="statics")
def _dist_win_run(statics, tiles, sc, cs, win, dense):
    (mesh, axis, R, W, K, tiles_per, k_padded, n_rows, dtype_key) = statics
    int8_mode = dtype_key == "int8"
    prec = (
        jax.lax.Precision.HIGHEST
        if dtype_key is None
        else jax.lax.Precision.DEFAULT
    )

    def stripe_fn(tiles, sc, win, b_local):
        b_full = jax.lax.all_gather(b_local, axis, tiled=True)
        blocked = b_full.reshape(k_padded // W, W, b_full.shape[1])
        wins = jnp.take(blocked, win, axis=0)  # (tiles_per, K, W, F)
        out = jax.lax.dot_general(
            tiles,
            wins,
            dimension_numbers=(((3,), (2,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.int32 if int8_mode else jnp.float32,
            precision=None if int8_mode else prec,
        )
        if int8_mode:  # (tiles_per, K, R, F) int32 * per-(tile,slot) scale
            out = out.astype(jnp.float32) * sc[:, :, None, None]
        return jnp.sum(out, axis=1).reshape(tiles_per * R, b_full.shape[1])

    fn = jax.shard_map(
        stripe_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis, None)),
        out_specs=P(axis, None),
    )
    col_scale = None
    if int8_mode:
        dense, col_scale = _quantize_operand(dense, cs)
    d = jnp.pad(dense, ((0, k_padded - dense.shape[0]), (0, 0)))
    if dtype_key is not None and not int8_mode:
        d = d.astype(dtype_key)
    d = jax.lax.with_sharding_constraint(d, NamedSharding(mesh, P(axis, None)))
    out = fn(tiles, sc, win, d)[:n_rows].astype(jnp.float32)
    return out * col_scale[None, :] if int8_mode else out


def _dist_win_apply(statics, arrays, dense):
    return _dist_win_run(statics, *arrays, jnp.asarray(dense))


def dist_csr_spmm_ell_plan(
    csr: CSR, mesh: Optional[Mesh] = None, axis: str = "row", dtype=None,
    calibration=None, compact: str = "off", compact_slots: int = None,
    feat_dim: int = 128,
):
    """Row-partitioned ELL SpMM: the scatter-free degree-bucketed tier
    (2.5x over gather+segment-sum single-chip, ops/csr_spmm_ell.py)
    distributed via shard_map. B is cast to `dtype` BEFORE the tiled
    all_gather, so bf16 serving also halves the exchanged bytes —
    and dtype=int8 (inference only) quarters them vs f32: the operand
    is quantized ONCE globally with per-column symmetric scales
    (calibration= for static serving scales, else one absmax pass per
    call) and both the all_gather and the HBM row gathers move int8.
    compact="auto"/"force": per-stripe-chunk two-level gathers — every
    stripe reads the all-gathered FULL table, so the single-chip
    compaction model applies verbatim (see ops/csr_spmm_ell); uniform
    cross-stripe unique capacities keep shard_map's one-program rule.
    Returns a Plan pytree (sharded arrays as leaves)."""
    if mesh is None:
        mesh = make_mesh_1d()
    n = int(mesh.shape[axis])
    n_rows, n_cols = csr.shape
    # pad strictly past n_cols so index n_cols is a guaranteed-zero row
    k_padded = -(-(n_cols + 1) // n) * n
    itemsize = (
        1 if (dtype is not None and jnp.dtype(dtype) == jnp.int8)
        else (4 if dtype is None else jnp.dtype(dtype).itemsize)
    )
    idx, val, pos, layout, has_vals, uniq = _ell_layout_stripes(
        csr, n, compact, compact_slots, itemsize, feat_dim
    )

    stripe = NamedSharding(mesh, P(axis))
    idx_d = jax.device_put(idx, stripe)
    val_d = jax.device_put(
        val if has_vals else np.zeros((n, 1), np.float32), stripe
    )
    pos_d = jax.device_put(pos, stripe)
    dtype_key = None if dtype is None else jnp.dtype(dtype).name
    cs = None
    if calibration is not None:
        if dtype_key != "int8":
            raise ValueError(
                "calibration= only applies to dtype=int8 serving plans; "
                f"got dtype={dtype_key!r}"
            )
        from spmm_denseblock_tpu.ops.bsr_spmm_int8 import static_col_scale

        cs = jnp.asarray(static_col_scale(calibration))
    uniq_d = jax.device_put(uniq, stripe)
    statics = (mesh, axis, layout, has_vals, dtype_key, n_rows, k_padded)
    return Plan((idx_d, val_d, pos_d, cs, uniq_d), _dist_ell_apply, statics)


def dist_csr_spmm_plan(
    csr: CSR, mesh: Optional[Mesh] = None, axis: str = "row",
    impl: str = "ell", dtype=None, calibration=None, **ell_kw,
):
    """Row-partitioned element-sparse SpMM. impl="ell" (default) is the
    scatter-free degree-bucketed tier (extra kwargs — compact,
    compact_slots, feat_dim — reach it); impl="segment" keeps the
    original per-stripe gather + segment-sum after a tiled all_gather
    of B."""
    if impl == "ell":
        return dist_csr_spmm_ell_plan(csr, mesh=mesh, axis=axis, dtype=dtype,
                                      calibration=calibration, **ell_kw)
    if ell_kw:
        raise TypeError(f"impl={impl!r} takes no extra kwargs: {ell_kw}")
    assert impl == "segment", impl
    if mesh is None:
        mesh = make_mesh_1d()
    n = int(mesh.shape[axis])
    sh = shard_csr(csr, n)
    n_rows, n_cols = csr.shape
    k_padded = -(-n_cols // n) * n

    stripe = NamedSharding(mesh, P(axis))
    lr = jax.device_put(sh.local_rows, stripe)
    ci = jax.device_put(sh.col_ids, stripe)
    va = jax.device_put(sh.vals, stripe)
    statics = (mesh, axis, sh.rows_per_shard, n_rows, k_padded)
    return Plan((lr, ci, va), _dist_segment_apply, statics)


def dist_hybrid_spmm_plan(
    hyb,
    mesh: Optional[Mesh] = None,
    axis: str = "row",
    strategy: str = "allgather",
    dtype=None,
    calibration=None,
):
    """Distributed hybrid: dense-block stripes + remainder-CSR stripes,
    summed on device (divide.cu's two accumulating kernels, sharded).
    Both parts use the same row partition, so the sum is local. dtype
    (incl. int8 + calibration) reaches both parts."""
    if mesh is None:
        mesh = make_mesh_1d()
    from spmm_denseblock_tpu.formats.hybrid import Hybrid

    assert isinstance(hyb, Hybrid)
    if hyb.dense.nnzb == 0:
        return dist_csr_spmm_plan(
            hyb.remainder, mesh=mesh, axis=axis, dtype=dtype,
            calibration=calibration,
        )
    bsr_run = dist_bsr_spmm_plan(
        hyb.dense, mesh=mesh, axis=axis, strategy=strategy, dtype=dtype,
        calibration=calibration,
    )
    if hyb.remainder.nnz == 0:
        return bsr_run
    csr_run = dist_csr_spmm_plan(
        hyb.remainder, mesh=mesh, axis=axis, dtype=dtype,
        calibration=calibration,
    )
    # both parts are Plan pytrees on the same row partition: the generic
    # sum composition keeps the whole thing a Plan (passable through jit
    # boundaries without HLO-constant blowup)
    return sum_plan((bsr_run, csr_run))


def balanced_block_row_permutation(bsr: BSR, n_shards: int) -> "np.ndarray":
    """LPT (longest-processing-time) assignment of block-rows to stripes:
    returns old2new over BLOCK-ROW ids such that contiguous equal-size
    stripes of the permuted matrix have near-equal nnzb. The distributed
    answer to per-shard nnz imbalance on community-reordered graphs
    (SURVEY.md §7 "halo exchange overlap ... deliberately non-uniform").
    """
    nbr = bsr.n_block_rows
    rows_per = -(-nbr // n_shards)
    counts = np.bincount(
        np.asarray(bsr.block_rows[: bsr.nnzb]), minlength=nbr
    ).astype(np.int64)
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    fill = np.zeros(n_shards, dtype=np.int64)
    assign = np.empty(nbr, dtype=np.int64)
    for r in order:
        open_shards = np.nonzero(fill < rows_per)[0]
        s = open_shards[np.argmin(load[open_shards])]
        assign[r] = s * rows_per + fill[s]
        fill[s] += 1
        load[s] += counts[r]
    return assign


def dist_windowed_spmm_plan(
    wt,
    mesh: Optional[Mesh] = None,
    axis: str = "row",
    dtype=None,
    calibration=None,
):
    """Distributed windowed dense-tile SpMM: row-band tiles stripe
    contiguously over `axis` (tile t covers rows [t*R, (t+1)*R), so
    stripes need no index translation); each stripe all-gathers B and
    takes its contiguous windows; the remainder CSR rides the existing
    row-partitioned ELL plan on the same mesh (dtype forwarded, so bf16
    and int8 shrink the remainder's exchange too).

    dtype=int8 (inference only): tiles quantized per (tile, slot) at
    plan time (the windowed_spmm_int8_plan scheme), one global
    per-column operand quantization per call (calibration= makes the
    scales plan constants), int8 all_gather."""
    from spmm_denseblock_tpu.formats.windowed import Windowed

    assert isinstance(wt, Windowed)
    if mesh is None:
        mesh = make_mesh_1d()
    n = int(mesh.shape[axis])
    R, W = wt.tile_rows, wt.window
    n_rows, n_cols = wt.shape
    T = wt.n_tiles
    tiles_per = -(-T // n)
    k_padded = -(-n_cols // W) * W

    # pad tile arrays so each stripe owns tiles_per tiles
    pad_t = n * tiles_per - T
    K = wt.n_windows_per_tile
    tiles_h = np.asarray(wt.tiles)
    win_h = np.asarray(wt.win_idx)
    if pad_t:
        tiles_h = np.concatenate(
            [tiles_h, np.zeros((pad_t, K, R, W), tiles_h.dtype)]
        )
        win_h = np.concatenate(
            [win_h, np.zeros((pad_t, K), win_h.dtype)]
        )
    dtype_key = None if dtype is None else jnp.dtype(dtype).name
    int8_mode = dtype_key == "int8"
    if calibration is not None and not int8_mode:
        raise ValueError(
            "calibration= only applies to dtype=int8 serving plans; "
            f"got dtype={dtype_key!r}"
        )
    cs = None
    if int8_mode:
        from spmm_denseblock_tpu.ops.bsr_spmm_int8 import (
            quantize_blocks,
            static_col_scale,
        )

        T_pad = tiles_h.shape[0]
        q, s = quantize_blocks(
            np.asarray(tiles_h, np.float32).reshape(T_pad * K, R, W)
        )
        tiles_h = q.reshape(T_pad, K, R, W)
        sc_h = s.reshape(T_pad, K).astype(np.float32)
        if calibration is not None:
            cs = jnp.asarray(static_col_scale(calibration))
    else:
        if dtype is not None:
            tiles_h = tiles_h.astype(dtype)
        sc_h = np.zeros((tiles_h.shape[0], 1), np.float32)

    stripe = NamedSharding(mesh, P(axis))
    tiles_d = jax.device_put(jnp.asarray(tiles_h), stripe)
    sc_d = jax.device_put(jnp.asarray(sc_h), stripe)
    win_d = jax.device_put(jnp.asarray(win_h), stripe)

    statics = (mesh, axis, R, W, K, tiles_per, k_padded, n_rows, dtype_key)
    win_plan = Plan((tiles_d, sc_d, cs, win_d), _dist_win_apply, statics)
    if not wt.remainder.nnz:
        return win_plan
    rem_plan = dist_csr_spmm_plan(
        wt.remainder, mesh=mesh, axis=axis, dtype=dtype,
        calibration=calibration if int8_mode else None,
    )
    return sum_plan((win_plan, rem_plan))


def dist_sddmm_plan(csr: CSR, mesh: Optional[Mesh] = None, axis: str = "row"):
    """Distributed SDDMM: edges row-partitioned with their stripe's x
    rows local; y all-gathered once. e = f(x, y) comes back with each
    stripe owning its edges' scores (concatenated in global edge order
    because stripes are contiguous row ranges)."""
    if mesh is None:
        mesh = make_mesh_1d()
    n = int(mesh.shape[axis])
    sh = shard_csr(csr, n)
    rows_per = sh.rows_per_shard
    n_rows, n_cols = csr.shape
    r_padded = n * rows_per
    k_padded = -(-n_cols // n) * n
    m = sh.local_rows.shape[1]

    stripe = NamedSharding(mesh, P(axis))
    lr = jax.device_put(sh.local_rows, stripe)
    ci = jax.device_put(sh.col_ids, stripe)
    # padding entries must not produce scores: mask from the real counts
    mask_h = np.zeros((n, m), dtype=np.float32)
    counts = np.bincount(csr.row_ids() // rows_per, minlength=n)
    for s in range(n):
        mask_h[s, : counts[s]] = 1.0
    mk = jax.device_put(mask_h, stripe)

    def stripe_fn(lr, ci, mk, x_local, y_local):
        y_full = jax.lax.all_gather(y_local, axis, tiled=True)
        xg = jnp.take(x_local, lr[0], axis=0)  # local stripe rows
        yg = jnp.take(y_full, ci[0], axis=0)
        return (jnp.sum(xg * yg, axis=-1) * mk[0])[None, :]

    fn = jax.shard_map(
        stripe_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis, None), P(axis, None)),
        out_specs=P(axis),
    )

    # stripes are contiguous row ranges and slots keep row-major order,
    # so selecting the real slots reassembles the global edge order
    real_slots = jnp.asarray(
        np.nonzero(mask_h.ravel() > 0)[0].astype(np.int64)
    )

    @jax.jit
    def run_impl(lr, ci, mk, real_slots, x, y):
        x = jnp.pad(x, ((0, r_padded - x.shape[0]), (0, 0)))
        y = jnp.pad(y, ((0, k_padded - y.shape[0]), (0, 0)))
        x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P(axis, None)))
        y = jax.lax.with_sharding_constraint(y, NamedSharding(mesh, P(axis, None)))
        flat = fn(lr, ci, mk, x, y).reshape(-1)
        return flat[real_slots]

    return lambda x, y: run_impl(
        lr, ci, mk, real_slots, jnp.asarray(x), jnp.asarray(y)
    )
