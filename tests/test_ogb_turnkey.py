"""Real-OGB turnkey contract.

Everything ever benchmarked in this repo says source=synthetic_fallback
— the environment has no egress and no ogb package. This module is the
zero-new-code conversion path: the FIRST environment with network + ogb
runs these tests and turns the "matches the reference on the OGB test
matrices" claim (BASELINE.json) into a measurement:

  1. download ogbn-arxiv through the same _load_ogb path load_dataset
     uses (reference parity: /root/reference/download_ogb.py:4-33);
  2. check n exactly and the symmetrized nnz against the hardcoded
     size table (io/datasets.DATASET_SIZES carries the reference's
     directed edge counts, e.g. greedy_neighbor.cpp:8-9);
  3. run the cross-oracle conformance gate (scipy vs the auto route,
     f32 1e-4 — check_result.cu:233-246 discipline);
  4. record one auto-route benchmark number.

Skips cleanly when ogb/network are absent (today's state).
"""

import numpy as np
import pytest


def _ogb_available() -> bool:
    try:
        import ogb  # noqa: F401
    except Exception:
        return False
    import socket

    try:
        # OGB downloads come from snap.stanford.edu; any resolvable +
        # connectable host is the cheap proxy for "egress exists"
        socket.create_connection(("snap.stanford.edu", 443), timeout=5).close()
        return True
    except OSError:
        return False


pytestmark = pytest.mark.skipif(
    not _ogb_available(),
    reason="ogb package or network egress unavailable (synthetic-fallback "
    "environment); run in an egress-enabled env to convert the real-OGB "
    "claim",
)


@pytest.fixture(scope="module")
def arxiv_csr():
    from spmm_denseblock_tpu.io.datasets import _load_ogb

    return _load_ogb("ogbn-arxiv")


def test_arxiv_sizes_match_reference_table(arxiv_csr):
    from spmm_denseblock_tpu.io.datasets import DATASET_SIZES

    n_ref, m_ref = DATASET_SIZES["ogbn-arxiv"]
    assert arxiv_csr.n_rows == n_ref
    # _load_ogb symmetrizes and drops self-loops (download_ogb.py:12-27):
    # nnz lands in [directed, 2 * directed]
    assert m_ref <= arxiv_csr.nnz <= 2 * m_ref


def test_arxiv_conformance_gate(arxiv_csr):
    from spmm_denseblock_tpu.bench.harness import conformance_fields
    from spmm_denseblock_tpu.ops import spmm_plan
    from spmm_denseblock_tpu.ops.reference import spmm_scipy

    x = np.random.default_rng(0).standard_normal(
        (arxiv_csr.n_cols, 64)
    ).astype(np.float32)
    plan = spmm_plan(arxiv_csr, impl="auto", feat_dim=64, grad=False)
    got = np.asarray(plan(x), np.float32)
    conf = conformance_fields(got, spmm_scipy(arxiv_csr, x), "float32")
    assert conf["gate_ok"], conf


def test_arxiv_auto_benchmark_records(arxiv_csr, tmp_path):
    import json

    from spmm_denseblock_tpu.bench.harness import _time_spread
    from spmm_denseblock_tpu.ops import spmm_plan

    x = np.random.default_rng(0).standard_normal(
        (arxiv_csr.n_cols, 128)
    ).astype(np.float32)
    plan = spmm_plan(arxiv_csr, impl="auto", feat_dim=128, grad=False)
    t = _time_spread(plan, x, repeats=3)
    rec = {
        "kind": "ogb_real", "dataset": "ogbn-arxiv", "impl": "auto",
        "dim": 128, "n": arxiv_csr.n_rows, "nnz": arxiv_csr.nnz,
        "ms": t["secs"] * 1e3, "ms_min": t["secs_min"] * 1e3,
        "ms_max": t["secs_max"] * 1e3, "repeats": t["repeats"],
        "source": "ogb",
    }
    out = tmp_path / "ogb_real_arxiv.json"
    out.write_text(json.dumps(rec))
    assert t["secs"] > 0
