"""Bench harness smoke tests (CPU mesh; tiny configs, XLA impls only —
interpret-mode Pallas is too slow to time here)."""

import json

import numpy as np

from spmm_denseblock_tpu.bench import (
    bench_graph,
    bench_scaling,
    bench_synthetic_bsr,
    bench_synthetic_csr,
    bench_train_scaling,
)


def test_bench_synthetic_bsr_record():
    rec = bench_synthetic_bsr(0.05, 16, 32, impl="bsr_xla", n_block_rows=16)
    assert rec["gflops"] > 0 and rec["ms"] > 0
    assert 0 < rec["block_density"] <= 1
    assert rec["intensity_flop_per_byte"] > 0
    json.dumps(rec)


def test_bench_synthetic_csr_record():
    rec = bench_synthetic_csr(0.01, 16, impl="csr_xla", n_rows=512)
    assert rec["nnz_per_s"] > 0
    json.dumps(rec)


def test_bench_graph_record():
    rec = bench_graph(
        "ogbn-arxiv", strategy="rcmk", block_size=32, dim=16,
        impl="hybrid", scale=0.002,
    )
    assert rec["nnz_per_s"] > 0
    assert rec["strategy"] == "rcmk"
    assert "dense_nnzb" in rec
    json.dumps(rec)


def test_bench_scaling_efficiency():
    rec = bench_scaling([1, 2, 4], p=0.05, block_size=16, dim=32, n_block_rows=32)
    assert [p["devices"] for p in rec["points"]] == [1, 2, 4]
    for p in rec["points"]:
        assert p["nnz_per_s"] > 0
    json.dumps(rec)


def test_bench_train_scaling_record():
    rec = bench_train_scaling(
        [1, 2], p=0.05, block_size=16, dims=(16, 16, 4), n_block_rows=32,
        iters=1,
    )
    assert [p["devices"] for p in rec["points"]] == [1, 2]
    for p in rec["points"]:
        assert p["ms_per_step"] > 0 and p["retention"] > 0
    json.dumps(rec)


def test_sweep_cli_grids(monkeypatch, tmp_path):
    """CLI wiring: grids expand correctly and records stream to JSONL
    (runners stubbed — no device work)."""
    import json as _json

    from spmm_denseblock_tpu.bench import harness, sweeps

    calls = []

    def fake_bsr(**kw):
        calls.append(kw)
        return {"ok": 1, **{k: str(v) for k, v in kw.items()}}

    monkeypatch.setattr(harness, "bench_synthetic_bsr", fake_bsr)
    out = tmp_path / "r.jsonl"
    rc = sweeps.main(["bsrmm", "--quick", "--out", str(out)])
    assert rc == 0
    recs = [_json.loads(l) for l in out.read_text().splitlines()]
    assert len(recs) == len(calls) > 0
    # quick grid: one density, largest block, one dim, both impls
    assert {c["impl"] for c in calls} == {"bsr_pallas", "bsr_xla"}
    assert all(c["block_size"] == 128 for c in calls)


def test_sweep_cli_errors_are_captured(monkeypatch, tmp_path):
    from spmm_denseblock_tpu.bench import harness, sweeps

    def boom(**kw):
        raise RuntimeError("nope")

    monkeypatch.setattr(harness, "bench_synthetic_csr", boom)
    out = tmp_path / "r.jsonl"
    rc = sweeps.main(["csrmm", "--quick", "--out", str(out)])
    assert rc == 0
    assert "nope" in out.read_text()


def test_bench_train_step_record():
    from spmm_denseblock_tpu.bench import bench_train_step

    rec = bench_train_step(
        scale=0.002, dims=(8, 16, 4), impl="csr_xla", iters=2
    )
    assert rec["ms_per_step"] > 0 and rec["edges_per_s"] > 0
    json.dumps(rec)


def test_bench_synthetic_bsr_transb():
    """transb=1 (the reference's transposed-operand axis,
    test_bsrmm.cu): a column-major operand goes through an entry
    transpose fused with the same plan — record carries transb and the
    timing path handles the non-square chaining."""
    from spmm_denseblock_tpu.bench.harness import bench_synthetic_bsr

    rec = bench_synthetic_bsr(0.05, 16, 24, impl="bsr_xla",
                              n_block_rows=8, transb=1)
    assert rec["transb"] == 1 and rec["ms"] > 0
    rec0 = bench_synthetic_bsr(0.05, 16, 24, impl="bsr_xla",
                               n_block_rows=8, transb=0)
    assert rec0["transb"] == 0
