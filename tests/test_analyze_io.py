import numpy as np
import scipy.sparse as sp

from spmm_denseblock_tpu.formats import CSR
from spmm_denseblock_tpu.convert import csr_to_bsr
from spmm_denseblock_tpu.analyze import (
    calculate_nnzb,
    block_metrics,
    fill_histogram,
    heatmap,
    dump_heatmap,
    load_heatmap,
)
from spmm_denseblock_tpu.io import (
    dump_csr,
    load_csr,
    dump_edge_list,
    load_edge_list,
    dump_permutation,
    load_permutation,
    save_npz,
    load_npz,
    synthetic_powerlaw,
)


def _csr(n=128, seed=0):
    return CSR.from_scipy(
        sp.random(n, n, density=0.05, random_state=seed, format="csr")
    )


def test_nnzb_matches_converter():
    csr = _csr()
    for b in (4, 16):
        assert calculate_nnzb(csr, b) == csr_to_bsr(csr, b).nnzb


def test_block_metrics_formulas():
    csr = _csr()
    m = block_metrics(csr, (8,))[8]
    nnzb = calculate_nnzb(csr, 8)
    assert m["nnzb"] == nnzb
    assert abs(m["density"] - nnzb / (16 * 16)) < 1e-12
    assert abs(m["utilization"] - csr.nnz / (nnzb * 64)) < 1e-12
    assert abs(m["average"] - csr.nnz / nnzb) < 1e-12


def test_fill_histogram_counts_all_blocks():
    csr = _csr(seed=3)
    h = fill_histogram(csr, 8)
    assert h.sum() == calculate_nnzb(csr, 8)
    # fully dense block lands in the last bucket
    dense = CSR.from_scipy(sp.csr_matrix(np.ones((8, 8), np.float32)))
    h2 = fill_histogram(dense, 8)
    assert h2[-1] == 1 and h2.sum() == 1


def test_heatmap_roundtrip(tmp_path):
    csr = _csr(seed=4)
    h = heatmap(csr, 32)
    assert h.sum() == csr.nnz
    p = str(tmp_path / "hm.txt")
    dump_heatmap(h, p)
    np.testing.assert_array_equal(load_heatmap(p), h)


def test_csr_text_roundtrip(tmp_path):
    csr = synthetic_powerlaw(100, 600, seed=2)
    prefix = str(tmp_path / "g")
    dump_csr(csr, prefix)
    back = load_csr(prefix)
    np.testing.assert_array_equal(np.asarray(back.indptr), np.asarray(csr.indptr))
    np.testing.assert_array_equal(np.asarray(back.indices), np.asarray(csr.indices))
    # reference format: first line is the count
    with open(prefix + "_indptr.txt") as f:
        assert int(f.readline()) == csr.n_rows + 1


def test_edge_list_roundtrip(tmp_path):
    csr = synthetic_powerlaw(60, 300, seed=5)
    p = str(tmp_path / "edges.txt")
    dump_edge_list(csr, p)
    back = load_edge_list(p)
    np.testing.assert_allclose(back.to_dense(), csr.to_dense())


def test_permutation_file_roundtrip(tmp_path):
    perm = np.random.default_rng(0).permutation(50)
    p = str(tmp_path / "perm.txt")
    dump_permutation(perm, p)
    np.testing.assert_array_equal(load_permutation(p), perm)


def test_npz_cache_roundtrip(tmp_path):
    csr = _csr(seed=6)
    p = str(tmp_path / "m.npz")
    save_npz(csr, p)
    back = load_npz(p)
    np.testing.assert_allclose(back.to_dense(), csr.to_dense())


def test_synthetic_powerlaw_deterministic_and_symmetric():
    a = synthetic_powerlaw(256, 2048, seed=9)
    b = synthetic_powerlaw(256, 2048, seed=9)
    np.testing.assert_array_equal(np.asarray(a.indices), np.asarray(b.indices))
    d = a.to_dense()
    np.testing.assert_array_equal(d, d.T)
    assert np.all(np.diag(d) == 0)


def test_dump_metis_graph(tmp_path):
    """gen_adj.cpp format: n m header, 1-indexed neighbor lines."""
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.io.graph_io import dump_metis_graph

    edges = np.array([[0, 1], [1, 0], [1, 2], [2, 1], [2, 2]])
    csr = CSR.from_edges(edges, 3)
    p = tmp_path / "g.graph"
    dump_metis_graph(csr, str(p))
    lines = p.read_text().strip().splitlines()
    assert lines[0] == "3 2"  # self loop dropped, 2 undirected edges
    assert lines[1].split() == ["2"]
    assert lines[2].split() == ["1", "3"]
    assert lines[3].split() == ["2"]


def test_heatmap_plot_and_utils(tmp_path):
    import numpy as np
    from spmm_denseblock_tpu.analyze.heatmap import heatmap, plot_heatmap
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.utils import device_info, roofline

    h = heatmap(random_csr(0.1, 64, seed=2), block_size=16)
    assert h.sum() > 0
    ok = plot_heatmap(h, str(tmp_path / "h.png"), crop=3)
    assert ok and (tmp_path / "h.png").stat().st_size > 0

    info = device_info()
    assert info["n_devices"] >= 1
    r = roofline(2e10, 2e9, 5e-3, peak_flops=2e14, peak_bw=8e11)
    assert r["bound"] == "memory"
    assert abs(r["frac_of_roofline"] - 0.5) < 1e-6


def test_text_io_speed_at_scale(tmp_path):
    """The file contract must handle reference-scale files: 1M-edge dump
    + load round trip in seconds, not minutes (C-speed parse paths)."""
    import time
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.io.graph_io import (
        dump_csr,
        dump_edge_list,
        load_csr,
        load_edge_list,
    )

    csr = random_csr(0.001, 32_000, seed=2, values="ones")
    assert csr.nnz > 900_000
    t0 = time.time()
    p = str(tmp_path / "big.txt")
    dump_edge_list(csr, p)
    back = load_edge_list(p)
    dump_csr(csr, str(tmp_path / "big"))
    back2 = load_csr(str(tmp_path / "big"))
    dt = time.time() - t0
    assert back.nnz == csr.nnz and back2.nnz == csr.nnz
    np.testing.assert_array_equal(np.asarray(back2.indices), np.asarray(csr.indices))
    assert dt < 30, f"text IO too slow: {dt:.1f}s for {csr.nnz} nnz"


def test_bandwidth_profile_improves_with_rcm():
    import numpy as np
    from spmm_denseblock_tpu.analyze.metrics import bandwidth_profile
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.reorder import reorder

    rng = np.random.default_rng(3)
    # path graph + noise, scrambled
    n = 200
    e = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    e = np.concatenate([e, e[:, ::-1], rng.integers(0, n, (20, 2))])
    scram = rng.permutation(n)
    csr = CSR.from_edges(scram[e], n)
    before = bandwidth_profile(csr)
    rcsr, _ = reorder(csr, "rcmk")
    after = bandwidth_profile(rcsr)
    assert after["profile"] < before["profile"]
    assert after["bandwidth"] <= before["bandwidth"]
    empty = CSR.from_coo([], [], None, (4, 4))
    assert bandwidth_profile(empty)["bandwidth"] == 0.0


def test_graph_stats_and_triadic_closure():
    """graph_stats measures what it claims (clique -> clustering 1.0)
    and triadic rewiring raises clustering over the base generator."""
    import numpy as np
    from spmm_denseblock_tpu.formats.csr import CSR
    from spmm_denseblock_tpu.io.datasets import (
        dataset_provenance,
        graph_stats,
        synthetic_powerlaw,
    )

    # K6 clique: every local clustering coefficient is 1
    n = 6
    rows, cols = np.nonzero(~np.eye(n, dtype=bool))
    k6 = CSR.from_coo(rows, cols, None, (n, n))
    s = graph_stats(k6)
    assert s["clustering_sampled"] == 1.0
    assert s["avg_degree"] == 5.0

    base = synthetic_powerlaw(4000, 60000, seed=3)
    closed = synthetic_powerlaw(4000, 60000, seed=3, triadic=0.5)
    sb = graph_stats(base, sample=400, seed=1)
    sc = graph_stats(closed, sample=400, seed=1)
    assert sc["clustering_sampled"] > sb["clustering_sampled"]

    # clique knob (round 3, ogbl-collab calibration): disjoint q-cliques
    # push clustering far past the lattice ceiling; clique=0 leaves the
    # legacy generator bit-identical (determinism guard above relies
    # on the rng stream being untouched by the clique branch)
    cliq = synthetic_powerlaw(4000, 60000, seed=3, clique=0.84,
                              clustering=0.3)
    sq = graph_stats(cliq, sample=400, seed=1)
    assert sq["clustering_sampled"] > 0.6 > sc["clustering_sampled"]
    a = synthetic_powerlaw(4000, 60000, seed=3, clique=0.0)
    assert np.array_equal(np.asarray(a.indptr), np.asarray(base.indptr))
    assert np.array_equal(np.asarray(a.indices), np.asarray(base.indices))

    assert dataset_provenance("ogbn-arxiv") in ("ogb", "synthetic_fallback")


def test_ell_metrics_matches_layout():
    """ell_metrics' slot/chunk accounting must equal what _ell_layout
    actually builds (same _row_widths, same CHUNK_SLOTS split)."""
    from spmm_denseblock_tpu.analyze import ell_metrics
    from spmm_denseblock_tpu.formats.csr import random_csr
    from spmm_denseblock_tpu.ops.csr_spmm_ell import _ell_layout

    csr = random_csr(0.03, 300, 300, seed=11)
    for bucket in ("pow2", "quarter"):
        m = ell_metrics(csr, bucket=bucket)
        idx_chunks, _, _, layout, _ = _ell_layout(csr, bucket, "auto")
        slots = sum(mk * K for mk, K, *_ in layout)
        assert m["slots"] == slots, (bucket, m["slots"], slots)
        assert m["n_chunks"] == len(layout)
        assert m["padded_ratio"] >= 1.0
        assert m["est_ms_small_table_rate"] < m["est_ms_big_table_rate"]


def test_ell_compact_metrics_model():
    """ell_compact_metrics mirrors the layout builder's two-level
    decision model: U/S in (0, 1], two-level estimate never above flat,
    and a block-diagonal matrix (rows share ALL neighbors within a
    block) predicts far lower U/S than a uniform-random one."""
    import scipy.sparse as sp

    from spmm_denseblock_tpu.analyze import ell_compact_metrics
    from spmm_denseblock_tpu.formats.csr import CSR, random_csr

    rnd = random_csr(0.02, 512, 512, seed=3)
    m_rnd = ell_compact_metrics(rnd)
    assert 0 < m_rnd["compact_u_over_s"] <= 1.0 + 1e-9
    assert m_rnd["est_ms_two_level"] <= m_rnd["est_ms_flat"] + 1e-12

    blk = CSR.from_scipy(sp.csr_matrix(
        sp.block_diag([np.ones((32, 32))] * 16, format="csr")
    ))
    m_blk = ell_compact_metrics(blk)
    assert m_blk["compact_u_over_s"] < 0.2 < m_rnd["compact_u_over_s"]


def test_lattice_knob_and_calibrated_profiles():
    """The ring-lattice knob raises clustering monotonically and the
    calibrated per-dataset profiles land closer to the OGB-published
    clustering coefficient than the legacy generator does (knobs
    fitted by scripts/calibrate_synthetic.py)."""
    import numpy as np
    from spmm_denseblock_tpu.io.datasets import (
        DATASET_PROFILES,
        DATASET_PUBLISHED,
        DATASET_SIZES,
        graph_stats,
        synthetic_powerlaw,
    )

    # defaults must stay bit-identical to the round-1 generator: every
    # cached fixture and benchmarks/ artifact depends on it
    a = synthetic_powerlaw(512, 4096, seed=9)
    b = synthetic_powerlaw(512, 4096, seed=9, lattice=0.0, triadic=0.0)
    np.testing.assert_array_equal(np.asarray(a.indices), np.asarray(b.indices))
    np.testing.assert_array_equal(np.asarray(a.indptr), np.asarray(b.indptr))

    cc = [
        graph_stats(
            synthetic_powerlaw(8000, 160000, lattice=lat), sample=300, seed=1
        )["clustering_sampled"]
        for lat in (0.0, 0.5, 0.9)
    ]
    assert cc[0] < cc[1] < cc[2]
    assert cc[2] > 0.45  # lattice-dominated graphs reach the high regime

    # calibrated profiles beat legacy against the published targets on a
    # scaled graph (scale preserves avg degree, which sets clustering)
    for name in ("ogbn-arxiv", "ogbl-ddi"):
        knobs = {
            k: v for k, v in DATASET_PROFILES[name].items()
            if not k.startswith("_")
        }
        target = DATASET_PUBLISHED[name]["clustering"]
        n, nnz = DATASET_SIZES[name]
        s = 0.05 if name == "ogbn-arxiv" else 0.5
        n, nnz = int(n * s), int(nnz * s)
        legacy = graph_stats(synthetic_powerlaw(n, nnz), sample=300, seed=1)
        cal = graph_stats(
            synthetic_powerlaw(n, nnz, **knobs), sample=300, seed=1
        )
        err_legacy = abs(legacy["clustering_sampled"] - target)
        err_cal = abs(cal["clustering_sampled"] - target)
        assert err_cal < err_legacy, (name, legacy, cal, target)
        assert err_cal < 0.12, (name, cal, target)


def test_load_dataset_calibrated_profile(tmp_path):
    """profile='calibrated' uses the fitted knobs and caches under a
    distinct tag so legacy caches stay valid."""
    from spmm_denseblock_tpu.io.datasets import load_dataset
    import pytest

    d = str(tmp_path)
    leg = load_dataset("ogbn-arxiv", cache_dir=d, scale=0.002)
    cal = load_dataset("ogbn-arxiv", cache_dir=d, scale=0.002,
                       profile="calibrated")
    assert leg.nnz > 0 and cal.nnz > 0
    import os

    names = os.listdir(d)
    assert any("_cal" in f for f in names) and any("_cal" not in f for f in names)
    with pytest.raises(ValueError):
        load_dataset("ogbn-arxiv", cache_dir=d, profile="nope")


def test_load_ogb_mocked_structure():
    """_load_ogb (io/datasets.py) with a fake `ogb` package injected in
    sys.modules: the symmetrize + de-self-loop + CSR build path is
    tested code, not dead code, and load_dataset prefers the real
    loader over the synthetic fallback when ogb import succeeds
    (mirrors download_ogb.py:12-27's edge dump)."""
    import sys
    import types

    import numpy as np

    from spmm_denseblock_tpu.io.datasets import _load_ogb

    edge_index = np.array([[0, 1, 2, 3], [1, 2, 3, 0]])  # directed ring

    class _FakeNodeDS:
        def __init__(self, name):
            assert name == "ogbn-test"

        def __getitem__(self, i):
            return ({"edge_index": edge_index, "num_nodes": 5}, None)

    class _FakeLinkDS:
        def __init__(self, name):
            assert name == "ogbl-test"

        def __getitem__(self, i):
            return {"edge_index": edge_index, "num_nodes": 5}

    fake_ogb = types.ModuleType("ogb")
    fake_node = types.ModuleType("ogb.nodeproppred")
    fake_node.NodePropPredDataset = _FakeNodeDS
    fake_link = types.ModuleType("ogb.linkproppred")
    fake_link.LinkPropPredDataset = _FakeLinkDS
    saved = {k: sys.modules.get(k) for k in
             ("ogb", "ogb.nodeproppred", "ogb.linkproppred")}
    sys.modules.update({"ogb": fake_ogb, "ogb.nodeproppred": fake_node,
                        "ogb.linkproppred": fake_link})
    try:
        for name in ("ogbn-test", "ogbl-test"):
            csr = _load_ogb(name)
            assert csr.shape == (5, 5)
            # symmetrized ring: each of vertices 0-3 has degree 2,
            # isolated vertex 4 has none
            deg = np.diff(np.asarray(csr.indptr))
            np.testing.assert_array_equal(deg, [2, 2, 2, 2, 0])
            dense = csr.to_dense()
            np.testing.assert_array_equal(dense, dense.T)  # symmetric
            assert np.trace(dense) == 0  # no self loops
        import pytest

        with pytest.raises(ValueError):
            _load_ogb("ogbg-test")  # graph-property names unsupported
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_load_dataset_uses_real_loader_when_ogb_present(tmp_path):
    """The try/except in load_dataset's build() takes the _load_ogb
    branch when it succeeds — the fallback decision itself is tested."""
    import sys
    import types

    import numpy as np

    from spmm_denseblock_tpu.io import datasets as D

    edge_index = np.array([[0, 1, 2], [1, 2, 0]])

    class _FakeNodeDS:
        def __init__(self, name):
            pass

        def __getitem__(self, i):
            return ({"edge_index": edge_index, "num_nodes": 3}, None)

    fake_ogb = types.ModuleType("ogb")
    fake_node = types.ModuleType("ogb.nodeproppred")
    fake_node.NodePropPredDataset = _FakeNodeDS
    saved = {k: sys.modules.get(k) for k in ("ogb", "ogb.nodeproppred")}
    sys.modules.update({"ogb": fake_ogb, "ogb.nodeproppred": fake_node})
    try:
        csr = D.load_dataset("ogbn-arxiv", cache_dir=str(tmp_path))
        # the real loader returned the tiny mocked graph, NOT the
        # 169k-node synthetic fallback
        assert csr.shape == (3, 3)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_molecule_utilization_study():
    """Per-graph reorder + 100-graph average utilization (the
    ogbg_code_rcmk.py:60-76 analog): reordering must not lose nnz, the
    global permutation keeps each graph inside its id range, and the
    per-molecule reorder improves (or matches) small-block utilization
    vs the original order on average."""
    import numpy as np

    from spmm_denseblock_tpu.analyze import (
        molecule_utilization_study,
        per_graph_reorder,
    )
    from spmm_denseblock_tpu.io.datasets import synthetic_molecules
    from spmm_denseblock_tpu.reorder import check_permutation, permutate

    csr, gids = synthetic_molecules(n_graphs=40, mean_nodes=12, seed=5)
    perm = per_graph_reorder(csr, gids, "rcmk")
    check_permutation(perm, csr.n_rows)
    # graphs stay in-range: the permuted graph_ids equal the original
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    np.testing.assert_array_equal(np.asarray(gids)[inv], gids)
    assert permutate(perm, csr).nnz == csr.nnz

    table = molecule_utilization_study(
        csr, gids, strategies=("original", "rcmk"), n_graphs=40,
        block_sizes=(2, 4, 8),
    )
    for strat in ("original", "rcmk"):
        for b in (2, 4, 8):
            row = table[strat][b]
            assert 0 < row["utilization"] <= 1
            assert row["n_graphs"] == 40
    # rcmk should help (or at worst tie) at small blocks on average
    assert (
        table["rcmk"][4]["utilization"]
        >= table["original"][4]["utilization"] - 1e-9
    )
