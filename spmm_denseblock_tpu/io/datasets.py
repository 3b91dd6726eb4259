"""Dataset acquisition: OGB graphs (gated on the ogb package / network)
with deterministic synthetic fallbacks at the reference's exact sizes.

download_ogb.py parity (/root/reference/download_ogb.py:4-35): the
reference dumps symmetrized edge lists for ogbn-{products,proteins,arxiv}
and ogbl-{ppa,collab,ddi,citation}. This environment has no network
egress, so `load_dataset` falls back to a synthetic power-law graph with
the dataset's published (n, nnz) — hardcoded in the reference at
greedy_neighbor.cpp:8-9 and metis_reorder.cpp:7-8 — so every benchmark
config stays runnable end-to-end.
"""

from __future__ import annotations

import os

import numpy as np

from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.io.graph_io import cached

# (n, nnz) as hardcoded in the reference where known
DATASET_SIZES = {
    "ogbn-arxiv": (169_343, 1_166_243),
    "ogbl-collab": (235_868, 2_358_104),
    "ogbn-products": (2_449_029, 123_718_280),
    "ogbn-proteins": (132_534, 79_122_504),
    "ogbl-ppa": (576_289, 42_463_862),
    "ogbl-ddi": (4_267, 2_135_822),
    "ogbl-citation": (2_927_963, 60_921_468),
}

# Published structural statistics (OGB paper, Hu et al. 2020, dataset
# tables; approximate — used ONLY as calibration targets for the
# synthetic stand-ins, never reported as measurements). avg_degree
# follows from DATASET_SIZES; clustering is the paper's average local
# clustering coefficient.
DATASET_PUBLISHED = {
    "ogbn-arxiv": {"clustering": 0.226},
    "ogbl-collab": {"clustering": 0.729},
    "ogbn-products": {"clustering": 0.411},
    "ogbn-proteins": {"clustering": 0.280},
    "ogbl-ppa": {"clustering": 0.223},
    "ogbl-ddi": {"clustering": 0.514},
    "ogbl-citation": {"clustering": 0.178},
}


def synthetic_powerlaw(
    n: int,
    nnz: int,
    seed: int = 1234,
    clustering: float = 0.5,
    triadic: float = 0.0,
    lattice: float = 0.0,
    clique: float = 0.0,
) -> CSR:
    """Deterministic scale-free-ish symmetric graph: endpoint ids drawn
    with Zipf-like weights plus a fraction of short-range 'community'
    edges so reordering has structure to find (real OGB graphs have
    both hubs and communities).

    triadic > 0 rewires that fraction of edges by one round of triadic
    closure (u-v, v-w => u-w): raises the local clustering coefficient
    toward real-graph values (OGB-paper-style graphs report avg local
    clustering ~0.2-0.4; the base model measures near 0).

    lattice > 0 spends that fraction of edges on a ring lattice
    (i ~ i±1..±k, the Watts-Strogatz substrate, local clustering up to
    3(k-1)/(2(2k-1)) ≈ 0.75): reaches the high-clustering regimes of
    ogbl-ddi (0.514) — one round of triadic closure saturates near 0.3.

    clique > 0 spends that fraction of edges on disjoint q-cliques
    (q ≈ avg undirected degree + 1, so a pure clique member's degree
    matches the dataset's): a pure member's local clustering is
    EXACTLY 1, so this is the only knob that reaches ogbl-collab's
    0.729 — the honest structural model too, since collab IS a
    co-authorship graph (each paper's author team is a clique; the
    lattice family ceilings out at ~0.67 for collab's avg degree).

    Defaults (0, 0) keep the round-1 generator bit-identical, so
    existing cached fixtures and artifacts stay valid; artifacts record
    measured stats via graph_stats() either way. Per-dataset calibrated
    knobs live in DATASET_PROFILES (see scripts/calibrate_synthetic.py)."""
    rng = np.random.default_rng(seed)
    m_total = nnz // 2
    clq_src = clq_dst = None
    n_clq = 0
    if clique > 0:
        # disjoint q-cliques over a random node subset; q sized so a
        # pure clique member's degree = the dataset's avg degree
        q = int(np.clip(round(nnz / max(n, 1)) + 1, 3, 24))
        per = q * (q - 1) // 2
        n_cliques = min(int(m_total * clique) // per, n // q)
        if n_cliques:
            members = rng.permutation(n)[: n_cliques * q].reshape(n_cliques, q)
            iu, ju = np.triu_indices(q, k=1)
            clq_src = members[:, iu].reshape(-1)
            clq_dst = members[:, ju].reshape(-1)
            n_clq = clq_src.size
    m = m_total - n_clq
    # hub endpoints: ids ~ (uniform^alpha) concentrates mass at low ids
    alpha = 3.0
    src = (n * rng.random(m) ** alpha).astype(np.int64) % n
    n_lat = int(m * lattice)
    n_local = int(m * clustering * (1.0 - lattice))
    # community edges: random walk neighbors within +-64 of src
    local_src = rng.integers(0, n, size=n_local, dtype=np.int64)
    local_dst = (local_src + rng.integers(-64, 65, size=n_local)) % n
    far_dst = (n * rng.random(m - n_lat - n_local) ** alpha).astype(np.int64) % n
    dst = np.concatenate([local_dst, far_dst])
    src = np.concatenate([local_src, src[: m - n_lat - n_local]])
    if n_lat:
        # ring lattice: node i ~ i+delta for delta = 1..k (symmetrized
        # below to i±1..±k); deterministic, so triangles are guaranteed
        k = max(1, -(-n_lat // n))  # ceil
        base = np.arange(n, dtype=np.int64)
        lat_src = np.tile(base, k)[:n_lat]
        lat_dst = (lat_src + np.repeat(np.arange(1, k + 1, dtype=np.int64), n)[:n_lat]) % n
        src = np.concatenate([lat_src, src])
        dst = np.concatenate([lat_dst, dst])
    if triadic > 0:
        # close wedges u-v-w: sample surviving edges (u, v), look up an
        # edge (v, w) by binary search on sorted sources, and spend a
        # DIFFERENT (sacrificed) edge slot on the new (u, w) — replacing
        # the wedge's own edge would destroy the triangle being built
        k = int(m * triadic) // 2
        if k:
            sac = rng.choice(m, size=k, replace=False)
            wedge = rng.integers(0, m, size=k)
            order = np.argsort(src, kind="stable")
            pos = np.minimum(np.searchsorted(src[order], dst[wedge]), m - 1)
            w = dst[order][pos]
            u = src[wedge].copy()
            valid = (src[order][pos] == dst[wedge]) & (w != u)
            src[sac] = np.where(valid, u, src[sac])
            dst[sac] = np.where(valid, w, dst[sac])
    if n_clq:
        src = np.concatenate([clq_src, src])
        dst = np.concatenate([clq_dst, dst])
    # scatter communities across id space so 'original' order is poor
    scramble = rng.permutation(n)
    src, dst = scramble[src], scramble[dst]
    edges = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])], 1)
    keep = edges[:, 0] != edges[:, 1]
    return CSR.from_edges(edges[keep], n_rows=n)


# Calibrated generator knobs per dataset (profile="calibrated"): chosen
# by scripts/calibrate_synthetic.py so graph_stats(...)["clustering_sampled"]
# on the stand-in lands near DATASET_PUBLISHED[...]["clustering"].
# "_measured_cc" is the clustering measured at calibration scale
# ("_cal_scale"; scale preserves avg degree, which sets clustering).
# All datasets land within ~0.02 of the published value. ogbl-collab
# needed the `clique` knob (round 3): the ring-lattice family ceilings
# at ~0.67 for avg degree 10, below the published 0.729; disjoint
# co-author-team cliques (collab's actual structure) reach it —
# measured 0.733 at cal scale, 0.747 at full scale. The default
# profile ("legacy") keeps the round-1 generator bit-identical.
DATASET_PROFILES: dict = {
    "ogbl-citation": {"lattice": 0.4, "triadic": 0.15,
                      "_measured_cc": 0.166, "_cal_scale": 0.02},
    "ogbl-collab": {"clique": 0.84, "clustering": 0.3, "lattice": 0.0,
                    "_measured_cc": 0.733, "_cal_scale": 0.2},
    "ogbl-ddi": {"lattice": 0.5, "triadic": 0.0,
                 "_measured_cc": 0.522, "_cal_scale": 1.0},
    "ogbl-ppa": {"lattice": 0.3, "triadic": 0.0,
                 "_measured_cc": 0.210, "_cal_scale": 0.05},
    "ogbn-arxiv": {"lattice": 0.6, "triadic": 0.15,
                   "_measured_cc": 0.238, "_cal_scale": 0.2},
    "ogbn-products": {"lattice": 0.65, "triadic": 0.15,
                      "_measured_cc": 0.391, "_cal_scale": 0.02},
    "ogbn-proteins": {"lattice": 0.2, "triadic": 0.15,
                      "_measured_cc": 0.263, "_cal_scale": 0.2},
}


def graph_stats(csr: CSR, sample: int = 2000, seed: int = 0) -> dict:
    """Measured structural statistics for honest artifact labeling
    (degree distribution + sampled avg local clustering coefficient).
    Every benchmark record on a synthetic stand-in carries these so the
    gap to the real dataset is visible, not hidden."""
    deg = csr.degrees().astype(np.int64)
    n = csr.n_rows
    rng = np.random.default_rng(seed)
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    cand = np.nonzero(deg >= 2)[0]
    cc = 0.0
    if cand.size:
        pick = rng.choice(cand, size=min(sample, cand.size), replace=False)
        coefs = []
        for v in pick:
            nb = indices[indptr[v]: indptr[v + 1]]
            if nb.size > 400:  # cap hub cost; subsample neighbors
                nb = rng.choice(nb, size=400, replace=False)
            nbset = np.unique(nb)
            d = nbset.size
            if d < 2:
                continue
            # count edges among neighbors via sorted membership tests;
            # np.unique(unb) so multi-edges (kept by CSR.from_edges for
            # reference parity) don't inflate the coefficient past 1
            links = 0
            for u in nbset:
                unb = np.unique(indices[indptr[u]: indptr[u + 1]])
                links += np.searchsorted(
                    nbset, unb, side="right"
                ).sum() - np.searchsorted(nbset, unb, side="left").sum()
            coefs.append(links / (d * (d - 1)))
        cc = float(np.mean(coefs)) if coefs else 0.0
    return {
        "n": int(n),
        "nnz": int(csr.nnz),
        "avg_degree": float(deg.mean()) if n else 0.0,
        "max_degree": int(deg.max()) if n else 0,
        "degree_p99": int(np.percentile(deg, 99)) if n else 0,
        "clustering_sampled": round(cc, 4),
    }


def dataset_provenance(name: str) -> str:
    """'ogb' when the real dataset is importable/downloadable, else
    'synthetic_fallback' (without network access every benchmark runs
    on the deterministic stand-in at the reference's published
    (n, nnz))."""
    try:
        import ogb  # noqa: F401

        return "ogb"
    except ImportError:
        return "synthetic_fallback"


def load_dataset(
    name: str,
    cache_dir: str = "tmp",
    scale: float = 1.0,
    seed: int = 1234,
    profile: str = "legacy",
) -> CSR:
    """Try OGB; fall back to a synthetic graph at the dataset's published
    size (scaled by `scale` for quick runs).

    profile="legacy" (default): the round-1/2 two-knob generator —
    bit-identical to every cached fixture.
    profile="calibrated": per-dataset knobs from DATASET_PROFILES so the
    stand-in's measured clustering tracks the published value."""
    if profile not in ("legacy", "calibrated"):
        raise ValueError(f"unknown profile {profile!r}")
    knobs = (
        {k: v for k, v in DATASET_PROFILES.get(name, {}).items()
         if not k.startswith("_")}
        if profile == "calibrated"
        else {}
    )

    def build() -> CSR:
        try:
            return _load_ogb(name)
        except Exception:
            n, nnz = DATASET_SIZES.get(name, (100_000, 1_000_000))
            n = max(16, int(n * scale))
            nnz = max(64, int(nnz * scale))
            return synthetic_powerlaw(n, nnz, seed=seed, **knobs)

    suffix = "_cal" if knobs else ""
    tag = f"{name.replace('-', '_')}_s{scale}{suffix}"
    return cached(cache_dir, tag, build)


def _load_ogb(name: str) -> CSR:
    """Real OGB load: symmetrized edge list like download_ogb.py:12-27."""
    if name.startswith("ogbn"):
        from ogb.nodeproppred import NodePropPredDataset

        ds = NodePropPredDataset(name)
        graph = ds[0][0]
        edges = np.asarray(graph["edge_index"]).T
        n = int(graph["num_nodes"])
    elif name.startswith("ogbl"):
        from ogb.linkproppred import LinkPropPredDataset

        ds = LinkPropPredDataset(name)
        graph = ds[0]
        edges = np.asarray(graph["edge_index"]).T
        n = int(graph["num_nodes"])
    else:
        raise ValueError(name)
    sym = np.concatenate([edges, edges[:, ::-1]], axis=0)
    sym = sym[sym[:, 0] != sym[:, 1]]
    return CSR.from_edges(sym, n_rows=n)


def list_datasets():
    return sorted(DATASET_SIZES)


def synthetic_molecules(
    n_graphs: int = 1000, mean_nodes: int = 25, seed: int = 1234
):
    """Batched small graphs as one block-diagonal adjacency — the
    ogbg-molhiv regime (the reference reorders each ~25-node molecule
    independently, ogbg_molhiv.py:5-59). Returns (csr, graph_ids) where
    graph_ids[v] = which graph vertex v belongs to (the segment ids for
    pooling readouts)."""
    rng = np.random.default_rng(seed)
    sizes = np.maximum(2, rng.poisson(mean_nodes, size=n_graphs))
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offsets[-1])
    edges = []
    for g in range(n_graphs):
        k, off = int(sizes[g]), int(offsets[g])
        # ring + random chords: molecule-ish sparsity (avg degree ~2-3)
        ring = np.stack([np.arange(k), (np.arange(k) + 1) % k], 1)
        n_chord = max(1, k // 4)
        chord = rng.integers(0, k, size=(n_chord, 2))
        e = np.concatenate([ring, chord]) + off
        edges.append(e)
    e = np.concatenate(edges)
    e = np.concatenate([e, e[:, ::-1]])  # symmetrize
    e = e[e[:, 0] != e[:, 1]]
    csr = CSR.from_edges(e, n_rows=n)
    graph_ids = np.repeat(np.arange(n_graphs, dtype=np.int32), sizes)
    return csr, graph_ids
