"""Calibrate synthetic_powerlaw knobs per dataset so the stand-in's
measured average local clustering coefficient tracks the published OGB
value (DATASET_PUBLISHED). CPU-only, no JAX. Prints a DATASET_PROFILES
literal to paste into io/datasets.py, with measured stats recorded.

Method: clustering_sampled is (empirically) monotone in the `lattice`
fraction, so a coarse grid over (lattice, triadic) followed by one
local lattice refinement suffices. Runs at reduced scale — scale
preserves avg degree, which is what the lattice k and the clustering
coefficient depend on.

Reference parity note: the reference measures real OGB graphs
(download_ogb.py); this environment has no egress, so the stand-ins
must carry realistic clustering for the reordering results to mean
anything.
"""
import json
import sys

sys.path.insert(0, "/root/repo")

from spmm_denseblock_tpu.io.datasets import (  # noqa: E402
    DATASET_PUBLISHED,
    DATASET_SIZES,
    graph_stats,
    synthetic_powerlaw,
)

# scale chosen so each calibration graph is <= ~20M nnz
SCALES = {
    "ogbn-arxiv": 0.2,
    "ogbl-collab": 0.2,
    "ogbn-products": 0.02,
    "ogbn-proteins": 0.2,
    "ogbl-ppa": 0.05,
    "ogbl-ddi": 1.0,
    "ogbl-citation": 0.02,
}


def measure(name, lattice, triadic, sample=800):
    n, nnz = DATASET_SIZES[name]
    s = SCALES[name]
    n, nnz = max(16, int(n * s)), max(64, int(nnz * s))
    csr = synthetic_powerlaw(n, nnz, lattice=lattice, triadic=triadic)
    return graph_stats(csr, sample=sample)


def calibrate(name):
    target = DATASET_PUBLISHED[name]["clustering"]
    best = None  # (err, lattice, triadic, stats)
    for tri in (0.0, 0.15):
        for lat in (0.0, 0.15, 0.3, 0.5, 0.7, 0.9):
            st = measure(name, lat, tri)
            err = abs(st["clustering_sampled"] - target)
            if best is None or err < best[0]:
                best = (err, lat, tri, st)
            print(
                f"  {name} lat={lat} tri={tri} cc={st['clustering_sampled']}"
                f" (target {target})",
                flush=True,
            )
    # local refinement on lattice around the winner
    _, lat0, tri0, _ = best
    for lat in (max(0.0, lat0 - 0.1), lat0 - 0.05, lat0 + 0.05, min(0.95, lat0 + 0.1)):
        if lat < 0 or lat > 0.95:
            continue
        st = measure(name, lat, tri0)
        err = abs(st["clustering_sampled"] - target)
        if err < best[0]:
            best = (err, lat, tri0, st)
        print(
            f"  {name} refine lat={lat:.2f} tri={tri0} cc={st['clustering_sampled']}",
            flush=True,
        )
    return best


def main():
    names = sys.argv[1:] or sorted(DATASET_PUBLISHED)
    profiles = {}
    for name in names:
        err, lat, tri, st = calibrate(name)
        profiles[name] = {
            "lattice": round(lat, 2),
            "triadic": tri,
            "_measured_cc": st["clustering_sampled"],
            "_target_cc": DATASET_PUBLISHED[name]["clustering"],
            "_cal_scale": SCALES[name],
        }
        print(json.dumps({"dataset": name, **profiles[name]}), flush=True)
    print("\nDATASET_PROFILES = ", json.dumps(profiles, indent=4))


if __name__ == "__main__":
    main()
