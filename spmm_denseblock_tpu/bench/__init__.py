from spmm_denseblock_tpu.bench.timing import time_call
from spmm_denseblock_tpu.bench.harness import (
    bench_synthetic_bsr,
    bench_synthetic_csr,
    bench_graph,
    bench_scaling,
    bench_train_scaling,
    bench_train_step,
)
from spmm_denseblock_tpu.bench.sweeps import (
    sweep_bsrmm,
    sweep_csrmm,
    sweep_graph,
    sweep_scaling,
    main,
)

__all__ = [
    "time_call",
    "bench_synthetic_bsr",
    "bench_synthetic_csr",
    "bench_graph",
    "bench_scaling",
    "bench_train_scaling",
    "bench_train_step",
    "sweep_bsrmm",
    "sweep_csrmm",
    "sweep_graph",
    "sweep_scaling",
    "main",
]
