from spmm_denseblock_tpu.ops.csr_spmm import csr_spmm, csr_spmm_plan, bcoo_spmm_plan
from spmm_denseblock_tpu.ops.csr_spmm_ell import (
    csr_spmm_ell,
    csr_spmm_ell_banded_plan,
    csr_spmm_ell_int8_plan,
    csr_spmm_ell_plan,
)
from spmm_denseblock_tpu.ops.plan import Plan, grad_plan, sum_plan, transb_plan
from spmm_denseblock_tpu.ops.bsr_spmm_xla import bsr_spmm_xla, bsr_spmm_xla_plan
from spmm_denseblock_tpu.ops.bsr_spmm_pallas import (
    bsr_spmm_pallas,
    bsr_spmm_pallas_int8_plan,
    bsr_spmm_pallas_plan,
)
from spmm_denseblock_tpu.ops.hybrid_spmm import (
    hybrid_spmm,
    hybrid_spmm_int8_plan,
    hybrid_spmm_plan,
)
from spmm_denseblock_tpu.ops.dense_block_gemm import dense_block_gemm
from spmm_denseblock_tpu.ops.windowed_spmm import (
    windowed_spmm,
    windowed_spmm_plan,
    windowed_spmm_int8_plan,
    tiered_spmm_plan,
)
from spmm_denseblock_tpu.ops.sddmm import sddmm, sddmm_plan, sddmm_block_plan
from spmm_denseblock_tpu.ops.bsr_spmm_int8 import bsr_spmm_int8, bsr_spmm_int8_plan
from spmm_denseblock_tpu.ops.dispatch import spmm_plan, spmm_tune, PLANNERS
from spmm_denseblock_tpu.ops.reference import (
    spmm_scipy,
    spmm_dense_jnp,
    assert_allclose,
    CHECK_EPS,
)

__all__ = [
    "csr_spmm",
    "csr_spmm_plan",
    "csr_spmm_ell",
    "csr_spmm_ell_banded_plan",
    "csr_spmm_ell_int8_plan",
    "csr_spmm_ell_plan",
    "Plan",
    "grad_plan",
    "sum_plan",
    "transb_plan",
    "bcoo_spmm_plan",
    "bsr_spmm_xla",
    "bsr_spmm_xla_plan",
    "bsr_spmm_pallas",
    "bsr_spmm_pallas_plan",
    "bsr_spmm_pallas_int8_plan",
    "hybrid_spmm",
    "hybrid_spmm_int8_plan",
    "hybrid_spmm_plan",
    "dense_block_gemm",
    "windowed_spmm",
    "windowed_spmm_plan",
    "windowed_spmm_int8_plan",
    "tiered_spmm_plan",
    "sddmm",
    "sddmm_plan",
    "sddmm_block_plan",
    "bsr_spmm_int8",
    "bsr_spmm_int8_plan",
    "spmm_plan",
    "spmm_tune",
    "PLANNERS",
    "spmm_scipy",
    "spmm_dense_jnp",
    "assert_allclose",
    "CHECK_EPS",
]
