"""Hybrid format: dense-block BSR part + remainder CSR part.

The execution model for this is two kernels summed into one output —
the analog of the reference's divide.cu accumulate pattern
(z += csrmm2(leftover CSR); z += bsrmm(dense blocks),
/root/reference/divide.cu:348-373, alpha=beta=1) — except here both
parts are jitted together so XLA can overlap the memory-bound CSR
gather with the compute-bound block GEMMs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax

from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.formats.bsr import BSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hybrid:
    """BSR part holds blocks whose occupancy >= the density threshold used
    at construction (convert/divide.py); the CSR part holds every other
    nonzero. dense.to_dense() + remainder.to_dense() == original matrix."""

    dense: BSR
    remainder: CSR
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.dense.nnz_inside() + self.remainder.nnz

    def to_dense(self):
        return self.dense.to_dense() + self.remainder.to_dense()

    def device_put(self, block_dtype=None) -> "Hybrid":
        return Hybrid(
            dense=self.dense.device_put(dtype=block_dtype),
            remainder=self.remainder.device_put(),
            shape=self.shape,
        )
