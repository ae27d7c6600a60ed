"""Low-level compute ops: real-pair complex, matrix exponentials, the
chain-exponential action, and the batched modulated-linear RK step."""

from . import cplx
from .chain import chain_expmv_xla, row_matmul
from .cplx import Cplx
from .expm import expm, expm_apply, expm_frechet
from .modulated_rk import FusedModulatedLinearRK, xla_rk_step

__all__ = [
    "cplx",
    "Cplx",
    "expm",
    "expm_apply",
    "expm_frechet",
    "FusedModulatedLinearRK",
    "xla_rk_step",
    "chain_expmv_xla",
    "row_matmul",
]
