"""qpdo_tpu_torch: the PyTorch/CUDA port of qpdo_tpu, the QPDO convex QP
solver (primal-dual Newton proximal method).

The port runs the batched dense solve (``solve_batch``) on the device of
its input tensors: on an NVIDIA GPU through hand-written CUDA kernels
(``csrc/``, built with nvcc at first use), on the CPU through the kernels'
plain PyTorch versions.  The JAX package ``qpdo_tpu`` is the reference it
is tested against; this package imports neither it nor JAX.
"""

from .constants import (DUAL_INFEASIBLE, MAX_ITER_REACHED, NON_CVX,
                        PRIMAL_INFEASIBLE, QPDO_INFTY, SOLVED, UNSOLVED)
from .parallel.batch import solve_batch
from .types import Info, Problem, Result, Settings

__all__ = [
    "Problem", "Settings", "Info", "Result", "solve_batch",
    "SOLVED", "UNSOLVED", "MAX_ITER_REACHED", "NON_CVX",
    "PRIMAL_INFEASIBLE", "DUAL_INFEASIBLE", "QPDO_INFTY",
]
