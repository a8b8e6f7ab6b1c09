"""qpdo_tpu_torch: the PyTorch/CUDA port of qpdo_tpu, the QPDO convex QP
solver (primal-dual Newton proximal method).

The port runs the dense solve, batched (``solve_batch``), one-shot
(``make_problem`` + ``solve``) or stateful with warm starts and parametric
updates (``QPDO``), under every setting of the JAX package's dense path
(the Newton modes, the incremental KKT cache, polish, and the iteration
table and time limit of the host-driven loop), on the device of its
tensors: on an NVIDIA GPU through hand-written CUDA kernels (``csrc/``,
built with nvcc at first use), on the CPU through the kernels' plain
PyTorch versions.  ``make_problem`` and
``QPDO.setup`` put their tensors on the GPU unless told ``device="cpu"``.
The JAX package ``qpdo_tpu`` is the reference it is tested against; this
package imports neither it nor JAX.
"""

from .api import QPDO, make_problem, solve
from .constants import (DUAL_INFEASIBLE, MAX_ITER_REACHED, NON_CVX,
                        PRIMAL_INFEASIBLE, QPDO_INFTY, SOLVED, UNSOLVED)
from .parallel.batch import solve_batch
from .types import Info, Problem, Result, Settings
from .validate import UnsafeSettingsWarning

__all__ = [
    "Problem", "Settings", "Info", "Result", "solve_batch",
    "make_problem", "solve", "QPDO", "UnsafeSettingsWarning",
    "SOLVED", "UNSOLVED", "MAX_ITER_REACHED", "NON_CVX",
    "PRIMAL_INFEASIBLE", "DUAL_INFEASIBLE", "QPDO_INFTY",
]
