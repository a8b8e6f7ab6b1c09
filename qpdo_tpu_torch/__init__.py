"""qpdo_tpu_torch: the PyTorch/CUDA port of qpdo_tpu, the QPDO convex QP
solver (primal-dual Newton proximal method).

The port runs the dense solve, batched (``solve_batch``, and
``solve_heterogeneous`` for problems of many sizes), one-shot
(``make_problem`` + ``solve``) or stateful with warm starts and parametric
updates (``QPDO``), under every setting of the JAX package's dense path
(the Newton modes, the incremental KKT cache, polish, and the iteration
table and time limit of the host-driven loop); the differentiable layer
``qp_solve`` (reverse and forward mode); the micro-batching
``SolverService``; the canonical problems of ``applications``; the sparse
large-n path (``solve_sparse``, ``solve_sparse_batch``,
``solve_sparse_heterogeneous``: matrix-free preconditioned CG, or the
exact banded factorization, sequential or by cyclic reduction, on banded
patterns) with its layer ``sparse_qp_layer`` and coarse-to-fine ladders
(``solve_continuation``, ``grid1d_prolong``, ``grid2d_interp``); the
scenario-structured solve (``qpdo_tpu_torch.solver.structured``: a
Schur-complement Newton solve over the scenarios); QPS files
(``qpdo_tpu_torch.io``, the native parser ``qpdo_tpu_torch.native``) and
the command line ``python -m qpdo_tpu_torch``; and the distributed paths
on ``torch.distributed`` (``qpdo_tpu_torch.parallel``: multi-process
runs, batch-sharded and row-sharded solves; the sharded Schur solve,
sparse fleets, service and structured solve over a mesh).  It
runs on the device of its tensors: on an NVIDIA GPU through hand-written
CUDA kernels (``csrc/``, built with nvcc at first use), on the CPU
through the kernels' plain PyTorch versions.  ``make_problem``,
``QPDO.setup``, the sparse entry points and the constructors of
``applications`` put their tensors on the GPU unless told
``device="cpu"``.
The JAX package ``qpdo_tpu`` is the reference it is tested against; this
package imports neither it nor JAX.
"""

from . import applications, constants
from .api import (QPDO, make_problem, solve, solve_sparse, solve_sparse_batch,
                  solve_sparse_heterogeneous)
from .constants import (DUAL_INFEASIBLE, MAX_ITER_REACHED, MAX_TIME_REACHED,
                        NON_CVX, PRIMAL_INFEASIBLE, QPDO_INFTY, SOLVED,
                        UNSOLVED)
from .continuation import grid1d_prolong, grid2d_interp, solve_continuation
from .diff import qp_solve, sparse_qp_layer
from .parallel.batch import solve_batch
from .serve import SolverService
from .solver.core import solve_scaled
from .solver.scaling import scale_problem
from .types import (Info, Problem, Result, ScaledProblem, Settings,
                    SolverState)
from .utils.padding import solve_heterogeneous
from .validate import UnsafeSettingsWarning

__all__ = [
    "Problem", "Settings", "Info", "Result", "ScaledProblem", "SolverState",
    "solve_batch", "solve_heterogeneous", "make_problem", "solve", "QPDO",
    "solve_sparse", "solve_sparse_batch", "solve_sparse_heterogeneous",
    "scale_problem", "solve_scaled", "qp_solve", "sparse_qp_layer",
    "solve_continuation", "grid1d_prolong", "grid2d_interp", "SolverService",
    "UnsafeSettingsWarning",
    "SOLVED", "UNSOLVED", "MAX_ITER_REACHED", "MAX_TIME_REACHED", "NON_CVX",
    "PRIMAL_INFEASIBLE", "DUAL_INFEASIBLE", "QPDO_INFTY",
    "applications", "constants",
]
