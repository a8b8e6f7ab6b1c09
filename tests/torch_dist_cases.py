"""The worker side of the port's distributed parity tests: functions
``f(rank, world, *args)`` that ``tests/torch_dist.Ranks`` calls in every
process of a gloo group on the CPU.  Each returns numpy arrays and
numbers for the test to hold against the JAX package.  No JAX here.
"""

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.parallel import full_tensor
from qpdo_tpu_torch.parallel.dtensor import dtensor_from_local, local_block

import torch_parity_data as data
from utils import random_qp


def _mesh(size, name):
    """A 1-D CPU mesh over ranks 0..size-1 (every rank must call it)."""
    return DeviceMesh("cpu", torch.arange(size), mesh_dim_names=(name,))


def _np(t):
    return full_tensor(t).detach().cpu().numpy()


def _summary(res, m=None):
    """A batch Result as numpy: x, y (the first m rows), status,
    iterations, objective."""
    y = _np(res.y)
    return dict(x=_np(res.x), y=y if m is None else y[..., :m],
                status=_np(res.info.status_val),
                iterations=_np(res.info.iterations),
                objective=_np(res.info.objective))


def _cpu_problem(Q, q, A, l, u):
    return pt.make_problem(Q, q, A, l, u, device="cpu")


# ---------------------------------------------------------------------------
# row-sharded (tests/test_torch_row_sharded.py), 4 ranks
# ---------------------------------------------------------------------------

def row_sharded(rank, world):
    """The cases of tests/test_row_sharded.py over 2 ranks (ranks 0-1 of
    the 4) and over 4: each returns the whole x and y, and every rank's
    own x for the bit-for-bit check."""
    from qpdo_tpu_torch.parallel import solve_row_sharded

    mesh2, mesh4 = _mesh(2, "rows"), _mesh(world, "rows")
    out = {}

    def run(name, mesh, p, s=None, **kw):
        if rank >= (world if mesh is None else mesh.size()):
            return None
        res, m = solve_row_sharded(p, s, mesh=mesh, **kw)
        out[name] = dict(_summary(res), m=m, y_tail=_np(res.y)[0, m:],
                         x_rank=res.x.numpy())
        return res, m

    bisect = pt.Settings(linesearch="bisect")
    p = _cpu_problem(*random_qp(60, 400, seed=0))
    run("m400_r2", mesh2, p, bisect)
    run("m400_r4", mesh4, p, bisect)
    # no mesh: every rank of the default group
    run("m101_r4", None, _cpu_problem(*random_qp(30, 101, seed=4)))
    p = _cpu_problem(*random_qp(40, 160, seed=7))
    cold = run("cold_r2", mesh2, p)
    if cold is not None:
        res, m = cold
        run("warm_r2", mesh2, p, x0=res.x, y0=_np(res.y)[0, :m])
    rng = np.random.default_rng(4)
    n, m = 24, 32
    M = rng.standard_normal((n, n))
    p = _cpu_problem(M @ M.T / n + 0.1 * np.eye(n), rng.standard_normal(n),
                     rng.standard_normal((m, n)), -np.ones(m), np.ones(m))
    run("polish_r2", mesh2, p, pt.Settings(polish=True))
    # the other Newton routes, against the port's unsharded solve
    p = _cpu_problem(*random_qp(20, 64, seed=5))
    for name, s in ROW_VARIANTS.items():
        s = s.replace(linesearch="bisect")
        if run(name, mesh2, p, s) is not None:
            out[name]["ref"] = _summary(pt.solve(p, s))
    # the host-driven loop: the table on rank 0, a time limit
    run("verbose", mesh2, p, pt.Settings(verbose=True, print_interval=20))
    run("max_time", mesh2, p, pt.Settings(max_time=1e-9))
    return out


ROW_VARIANTS = {
    "bench": data.bench_like_settings(),
    "pallas_kkt": pt.Settings(kkt_dtype="float32", mu_min=1e-7,
                              refine_steps=2, pallas_kkt=True),
    "fused_rhs": pt.Settings(fused_newton_rhs=True, pallas_formation=True),
    "inv": pt.Settings(kkt_solver="inv"),
    "cg": pt.Settings(kkt_solver="cg"),
    "incremental": pt.Settings(kkt_update_rows=8),
}


# ---------------------------------------------------------------------------
# batch-sharded (tests/test_torch_batch_sharded.py), 4 ranks
# ---------------------------------------------------------------------------

def _join(rank, world):
    """Join the group through ``multihost.initialize``'s explicit form."""
    from qpdo_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{os.environ['TEST_DIST_PORT']}", world,
                         rank, backend="gloo", timeout=900)


def _torch_batch(d):
    return pt.Problem(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


def batch_sharded(rank, world):
    """solve_batch_sharded over 2 and 4 ranks in float64 (cold and warm),
    and the bench configuration compacted, sharded and not."""
    from qpdo_tpu_torch.parallel import (shard_problems, solve_batch,
                                         solve_batch_sharded)

    _join(rank, world)
    mesh2, mesh4 = _mesh(2, "batch"), _mesh(world, "batch")
    P = _torch_batch(data.family(8, 16, 12, 2))
    out = {}
    s = pt.Settings(max_iter=300)
    for mesh in (mesh2, mesh4):
        if rank < mesh.size():
            k = mesh.size()
            res = solve_batch_sharded(P, mesh, s)
            out[f"cold_r{k}"] = _summary(res)
            out[f"local_r{k}"] = res.x.to_local().numpy()
            warm = solve_batch_sharded(P, mesh, s, x0=_np(res.x) * 0.9,
                                       y0=torch.from_numpy(_np(res.y)) * 0.9)
            out[f"warm_r{k}"] = _summary(warm)
    # the bench configuration: compaction on each rank's block, decided
    # from the global active count, against the unsharded solve
    Pb = _torch_batch(data.family(12, 16, 12, 3))
    sb = data.bench_like_settings()
    out["bench_ref"] = _summary(pt.solve_batch(Pb, sb, compact=True))
    out["bench_plain_ref"] = _summary(pt.solve_batch(Pb, sb))
    for mesh in (mesh2, mesh4):
        if rank < mesh.size():
            k = mesh.size()
            split = shard_problems(Pb, mesh)
            out[f"bench_r{k}"] = _summary(solve_batch(split, sb, compact=True))
            out[f"bench_plain_r{k}"] = _summary(solve_batch(split, sb))
    return out


# ---------------------------------------------------------------------------
# multihost (tests/test_torch_multihost.py), 2 ranks
# ---------------------------------------------------------------------------

def multihost_local(rank, local_B=4, n=16, m=12):
    """tests/multihost_worker.py:34-44: each process's own local batch."""
    rng = np.random.default_rng(100 + rank)
    M = rng.standard_normal((local_B, n, n))
    return dict(Q=np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n),
                q=rng.standard_normal((local_B, n)),
                A=rng.standard_normal((local_B, m, n)),
                l=-rng.random((local_B, m)), u=rng.random((local_B, m)),
                c=np.zeros(local_B))


def multihost(rank, world):
    """initialize() from the environment torchrun sets, global_mesh,
    distribute_batch of each rank's own batch, and plain solve_batch
    (tests/multihost_worker.py)."""
    from qpdo_tpu_torch.parallel import multihost as mh

    os.environ.update(MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=os.environ["TEST_DIST_PORT"],
                      RANK=str(rank), WORLD_SIZE=str(world))
    mh.initialize(backend="gloo", timeout=900)
    assert dist.get_world_size() == world and dist.get_rank() == rank
    mh.initialize()                         # a group exists: nothing to do
    mesh = mh.global_mesh("batch", device_type="cpu")
    assert mesh.mesh_dim_names == ("batch",) and mesh.size() == world
    local = _torch_batch(multihost_local(rank))
    problems = mh.distribute_batch(local, mesh)
    assert problems.q.shape[0] == 4 * world
    res = pt.solve_batch(problems, pt.Settings(max_iter=300))
    return dict(_summary(res), local_status=res.info.status_val.to_local()
                .numpy(), local_q=problems.q.to_local().numpy())


# ---------------------------------------------------------------------------
# the scenario-sharded arrow solve and structured solve, 4 ranks
# ---------------------------------------------------------------------------

def _split(a, mesh, dim):
    """A whole tensor as a DTensor split along ``dim`` over ``mesh``."""
    return dtensor_from_local(local_block(a, mesh, dim), mesh, dim,
                              a.shape[dim])


def schur_sharded(rank, world):
    """arrow_solve_sharded over 2 and 4 ranks (DTensor blocks) and over 4
    (each rank passing its own scenarios), on the systems of
    tests/test_schur.py with a batch axis of one."""
    from qpdo_tpu_torch.ops.schur import ArrowSystem, arrow_solve_sharded

    meshes = {2: _mesh(2, "scenario"), 4: _mesh(world, "scenario")}
    out = {}
    for S, seed in ((16, 0), (8, 3)):
        K00, Kss, Bs, r0, rs = (torch.from_numpy(np.asarray(a))[None]
                                for a in data.random_arrow(S=S, seed=seed))
        for k, mesh in meshes.items():
            if rank >= k:
                continue
            system = ArrowSystem(K00, _split(Kss, mesh, 1),
                                 _split(Bs, mesh, 1))
            x0, xs = arrow_solve_sharded(system, r0, _split(rs, mesh, 1),
                                         mesh)
            out[(S, k)] = dict(x0=x0.numpy(), xs=_np(xs))
        mesh = meshes[4]
        own = lambda a: local_block(a, mesh, 1).clone()
        x0, xs = arrow_solve_sharded(ArrowSystem(K00, own(Kss), own(Bs)),
                                     r0, own(rs), mesh)
        out[(S, "own")] = dict(x0=x0.numpy(), xs=_np(xs),
                               local=xs.to_local().numpy())
    return out


def structured_sharded(rank, world):
    """The scenario-sharded structured solve over 2 and 4 ranks
    (tests/test_structured.py:test_sharded_scenarios_match), with the
    settings of that file and with the defaults (scaling, certificates,
    the sorted linesearch over the gathered hinges), and a warm start."""
    from qpdo_tpu_torch.solver.structured import (BlockAngularProblem,
                                                  solve_block_angular)

    p = {k: torch.as_tensor(v) for k, v in
         data.random_bap(S=8, ms=10, n0=5, ns=6, seed=4).items()}
    out = {}
    for k, mesh in ((2, _mesh(2, "sc")), (4, _mesh(world, "sc"))):
        if rank >= k:
            continue
        split = BlockAngularProblem(**{
            name: (_split(v, mesh, 0) if name in ("Qs", "qs", "T", "W",
                                                   "l", "u") else v)
            for name, v in p.items()})
        for tag, s in (("structured", pt.Settings(**data.STRUCTURED)),
                       ("default", pt.Settings())):
            x0, xs, y, info = solve_block_angular(split, s, device="cpu")
            out[(tag, k)] = dict(x0=x0.numpy(), xs=_np(xs), y=_np(y),
                                 status=int(info.status_val),
                                 iterations=int(info.iterations))
        s = pt.Settings(**data.STRUCTURED)
        x0, xs, y, info = solve_block_angular(split, s, device="cpu")
        x0, xs, y, info = solve_block_angular(split, s, warm=(x0, xs, y),
                                              device="cpu")
        out[("warm", k)] = dict(x0=x0.numpy(), xs=_np(xs),
                                status=int(info.status_val),
                                iterations=int(info.iterations))
    return out


# ---------------------------------------------------------------------------
# the service and the sparse fleets over a mesh, 2 ranks
# ---------------------------------------------------------------------------

def serve_mesh(rank, world):
    """SolverService(mesh=) with five requests submitted on rank 0 (5 is
    not a multiple of the mesh: the group is padded), submit refused on
    rank 1; then solve_sparse_batch(mesh=) and
    solve_sparse_heterogeneous(mesh=) against their unsharded solves."""
    mesh = _mesh(world, "batch")
    out = {}
    svc = pt.SolverService(max_batch=16, max_wait_ms=50, mesh=mesh)
    try:
        if rank == 0:
            futs = [svc.submit(_cpu_problem(*random_qp(24, 18, seed=seed)))
                    for seed in range(5)]
            out["served"] = [(f.result(300).x[0].numpy(),
                              f.result(300).y[0].numpy(),
                              int(f.result(300).info.status_val[0]))
                             for f in futs]
            out["stats"] = svc.stats()
        else:
            try:
                svc.submit(_cpu_problem(*random_qp(4, 3, seed=0)))
                out["refused"] = False
            except RuntimeError:
                out["refused"] = True
    finally:
        svc.shutdown()
    fleet = data.sparse_fleet()
    res = pt.solve_sparse_batch(fleet, mesh=mesh, device="cpu")
    out["fleet"] = _summary(res)
    out["fleet_local"] = res.x.to_local().numpy()
    out["fleet_ref"] = _summary(pt.solve_sparse_batch(fleet, device="cpu"))
    mixed = data.mixed_fleet()
    het = pt.solve_sparse_heterogeneous(mixed, mesh=mesh, device="cpu")
    out["mixed"] = [(r.x[0].numpy(), int(r.info.status_val[0]),
                     int(r.info.iterations[0])) for r in het]
    return out

