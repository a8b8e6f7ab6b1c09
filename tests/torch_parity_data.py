"""Problem data and settings shared by the port's distributed parity
tests and their workers (numpy and the port only; no JAX)."""

import numpy as np

import qpdo_tpu_torch as pt


def family(B, n, m, seed):
    """The bench problem family (bench.py:344-352) as numpy float64."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    return dict(Q=Q, q=rng.standard_normal((B, n)),
                A=rng.standard_normal((B, m, n)),
                l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))


def bench_like_settings():
    """The bench configuration (hybrid float32 warmup, ns then chol,
    mixed GEMMs with hard rows) with both kernel flags."""
    return pt.Settings(eps_abs=1e-6, max_iter=300, inner_max_iter=50,
                       eps_abs_in=0.1, rho=0.02, delta=0.1, refine_steps=2,
                       kkt_dtype="float32", hybrid_warmup=True, mu_min=1e-7,
                       cert_dtype="float32", linesearch="bisect",
                       linesearch_dtype="float32",
                       phase2_gemm_dtype="float32", hard_rows=8,
                       anchor_every=10, warmup_eps=1e-4,
                       warmup_refine_steps=0, pallas_formation=True,
                       pallas_residuals=True, kkt_solver="ns",
                       kkt_ns_steps=5, kkt_inv_refresh=False)


def random_arrow(S=8, n0=6, ns=10, seed=0):
    """tests/test_schur.py:_random_arrow as numpy: (K00, Kss, Bs, r0, rs)
    of one arrow system."""
    rng = np.random.default_rng(seed)
    M0 = rng.standard_normal((n0, n0))
    K00 = M0 @ M0.T + (S + 1) * np.eye(n0)
    Ms = rng.standard_normal((S, ns, ns))
    Kss = np.einsum("sij,skj->sik", Ms, Ms) + ns * np.eye(ns)
    Bs = 0.3 * rng.standard_normal((S, ns, n0))
    return K00, Kss, Bs, rng.standard_normal(n0), rng.standard_normal((S, ns))


def random_bap(S=4, ms=12, n0=6, ns=8, seed=0):
    """tests/test_structured.py:_random_bap as a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    M0 = rng.standard_normal((n0, n0)) / np.sqrt(n0)
    Ms = rng.standard_normal((S, ns, ns)) / np.sqrt(ns)
    return dict(
        Q0=M0 @ M0.T + 0.5 * np.eye(n0),
        Qs=np.einsum("sij,skj->sik", Ms, Ms) + 0.5 * np.eye(ns),
        q0=rng.standard_normal(n0), qs=rng.standard_normal((S, ns)),
        T=rng.standard_normal((S, ms, n0)) * 0.5,
        W=rng.standard_normal((S, ms, ns)),
        l=-rng.random((S, ms)) - 0.1, u=rng.random((S, ms)) + 0.1,
        c=np.float64(0.0))


STRUCTURED = dict(scaling=0, eps_prim_inf=0.0, eps_dual_inf=0.0,
                  max_iter=500)


def sparse_fleet(n=30, m=24, B=8, seed=44):
    """tests/test_sparse.py:test_sparse_batch_sharded_mesh's fleet: one
    pattern, B instances (scipy CSR Q and A, numpy vectors)."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    pat = sps.random(n, n, density=0.15, random_state=seed, format="csr")
    Qp = (pat.T @ pat + 0.3 * sps.eye(n)).tocsr()
    Ap = sps.random(m, n, density=0.25, random_state=seed + 1, format="csr")
    Ap.data[:] = rng.standard_normal(Ap.nnz)
    probs = []
    for b in range(B):
        Qb = Qp.copy()
        Qb.data = Qb.data * (1.0 + 0.02 * b)
        probs.append((Qb, rng.standard_normal(n), Ap, -np.ones(m),
                      np.ones(m)))
    return probs


def mixed_fleet(seed=5):
    """Sparse problems of three sizes, for the heterogeneous fleet."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    out = []
    for n, m in ((12, 8), (16, 10), (10, 12), (14, 9)):
        pat = sps.random(n, n, density=0.3, random_state=rng, format="csr")
        Q = (pat.T @ pat + 0.5 * sps.eye(n)).tocsr()
        A = sps.random(m, n, density=0.4, random_state=rng, format="csr")
        out.append((Q, rng.standard_normal(n), A, -np.ones(m), np.ones(m)))
    return out
