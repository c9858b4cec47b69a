"""ALS (alternating linear scheme) solvers: linear systems, eigenproblems,
generalized eigenproblems.

Holtz–Rohwedder–Schneider one-site ALS with fixed ranks
(reference: TensorTrainNumerics.jl src/solvers/als.jl). Formulation:

* Symmetric three-leg environments ``L_i / R_i`` of shape ``(r_x, r_A, r_x)``
  — each update is one einsum (one fused ``dot_general`` chain),
  replacing the reference's asymmetric 5-leg ``G`` tensors (als.jl:47-50).
* The local unknown is laid out ``(r_left, n, r_right)`` C-order, so the local
  solution reshapes into a TT core with no permutation (als.jl:104-136 needs
  two ``permutedims`` per move).
* Dense local solves by default; matrix-free LOBPCG (jax.experimental) above
  ``itslv_thresh`` mirrors the reference's IterativeSolvers.lobpcg path
  (als.jl:72-88).

The scan-based padded-rank variant used for jit/vmap/sharding lives in
``ttnx.solvers.als_scan``.
"""

from __future__ import annotations

import time

import numpy as np
import jax.numpy as jnp

from ttnx.core.algebra import matvec, norm, sub
from ttnx.core.canonical import orthogonalize
from ttnx.core.tt import TTOperator, TTVector, increase_ranks

__all__ = ["als_linsolve", "als_eigsolve", "als_gen_eigsolv"]


# ---------------------------------------------------------------------------
# Environments
# ---------------------------------------------------------------------------


def _ones_env(dtype):
    return jnp.ones((1, 1, 1), dtype=dtype)


def _ones_env2(dtype):
    return jnp.ones((1, 1), dtype=dtype)


def update_left_env(L, xc, Ac):
    """``L_{i+1}`` from ``L_i`` and site ``i`` cores (one einsum; reference
    update_G! /root/reference/src/solvers/als.jl:47-50)."""
    return jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(xc), L, Ac, xc,
                      optimize=True)


def update_right_env(R, xc, Ac):
    """``R_i`` from ``R_{i+1}`` (reference update_H! als.jl:23-26)."""
    return jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(xc), Ac, xc, R,
                      optimize=True)


def update_left_env_b(Lb, xc, bc):
    """(reference update_Gb! als.jl:52-55)"""
    return jnp.einsum("aip,au,uiv->pv", jnp.conj(xc), Lb, bc, optimize=True)


def update_right_env_b(Rb, xc, bc):
    """(reference update_Hb! als.jl:42-45)"""
    return jnp.einsum("aip,uiv,pv->au", jnp.conj(xc), bc, Rb, optimize=True)


def init_right_envs(x: TTVector, A: TTOperator):
    """Build all right environments R_i (contraction of sites i..d-1)
    (reference init_H als.jl:9-21)."""
    d = x.N
    R = [None] * (d + 1)
    R[d] = _ones_env(x.dtype)
    for i in range(d - 1, 0, -1):
        R[i] = update_right_env(R[i + 1], x.cores[i], A.cores[i])
    return R


def init_right_envs_b(x: TTVector, b: TTVector):
    """(reference init_Hb als.jl:28-40)"""
    d = x.N
    Rb = [None] * (d + 1)
    Rb[d] = _ones_env2(x.dtype)
    for i in range(d - 1, 0, -1):
        Rb[i] = update_right_env_b(Rb[i + 1], x.cores[i], b.cores[i])
    return Rb


# ---------------------------------------------------------------------------
# Local problems
# ---------------------------------------------------------------------------


def local_matrix(L, Ac, R):
    """Dense local operator ``K[(a,i,c), (b,j,d)]``
    (reference K_full als.jl:58-63)."""
    k = jnp.einsum("aWb,WiJw,cwd->aicbJd", L, Ac, R, optimize=True)
    m = k.shape[0] * k.shape[1] * k.shape[2]
    return k.reshape(m, m)


def local_rhs(Lb, bc, Rb):
    """(reference Ksolve's Pb als.jl:65-70)"""
    return jnp.einsum("au,uiv,cv->aic", Lb, bc, Rb, optimize=True)


def local_matvec(L, Ac, R, V):
    """Matrix-free local operator application (reference K_matfree als.jl:76-80)."""
    return jnp.einsum("aWb,WiJw,cwd,bJd->aic", L, Ac, R, V, optimize=True)


def _local_solve(L, Ac, R, Lb, bc, Rb):
    pb = local_rhs(Lb, bc, Rb)
    shape = pb.shape
    K = local_matrix(L, Ac, R)
    v = jnp.linalg.solve(K, pb.reshape(-1))
    return v.reshape(shape)


def _local_eigmin(L, Ac, R, v0, it_solver=False, itslv_thresh=1024,
                  maxiter=200, tol=1e-8):
    """Smallest eigenpair of the local operator (reference K_eigmin
    als.jl:72-88): dense ``eigh`` below the threshold, LOBPCG above.

    Complex Hermitian problems take the iterative path too (the reference's
    LOBPCG handles complex natively): ``K = A + iB`` is embedded as the real
    symmetric ``[[A, -B], [B, A]]`` whose spectrum doubles K's, so eigmin is
    preserved and the eigenvector halves recombine as ``x_re + i x_im``."""
    shape = v0.shape
    m = int(np.prod(shape))
    if it_solver and m > itslv_thresh:
        from jax.experimental.sparse.linalg import lobpcg_standard

        # lobpcg_standard finds the LARGEST eigenvalues; shift-invert with a
        # spectral bound: eigmin(K) = sigma - eigmax(sigma*I - K).
        K = local_matrix(L, Ac, R)
        K = 0.5 * (K + K.conj().T)
        if jnp.issubdtype(v0.dtype, jnp.complexfloating):
            Kr = jnp.block([[K.real, -K.imag], [K.imag, K.real]])
            w0 = jnp.concatenate([v0.reshape(m).real, v0.reshape(m).imag])
            sigma = jnp.linalg.norm(Kr, ord=1)
            shifted = sigma * jnp.eye(2 * m, dtype=Kr.dtype) - Kr
            theta, U, _ = lobpcg_standard(shifted, w0[:, None], m=maxiter,
                                          tol=tol)
            lam = sigma - theta[0]
            x = U[:m, 0] + 1j * U[m:, 0]
            x = x / jnp.linalg.norm(x)
            return lam.astype(v0.real.dtype), x.astype(v0.dtype).reshape(shape)
        sigma = jnp.linalg.norm(K, ord=1)  # upper bound on spectral radius
        shifted = sigma * jnp.eye(m, dtype=K.dtype) - K
        theta, U, _ = lobpcg_standard(shifted, v0.reshape(m, 1), m=maxiter,
                                      tol=tol)
        lam = sigma - theta[0]
        return lam, U[:, 0].reshape(shape)
    K = local_matrix(L, Ac, R)
    K = 0.5 * (K + K.conj().T)
    w, U = jnp.linalg.eigh(K)
    return w[0], U[:, 0].reshape(shape)


def _local_gen_eigmin(L, Ac, R, Ls, Sc, Rs, v0):
    """Generalized pencil local solve (reference K_eiggenmin als.jl:90-102)."""
    import scipy.linalg

    shape = v0.shape
    K = np.asarray(local_matrix(L, Ac, R))
    S = np.asarray(local_matrix(Ls, Sc, Rs))
    K = 0.5 * (K + K.conj().T)
    S = 0.5 * (S + S.conj().T)
    w, U = scipy.linalg.eigh(K, S)
    return float(w[0]), jnp.asarray(U[:, 0].reshape(shape))


# ---------------------------------------------------------------------------
# Core moves (QR-based, rank-preserving)
# ---------------------------------------------------------------------------


def _move_right(cores, i, V):
    """Replace site i by the left-orthogonal factor of V; absorb R into site
    i+1 (reference right_core_move als.jl:122-136)."""
    rl, n, rr = V.shape
    q, r = jnp.linalg.qr(V.reshape(rl * n, rr))
    cores[i] = q.reshape(rl, n, -1)
    cores[i + 1] = jnp.einsum("ab,bnc->anc", r, cores[i + 1])


def _move_left(cores, i, V):
    """Replace site i by the right-orthogonal factor of V; absorb L into site
    i-1 (reference left_core_move als.jl:104-120)."""
    rl, n, rr = V.shape
    qt, rt = jnp.linalg.qr(V.reshape(rl, n * rr).T)
    cores[i] = qt.T.reshape(-1, n, rr)
    cores[i - 1] = jnp.einsum("anb,bc->anc", cores[i - 1], rt.T)


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def als_linsolve(A: TTOperator, b: TTVector, x0: TTVector, sweep_count: int = 2,
                 it_solver: bool = False, r_itsolver: int = 5000,
                 return_info: bool = False, config=None, telemetry=None):
    """Solve ``A x = b`` with fixed ranks taken from ``x0``
    (reference als_linsolve /root/reference/src/solvers/als.jl:161-225).

    ``sweep_count`` counts half-sweeps exactly like the reference: 2 = one
    forward + one backward half-sweep; odd values end after a forward pass.

    ``config`` (:class:`ttnx.config.ALSConfig`) overrides the option
    defaults; ``telemetry`` (:class:`ttnx.utils.profiling.SolverTelemetry`)
    collects per-half-sweep residuals, rank history, local-solve counts and
    wall time (costs one extra MPO·MPS + norm per half sweep).
    """
    del it_solver, r_itsolver  # dense local solves; sizes here are small
    if config is not None:
        sweep_count = config.sweep_count
        return_info = config.return_info
    t_start = time.perf_counter()
    d = A.N
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, b.dtype, x.dtype)
    if x.dtype != dt:
        x = x.astype(dt)
    A = A.astype(dt) if A.dtype != dt else A
    b = b.astype(dt) if b.dtype != dt else b
    cores = list(x.cores)

    R = init_right_envs(x, A)
    Rb = init_right_envs_b(x, b)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt)
    Lb = [None] * (d + 1)
    Lb[0] = _ones_env2(dt)

    def _telemetry_sweep():
        if telemetry is None:
            return
        cur = TTVector(cores)
        res = float(norm(sub(matvec(A, cur), b)) / jnp.maximum(
            norm(b), jnp.finfo(dt).eps))
        telemetry.record_sweep(residual=res, max_rank=max(cur.ranks))

    nsweeps = 0
    while nsweeps < sweep_count:
        nsweeps += 1
        for i in range(d - 1):  # forward half sweep
            V = _local_solve(L[i], A.cores[i], R[i + 1], Lb[i], b.cores[i],
                             Rb[i + 1])
            _move_right(cores, i, V)
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
            Lb[i + 1] = update_left_env_b(Lb[i], cores[i], b.cores[i])
            if telemetry is not None:
                telemetry.local_solves += 1
        _telemetry_sweep()
        if nsweeps >= sweep_count:
            break
        nsweeps += 1
        for i in range(d - 1, 0, -1):  # backward half sweep
            V = _local_solve(L[i], A.cores[i], R[i + 1], Lb[i], b.cores[i],
                             Rb[i + 1])
            _move_left(cores, i, V)
            R[i] = update_right_env(R[i + 1], cores[i], A.cores[i])
            Rb[i] = update_right_env_b(Rb[i + 1], cores[i], b.cores[i])
            if telemetry is not None:
                telemetry.local_solves += 1
        _telemetry_sweep()

    out = TTVector(cores)
    if telemetry is not None:
        telemetry.wall_seconds += time.perf_counter() - t_start
    if return_info:
        res = float(norm(sub(matvec(A, out), b)) / jnp.maximum(
            norm(b), jnp.finfo(dt).eps))
        return out, {"residual": res}
    return out


def als_eigsolve(A: TTOperator, x0: TTVector, sweep_schedule=None,
                 rmax_schedule=None, noise_schedule=None,
                 it_solver: bool = False, itslv_thresh: int = 1024,
                 maxiter: int = 200, linsolv_tol: float = 1e-8, key=None,
                 telemetry=None):
    """Smallest eigenpair of ``A`` by Rayleigh-quotient ALS with a staged
    rank-growth schedule (reference als_eigsolve
    /root/reference/src/solvers/als.jl:251-321).

    Returns ``(E, x)`` where ``E`` is the per-microstep eigenvalue history.
    ``telemetry`` collects the eigenvalue/rank history and local-solve count.
    """
    t_start = time.perf_counter()
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [max(x0.ranks)]
    if noise_schedule is None:
        noise_schedule = [0.0] * len(rmax_schedule)
    if not (len(rmax_schedule) == len(sweep_schedule) == len(noise_schedule)):
        raise ValueError("Sweep schedule error")

    d = A.N
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, x.dtype)
    if x.dtype != dt:
        x = x.astype(dt)
    A = A.astype(dt) if A.dtype != dt else A
    cores = list(x.cores)
    E: list[float] = []

    R = init_right_envs(x, A)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt)

    def eig_site(i):
        lam, V = _local_eigmin(L[i], A.cores[i], R[i + 1], cores[i],
                               it_solver=it_solver, itslv_thresh=itslv_thresh,
                               maxiter=maxiter, tol=linsolv_tol)
        E.append(float(jnp.real(lam)))
        if telemetry is not None:
            telemetry.local_solves += 1
            telemetry.record_sweep(energy=E[-1],
                                   max_rank=max(TTVector(cores).ranks))
        return V

    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                if telemetry is not None:
                    telemetry.wall_seconds += time.perf_counter() - t_start
                return np.asarray(E), TTVector(cores)
            x = TTVector(cores)
            x = increase_ranks(x, rmax_schedule[i_schedule],
                               noise=noise_schedule[i_schedule], key=key)
            x = orthogonalize(x, 0)
            cores = list(x.cores)
            R = init_right_envs(x, A)
            L = [None] * (d + 1)
            L[0] = _ones_env(dt)
        for i in range(d - 1):  # forward
            V = eig_site(i)
            _move_right(cores, i, V)
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
        for i in range(d - 1, 0, -1):  # backward
            V = eig_site(i)
            _move_left(cores, i, V)
            R[i] = update_right_env(R[i + 1], cores[i], A.cores[i])
    if telemetry is not None:
        telemetry.wall_seconds += time.perf_counter() - t_start
    return np.asarray(E), TTVector(cores)


def als_gen_eigsolv(A: TTOperator, S: TTOperator, x0: TTVector,
                    sweep_schedule=None, rmax_schedule=None, tol: float = 1e-10,
                    it_solver: bool = False, itslv_thresh: int = 2500,
                    key=None):
    """Generalized eigenproblem ``A x = lambda S x`` by ALS
    (reference als_gen_eigsolv /root/reference/src/solvers/als.jl:344-427)."""
    del tol, it_solver, itslv_thresh  # dense generalized local solves
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [max(x0.ranks)]

    d = A.N
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, S.dtype, x.dtype)
    if x.dtype != dt:
        x = x.astype(dt)
    A = A.astype(dt) if A.dtype != dt else A
    S = S.astype(dt) if S.dtype != dt else S
    cores = list(x.cores)
    E: list[float] = []

    R = init_right_envs(x, A)
    Rs = init_right_envs(x, S)
    L = [None] * (d + 1)
    Ls = [None] * (d + 1)
    L[0] = _ones_env(dt)
    Ls[0] = _ones_env(dt)

    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                return np.asarray(E), TTVector(cores)
            x = TTVector(cores)
            x = increase_ranks(x, rmax_schedule[i_schedule], key=key)
            x = orthogonalize(x, 0)
            cores = list(x.cores)
            R = init_right_envs(x, A)
            Rs = init_right_envs(x, S)
            L = [None] * (d + 1)
            Ls = [None] * (d + 1)
            L[0] = _ones_env(dt)
            Ls[0] = _ones_env(dt)
        for i in range(d - 1):
            lam, V = _local_gen_eigmin(L[i], A.cores[i], R[i + 1],
                                       Ls[i], S.cores[i], Rs[i + 1], cores[i])
            E.append(lam)
            _move_right(cores, i, V)
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
            Ls[i + 1] = update_left_env(Ls[i], cores[i], S.cores[i])
        for i in range(d - 1, 0, -1):
            lam, V = _local_gen_eigmin(L[i], A.cores[i], R[i + 1],
                                       Ls[i], S.cores[i], Rs[i + 1], cores[i])
            E.append(lam)
            _move_left(cores, i, V)
            R[i] = update_right_env(R[i + 1], cores[i], A.cores[i])
            Rs[i] = update_right_env(Rs[i + 1], cores[i], S.cores[i])
    return np.asarray(E), TTVector(cores)
