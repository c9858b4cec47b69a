"""DMRG-style N-site sweep solvers (N=1 single-site, N=2 two-site default).

Reference: TensorTrainNumerics.jl src/solvers/dmrg.jl. Formulation: the
N-site window operator is pre-contracted per window (``Amid``, dmrg.jl:38-46)
and the local problem reuses the ALS symmetric environments — the window solve
is literally the ALS local solve with a merged physical index, one einsum
chain per operation (replacing the reference's hand-written mutating loop nest,
dmrg.jl:99-168). Iterative local solves use jax CG / LOBPCG.
"""

from __future__ import annotations

import math
import time

import numpy as np
import jax.numpy as jnp

from ttnx.core.algebra import matvec, norm, sub
from ttnx.core.canonical import orthogonalize
from ttnx.core.tt import TTOperator, TTVector, increase_ranks, r_and_d_to_rks
from ttnx.solvers.als import (
    _ones_env,
    _ones_env2,
    init_right_envs,
    init_right_envs_b,
    local_matrix,
    local_matvec,
    local_rhs,
    update_left_env,
    update_left_env_b,
    update_right_env,
    update_right_env_b,
)

__all__ = ["dmrg_linsolve", "dmrg_eigsolve", "cut_off_index"]


def cut_off_index(s: np.ndarray, tol: float, degen_tol: float = 1e-10) -> int:
    """Relative SVD cutoff that refuses to split near-degenerate singular
    values (/root/reference/src/solvers/dmrg.jl:179-185)."""
    k = int(np.sum(s > np.linalg.norm(s) * tol))
    k = max(k, 1)
    while k < s.size and np.isclose(s[k - 1], s[k], rtol=degen_tol,
                                    atol=degen_tol):
        k += 1
    return k


def _amid(A: TTOperator, i: int, n_sites: int):
    """Pre-contract operator cores ``i .. i+n_sites-1`` into
    ``(r_A, n^N, n^N, r_A')`` with big-endian merged indices
    (reference Amid dmrg.jl:38-46)."""
    out = A.cores[i]
    for k in range(i + 1, i + n_sites):
        a = out
        bcore = A.cores[k]
        r, ni, mi, _ = a.shape
        _, nk, mk, rn = bcore.shape
        out = jnp.einsum("aijb,bklc->aikjlc", a, bcore).reshape(
            r, ni * nk, mi * mk, rn)
    return out


def _bmid(b: TTVector, i: int, n_sites: int):
    """(reference b_mid dmrg.jl:83-90)"""
    out = b.cores[i]
    for k in range(i + 1, i + n_sites):
        a = out
        bcore = b.cores[k]
        r, ni, _ = a.shape
        _, nk, rn = bcore.shape
        out = jnp.einsum("aib,bjc->aijc", a, bcore).reshape(r, ni * nk, rn)
    return out


def _local_solve(L, Am, R, Lb, bm, Rb, v0, it_solver, itslv_thresh, maxiter,
                 tol):
    """N-site local linear solve: dense below the threshold, CG on the
    symmetrized matrix-free operator above (reference Ksolve! dmrg.jl:92-177)."""
    pb = local_rhs(Lb, bm, Rb)
    m = int(np.prod(pb.shape))
    if it_solver and m > itslv_thresh:
        from jax.scipy.sparse.linalg import cg

        def op(v):
            fwd = local_matvec(L, Am, R, v)
            adj = jnp.conj(local_matvec(
                jnp.conj(L.transpose(2, 1, 0)),
                jnp.conj(Am.transpose(3, 2, 1, 0)).transpose(0, 2, 1, 3),
                jnp.conj(R.transpose(2, 1, 0)),
                jnp.conj(v)))
            return 0.5 * (fwd + adj)

        v, _ = cg(op, pb, x0=v0, tol=tol, maxiter=maxiter)
        return v
    K = local_matrix(L, Am, R)
    return jnp.linalg.solve(K, pb.reshape(-1)).reshape(pb.shape)


def _local_eigmin(L, Am, R, v0, it_solver, itslv_thresh, maxiter, tol):
    """N-site smallest eigenpair (reference K_eigmin dmrg.jl:235-259)."""
    shape = v0.shape
    m = int(np.prod(shape))
    if (it_solver and m > itslv_thresh
            and not jnp.issubdtype(v0.dtype, jnp.complexfloating) and m > 4):
        from jax.experimental.sparse.linalg import lobpcg_standard

        K = local_matrix(L, Am, R)
        K = 0.5 * (K + K.conj().T)
        sigma = jnp.linalg.norm(K, ord=1)
        shifted = sigma * jnp.eye(m, dtype=K.dtype) - K
        theta, U, _ = lobpcg_standard(shifted, v0.reshape(m, 1), m=maxiter,
                                      tol=tol)
        return sigma - theta[0], U[:, 0].reshape(shape)
    K = local_matrix(L, Am, R)
    K = 0.5 * (K + K.conj().T)
    w, U = jnp.linalg.eigh(K)
    return w[0], U[:, 0].reshape(shape)


def _split_window_right(V, dims_window, tol, rmax, verbose=False):
    """Split the first site off the window solution moving right: left-orth
    U core + transported remainder (reference right_core_move! dmrg.jl:187-209).
    ``V`` has shape ``(r_l, prod(dims_window), r_r)``."""
    rl, _, rr = V.shape
    n0 = dims_window[0]
    rest = int(np.prod(dims_window[1:])) if len(dims_window) > 1 else 1
    u, s, vt = jnp.linalg.svd(V.reshape(rl * n0, rest * rr),
                              full_matrices=False)
    keep = min(cut_off_index(np.asarray(s), tol), rmax)
    if verbose:
        s_host = np.asarray(s)
        print(f"  rank={keep} rmax={rmax} discarded_weight="
              f"{(np.linalg.norm(s_host) - np.linalg.norm(s_host[:keep])) / np.linalg.norm(s_host):.3e}")
    core = u[:, :keep].reshape(rl, n0, keep)
    v_move = (s[:keep, None] * vt[:keep, :]).reshape(keep, rest, rr)
    return core, v_move, keep


def _split_window_left(V, dims_window, tol, rmax, verbose=False):
    """Split the last site off moving left (reference left_core_move!
    dmrg.jl:211-232)."""
    rl, _, rr = V.shape
    nl = dims_window[-1]
    rest = int(np.prod(dims_window[:-1])) if len(dims_window) > 1 else 1
    u, s, vt = jnp.linalg.svd(V.reshape(rl * rest, nl * rr),
                              full_matrices=False)
    keep = min(cut_off_index(np.asarray(s), tol), rmax)
    if verbose:
        s_host = np.asarray(s)
        print(f"  rank={keep} rmax={rmax} discarded_weight="
              f"{(np.linalg.norm(s_host) - np.linalg.norm(s_host[:keep])) / np.linalg.norm(s_host):.3e}")
    core = vt[:keep, :].reshape(keep, nl, rr)
    v_move = (u[:, :keep] * s[None, :keep]).reshape(rl, rest, keep)
    return core, v_move, keep


def _finalize_window(cores, V, dims_window, tol, rmax):
    """Write the final window solution at sites ``0..N-1`` back as cores,
    right-orthogonalizing all inner bonds (reference dmrg.jl:427-440)."""
    n_sites = len(dims_window)
    if n_sites == 1:
        cores[0] = V
        return
    cur = V  # (1, prod(dims), r)
    for j in range(n_sites - 1, 0, -1):
        core, cur, _ = _split_window_left(cur, dims_window[: j + 1], tol, rmax)
        cores[j] = core
    cores[0] = cur.reshape(1, dims_window[0], -1)


def _default_rmax(dims) -> int:
    return int(math.isqrt(int(np.prod(dims))))


def _run_dmrg(A, x0, n_sites, tol, sweep_schedule, rmax_schedule, it_solver,
              maxiter, lin_tol, itslv_thresh, verbose, b=None,
              collect_energy=False):
    """Shared DMRG sweep driver for linsolve (``b`` given) and eigsolve."""
    d = A.N
    rmax = max(rmax_schedule)
    if n_sites == 1 and rmax > max(x0.ranks):
        x0 = increase_ranks(x0, rmax)
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, x.dtype, *( [b.dtype] if b is not None else []))
    x = x.astype(dt) if x.dtype != dt else x
    A = A.astype(dt) if A.dtype != dt else A
    if b is not None and b.dtype != dt:
        b = b.astype(dt)
    dims = x.dims
    cores = list(x.cores)
    rks = list(x.ranks)

    n_windows = d + 1 - n_sites
    amids = [_amid(A, i, n_sites) for i in range(n_windows)]
    bmids = [_bmid(b, i, n_sites) for i in range(n_windows)] if b is not None else None

    R = init_right_envs(x, A)
    L = [None] * (d + 1)
    L[0] = _ones_env(dt)
    if b is not None:
        Rb = init_right_envs_b(x, b)
        Lb = [None] * (d + 1)
        Lb[0] = _ones_env2(dt)

    E: list[float] = []
    r_hist: list[int] = []
    warm = None  # transported warm start for the next window

    def window_guess(i):
        if warm is not None:
            return warm
        out = cores[i]
        for k in range(i + 1, i + n_sites):
            r, ni, _ = out.shape
            _, nk, rn = cores[k].shape
            out = jnp.einsum("aib,bjc->aijc", out, cores[k]).reshape(
                r, ni * nk, rn)
        return out

    def solve_window(i):
        v0 = window_guess(i)
        if b is not None:
            return _local_solve(L[i], amids[i], R[i + n_sites], Lb[i],
                                bmids[i], Rb[i + n_sites], v0, it_solver,
                                itslv_thresh, maxiter, lin_tol)
        lam, V = _local_eigmin(L[i], amids[i], R[i + n_sites], v0, it_solver,
                               itslv_thresh, maxiter, lin_tol)
        E.append(float(jnp.real(lam)))
        return V

    nsweeps = 0
    i_schedule = 0
    while i_schedule < len(sweep_schedule):
        nsweeps += 1
        if nsweeps == sweep_schedule[i_schedule]:
            i_schedule += 1
            if i_schedule >= len(sweep_schedule):
                # final completion solve at window 0 (reference dmrg.jl:427-440)
                V = solve_window(0)
                if collect_energy:
                    r_hist.append(max(rks))
                _finalize_window(cores, V, dims[:n_sites], tol,
                                 rmax_schedule[-1])
                for j in range(1, n_sites):
                    rks[j] = cores[j].shape[0]
                out = TTVector(cores, [0] + [-1] * (d - 1))
                return out, E, r_hist
        stage_rmax = rmax_schedule[i_schedule]

        for i in range(n_windows - 1):  # forward half sweep
            V = solve_window(i)
            core, v_move, keep = _split_window_right(
                V, dims[i: i + n_sites], tol, stage_rmax, verbose)
            cores[i] = core
            rks[i + 1] = keep
            # transported warm start: remainder x next core to the right
            nxt = cores[i + n_sites]
            r, m, _ = v_move.shape
            _, nk, rn = nxt.shape
            warm = jnp.einsum("amb,bkc->amkc", v_move, nxt).reshape(
                r, m * nk, rn)
            L[i + 1] = update_left_env(L[i], cores[i], A.cores[i])
            if b is not None:
                Lb[i + 1] = update_left_env_b(Lb[i], cores[i], b.cores[i])
            r_hist.append(max(rks))

        # NOTE: `warm` from the last forward step is the guess for the first
        # backward window — cores right of the forward frontier are stale, so
        # the transported warm start is the only shape-consistent guess
        # (reference carries V0_view across half-sweeps, dmrg.jl:452,466).
        for i in range(n_windows - 1, 0, -1):  # backward half sweep
            V = solve_window(i)
            core, v_move, keep = _split_window_left(
                V, dims[i: i + n_sites], tol, stage_rmax, verbose)
            j = i + n_sites - 1
            cores[j] = core
            rks[j] = keep
            # transported warm start: previous core x remainder
            prv = cores[i - 1]
            _, m, r = v_move.shape
            rp, nk, _ = prv.shape
            warm = jnp.einsum("akb,bmc->akmc", prv, v_move).reshape(
                rp, nk * m, r)
            R[j] = update_right_env(R[j + 1], cores[j], A.cores[j])
            if b is not None:
                Rb[j] = update_right_env_b(Rb[j + 1], cores[j], b.cores[j])
            r_hist.append(max(rks))
        # after the backward pass `warm` targets window 0 — exactly the next
        # forward (or final completion) solve.

    return TTVector(cores), E, r_hist


def dmrg_linsolve(A: TTOperator, b: TTVector, x0: TTVector, n_sites: int = 2,
                  tol: float = 1e-12, sweep_schedule=None, rmax_schedule=None,
                  it_solver: bool = True, linsolv_maxiter: int = 200,
                  linsolv_tol: float | None = None, itslv_thresh: int = 256,
                  return_info: bool = False, verbose: bool = False,
                  config=None, telemetry=None):
    """Solve ``A x = b`` with N-site DMRG sweeps
    (reference dmrg_linsolve /root/reference/src/solvers/dmrg.jl:385-473).

    ``config`` (:class:`ttnx.config.DMRGConfig`) overrides the option
    defaults; ``telemetry`` collects rank history, solve counts, wall time."""
    if config is not None:
        n_sites, tol = config.n_sites, config.tol
        sweep_schedule = list(config.sweep_schedule)
        rmax_schedule = (list(config.rmax_schedule)
                         if config.rmax_schedule is not None else None)
        it_solver = config.it_solver
        linsolv_maxiter = config.linsolv_maxiter
        itslv_thresh = config.itslv_thresh
    t_start = time.perf_counter()
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [_default_rmax(x0.dims)]
    if len(rmax_schedule) != len(sweep_schedule):
        raise ValueError("Sweep schedule error")
    if linsolv_tol is None:
        linsolv_tol = max(math.sqrt(tol), 1e-8)
    out, _, r_hist = _run_dmrg(A, x0, n_sites, tol, sweep_schedule,
                               rmax_schedule, it_solver, linsolv_maxiter,
                               linsolv_tol, itslv_thresh, verbose, b=b)
    if telemetry is not None:
        telemetry.local_solves += len(r_hist)
        telemetry.max_ranks.extend(int(r) for r in r_hist)
        dt_out = out.dtype
        res = float(norm(sub(matvec(A.astype(dt_out), out), b.astype(dt_out)))
                    / jnp.maximum(norm(b), jnp.finfo(b.dtype).eps))
        telemetry.record_sweep(residual=res)
        telemetry.wall_seconds += time.perf_counter() - t_start
    if return_info:
        dt = out.dtype
        res = float(norm(sub(matvec(A.astype(dt), out), b.astype(dt)))
                    / jnp.maximum(norm(b), jnp.finfo(b.dtype).eps))
        return out, {"residual": res}
    return out


def dmrg_eigsolve(A: TTOperator, x0: TTVector, n_sites: int = 2,
                  tol: float = 1e-12, sweep_schedule=None, rmax_schedule=None,
                  it_solver: bool = False, linsolv_maxiter: int = 200,
                  linsolv_tol: float | None = None, itslv_thresh: int = 256,
                  verbose: bool = False, config=None, telemetry=None):
    """Lowest eigenpair by N-site DMRG; returns ``(E, x, r_hist)``
    (reference dmrg_eigsolve /root/reference/src/solvers/dmrg.jl:501-578).

    ``config`` (:class:`ttnx.config.DMRGConfig`) overrides the option
    defaults; ``telemetry`` collects energy/rank histories and wall time."""
    if config is not None:
        n_sites, tol = config.n_sites, config.tol
        sweep_schedule = list(config.sweep_schedule)
        rmax_schedule = (list(config.rmax_schedule)
                         if config.rmax_schedule is not None else None)
        it_solver = config.it_solver
        linsolv_maxiter = config.linsolv_maxiter
        itslv_thresh = config.itslv_thresh
    t_start = time.perf_counter()
    if sweep_schedule is None:
        sweep_schedule = [2]
    if rmax_schedule is None:
        rmax_schedule = [_default_rmax(x0.dims)]
    if len(rmax_schedule) != len(sweep_schedule):
        raise ValueError("Sweep schedule error")
    if linsolv_tol is None:
        linsolv_tol = max(math.sqrt(tol), 1e-8)
    out, E, r_hist = _run_dmrg(A, x0, n_sites, tol, sweep_schedule,
                               rmax_schedule, it_solver, linsolv_maxiter,
                               linsolv_tol, itslv_thresh, verbose,
                               collect_energy=True)
    if telemetry is not None:
        telemetry.local_solves += len(r_hist)
        telemetry.energies.extend(float(e) for e in E)
        telemetry.max_ranks.extend(int(r) for r in r_hist)
        telemetry.wall_seconds += time.perf_counter() - t_start
    return np.asarray(E), out, np.asarray(r_hist)
