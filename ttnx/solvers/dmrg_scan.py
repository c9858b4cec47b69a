"""Jitted rank-adaptive DMRG: two-site sweeps with MATRIX-FREE local solvers.

The scan-tier counterpart of :mod:`ttnx.solvers.dmrg` (reference semantics:
/root/reference/src/solvers/dmrg.jl:385-578). Differences from
:mod:`ttnx.solvers.mals_scan`, mirroring what distinguishes DMRG from MALS in
the reference:

* **Matrix-free local solves.** MALS-scan assembles the dense two-site
  operator ``K`` of size ``(R n n R)^2`` — prohibitive past rank ~16. Here the
  local smallest-eigenpair problem runs fixed-iteration **Lanczos with full
  reorthogonalization** (the jittable analog of the reference's
  ``KrylovKit.eigsolve(:SR)`` matvec path, dmrg.jl:235-259) and the local
  linear solve runs fixed-iteration **CG** (the analog of the mutating
  ``KrylovKit.linsolve`` matvec, dmrg.jl:92-177). Every matvec is one einsum;
  nothing of size ``M^2`` is ever materialized.
* **Warm starts.** The merged previous two-site block seeds the Krylov space
  (reference: the transported ``V0`` workspace, dmrg.jl:312-326).
* **Degeneracy-aware truncation.** The keep rule is the reference's
  ``cut_off_index`` (dmrg.jl:179-185): relative threshold
  ``s > tol * |s|`` extended so a near-degenerate multiplet is never split —
  expressed as a runtime 0/1 mask over the fixed-width singular-value vector
  (masks are data; truncation never changes buffer shapes or retraces).

Padding invariant: Krylov vectors live in the masked subspace (the start
vector and every matvec are projected), so padded directions never couple in;
dead Krylov directions (subspace smaller than the iteration budget) are
detected by beta-breakdown and pushed above the spectral range in the small
tridiagonal eigenproblem.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ttnx.core.canonical import orthogonalize
from ttnx.core.tt import TTOperator, TTVector
from ttnx.solvers.als_scan import (
    _boundary_env,
    _boundary_env_b,
    pack_op,
    pack_tt,
    unpack_tt,
)

__all__ = ["dmrg_sweep", "dmrg_linsolve_scan", "dmrg_eig_sweep",
           "dmrg_eigsolve_scan", "cut_off_mask"]


def cut_off_mask(s, tol, degen_tol=1e-10):
    """Runtime 0/1 keep mask implementing the reference ``cut_off_index``
    rule (dmrg.jl:179-185): keep ``s > tol * |s|``, then extend the cut while
    the boundary singular values are within ``degen_tol`` of each other
    (refuse to split a near-degenerate multiplet)."""
    R = s.shape[0]
    nrm = jnp.linalg.norm(s)
    base = (s > tol * nrm)
    base = base.at[0].set(True)
    # close[i]: s[i] ~ s[i+1] under isapprox(rtol=atol=degen_tol)
    close = jnp.abs(s[:-1] - s[1:]) <= (
        degen_tol + degen_tol * jnp.maximum(jnp.abs(s[:-1]), jnp.abs(s[1:])))

    def step(prev_keep, inp):
        base_i, close_prev = inp
        keep = jnp.logical_or(base_i, jnp.logical_and(prev_keep, close_prev))
        return keep, keep

    _, ext = lax.scan(step, base[0], (base[1:], close))
    keep = jnp.concatenate([base[:1], ext])
    return keep.astype(s.dtype)


# ---------------------------------------------------------------------------
# Matrix-free two-site local operator
# ---------------------------------------------------------------------------


def _window_mask(m_l, m_r, n):
    return (m_l[:, None, None, None] * m_r[None, None, None, :]
            * jnp.ones((1, n, n, 1), dtype=m_l.dtype))


def _apply2(L, Ai, Aj, Renv, v):
    """Two-site effective operator applied to ``v[b, I, J, d]`` -> bra index
    order ``[a, i, j, c]`` (env layout (bra, op, ket) as in als_scan)."""
    return jnp.einsum("aWb,WiIw,wjJv,cvd,bIJd->aijc", L, Ai, Aj, Renv, v,
                      optimize=True)


def _lanczos_eigmin(L, Ai, Aj, Renv, v0, mask4, iters: int):
    """Smallest Ritz pair of the masked two-site operator via fixed-iteration
    Lanczos with full reorthogonalization. ``v0``: warm start (masked)."""
    R = v0.shape[0]
    n = v0.shape[1]
    M = R * n * n * R
    maskf = mask4.reshape(M)
    rdt = jnp.zeros((), v0.dtype).real.dtype

    def apply_flat(vf):
        out = _apply2(L, Ai, Aj, Renv, (vf * maskf).reshape(R, n, n, R))
        return out.reshape(M) * maskf

    v0f = v0.reshape(M) * maskf
    nrm0 = jnp.linalg.norm(v0f)
    fallback = maskf / jnp.maximum(jnp.linalg.norm(maskf), 1e-30)
    v0f = jnp.where(nrm0 > 1e-12, v0f / jnp.maximum(nrm0, 1e-30),
                    fallback.astype(v0f.dtype))

    basis0 = jnp.zeros((iters, M), dtype=v0f.dtype).at[0].set(v0f)

    def body(j, state):
        basis, alphas, betas, dead = state
        vj = basis[j]
        w = apply_flat(vj)
        a = jnp.real(jnp.vdot(vj, w)).astype(rdt)
        alphas = alphas.at[j].set(a)
        # full reorthogonalization against the whole stored basis
        coeffs = jnp.conj(basis) @ w          # (iters,)
        w = w - basis.T @ coeffs
        coeffs2 = jnp.conj(basis) @ w
        w = w - basis.T @ coeffs2
        b = jnp.linalg.norm(w).astype(rdt)
        is_dead = jnp.logical_or(dead, b < 1e-12)
        betas = betas.at[j].set(jnp.where(is_dead, 0.0, b))
        v_next = jnp.where(is_dead, jnp.zeros_like(w),
                           w / jnp.maximum(b, 1e-30))
        basis = lax.cond(j + 1 < iters,
                         lambda bs: bs.at[j + 1].set(v_next),
                         lambda bs: bs, basis)
        return basis, alphas, betas, is_dead

    alphas0 = jnp.zeros((iters,), dtype=rdt)
    betas0 = jnp.zeros((iters,), dtype=rdt)
    basis, alphas, betas, _ = lax.fori_loop(
        0, iters, body, (basis0, alphas0, betas0, jnp.asarray(False)))

    # dead directions: every j whose basis vector is exactly zero
    alive = (jnp.sum(jnp.abs(basis) ** 2, axis=1) > 0.0)
    pad = jnp.max(jnp.abs(alphas)) + 2.0 * jnp.max(jnp.abs(betas)) + 1.0
    alphas = jnp.where(alive, alphas, pad)
    T = (jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1))
    theta, Y = jnp.linalg.eigh(T)
    ritz = (basis.T @ Y[:, 0].astype(basis.dtype)).reshape(R, n, n, R)
    nrm = jnp.linalg.norm(ritz)
    ritz = ritz / jnp.maximum(nrm, 1e-30)
    return theta[0], ritz * mask4


def _cg_solve2(L, Ai, Aj, Renv, Lb, bi, bj, Rb_env, v0, mask4,
               iters: int):
    """Fixed-iteration CG on the masked two-site normal form (SPD local
    operators, e.g. implicit time stepping); warm-started at ``v0``."""
    rhs = jnp.einsum("au,uiv,vjw,cw->aijc", Lb, bi, bj, Rb_env,
                     optimize=True) * mask4

    def apply_k(v):
        return _apply2(L, Ai, Aj, Renv, v * mask4) * mask4

    x = v0 * mask4
    r = rhs - apply_k(x)
    p = r
    rs = jnp.vdot(r, r)

    def body(_, state):
        x, r, p, rs = state
        ap = apply_k(p)
        denom = jnp.vdot(p, ap)
        alpha = jnp.where(jnp.abs(denom) > 0, rs / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = jnp.vdot(r, r)
        beta = jnp.where(jnp.abs(rs) > 0, rs_new / rs, 0.0)
        p = r + beta * p
        return (x, r, p, rs_new)

    x, _, _, _ = lax.fori_loop(0, iters, body, (x, r, p, rs))
    return x


# ---------------------------------------------------------------------------
# Sweeps (structure mirrors mals_scan; local solves are matrix-free)
# ---------------------------------------------------------------------------


def _split_right(V, tol, degen_tol, R, n, method="svd"):
    Vm = V.reshape(R * n, n * R)
    if method == "gram":
        # eigh of the (Rn, Rn) Gram instead of SVD: u = desc eigenvectors,
        # s = sqrt(desc eigenvalues), and u^H Vm == s*vt exactly.
        # Squared-condition accuracy trade as in tt_round_gram.
        B = Vm @ jnp.conj(Vm).T
        w, U = jnp.linalg.eigh(0.5 * (B + jnp.conj(B).T))
        s = jnp.sqrt(jnp.maximum(w[::-1], 0.0))
        u = U[:, ::-1]
        svt = jnp.conj(u).T @ Vm
    else:
        u, s, vt = jnp.linalg.svd(Vm, full_matrices=False)
        svt = s[:, None] * vt
    keep = cut_off_mask(s, tol, degen_tol)[:R]
    core = (u[:, :R] * keep[None, :]).reshape(R, n, R)
    rest = (svt[:R, :] * keep[:, None]).reshape(R, n, R)
    return core, rest, keep


def _split_left(V, tol, degen_tol, R, n, method="svd"):
    Vm = V.reshape(R * n, n * R)
    if method == "gram":
        B = jnp.conj(Vm).T @ Vm
        w, W = jnp.linalg.eigh(0.5 * (B + jnp.conj(B).T))
        s = jnp.sqrt(jnp.maximum(w[::-1], 0.0))
        v2 = W[:, ::-1]                       # right singular vectors
        vt = jnp.conj(v2).T
        us = Vm @ v2                          # columns u_i * s_i
    else:
        u, s, vt = jnp.linalg.svd(Vm, full_matrices=False)
        us = u * s[None, :]
    keep = cut_off_mask(s, tol, degen_tol)[:R]
    core = (vt[:R, :] * keep[:, None]).reshape(R, n, R)
    rest = (us[:, :R] * keep[None, :]).reshape(R, n, R)
    return core, rest, keep


@partial(jax.jit, static_argnames=("lanczos_iters", "split"))
def dmrg_eig_sweep(A_stack, x_stack, mask_stack, tol, degen_tol,
                   lanczos_iters: int = 24, split: str = "svd"):
    """One full (forward + backward) jitted two-site DMRG eigsweep with
    matrix-free Lanczos local solves and warm starts; returns
    ``(x_stack, mask_stack, energies)``."""
    d, R, n, _ = x_stack.shape
    dt = x_stack.dtype
    RA = A_stack.shape[1]

    def right_envs(x, masks):
        init = _boundary_env(R, RA, dt)

        def step(carry, inp):
            xc, Ac, mr = inp
            xc = xc * mr[None, None, :]
            new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(xc), Ac, xc,
                             carry, optimize=True)
            return new, new

        _, envs = lax.scan(step, init, (x, A_stack, masks[1:]), reverse=True)
        return jnp.concatenate([envs, init[None]], axis=0)

    Renvs = right_envs(x_stack, mask_stack)

    def fwd(carry, inp):
        L, m_l, last = carry
        Ai, Aj, xj, Renv, m_r = inp
        mask4 = _window_mask(m_l, m_r, n)
        v0 = jnp.einsum("anb,bmc->anmc", last, xj * m_r[None, None, :])
        lam, V = _lanczos_eigmin(L, Ai, Aj, Renv, v0, mask4,
                                 lanczos_iters)
        core, rest, keep = _split_right(V, tol, degen_tol, R, n, split)
        L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(core), L, Ai,
                           core, optimize=True)
        return (L_new, keep, rest), (core, keep, lam)

    L0 = _boundary_env(R, RA, dt)
    m0 = jnp.zeros((R,), dtype=mask_stack.dtype).at[0].set(1.0)
    inputs = (A_stack[:-1], A_stack[1:], x_stack[1:], Renvs[2:],
              mask_stack[2:])
    (L, _, last), (fwd_cores, fwd_masks, lams_f) = lax.scan(
        fwd, (L0, m0, x_stack[0]), inputs)
    x_mid = jnp.concatenate([fwd_cores, last[None]], axis=0)
    masks_mid = jnp.concatenate(
        [mask_stack[0][None], fwd_masks, mask_stack[d][None]], axis=0)

    def left_envs(x, masks):
        init = _boundary_env(R, RA, dt)

        def step(carry, inp):
            xc, Ac, mr = inp
            xc = xc * mr[None, None, :]
            new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(xc), carry, Ac,
                             xc, optimize=True)
            return new, new

        _, envs = lax.scan(step, init, (x, A_stack, masks[1:]))
        return jnp.concatenate([init[None], envs], axis=0)

    Lenvs = left_envs(x_mid, masks_mid)

    def bwd(carry, inp):
        Renv, m_r, first = carry
        Ai, Aj, xi, Lenv, m_l = inp
        mask4 = _window_mask(m_l, m_r, n)
        v0 = jnp.einsum("anb,bmc->anmc", xi * m_l[:, None, None], first)
        lam, V = _lanczos_eigmin(Lenv, Ai, Aj, Renv, v0, mask4,
                                 lanczos_iters)
        core, rest, keep = _split_left(V, tol, degen_tol, R, n, split)
        R_new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(core), Aj, core,
                           Renv, optimize=True)
        return (R_new, keep, rest), (core, keep, lam)

    R0 = _boundary_env(R, RA, dt)
    inputs_b = (A_stack[:-1], A_stack[1:], x_mid[:-1], Lenvs[: d - 1],
                masks_mid[: d - 1])
    (Renv, _, first), (bwd_cores, bwd_masks, lams_b) = lax.scan(
        bwd, (R0, m0, x_mid[d - 1]), inputs_b, reverse=True)
    x_out = jnp.concatenate([first[None], bwd_cores], axis=0)
    masks_out = jnp.concatenate(
        [mask_stack[0][None], bwd_masks, mask_stack[d][None]], axis=0)
    return x_out, masks_out, jnp.concatenate([lams_f, lams_b[::-1]])


@partial(jax.jit, static_argnames=("cg_iters", "split"))
def dmrg_sweep(A_stack, b_stack, x_stack, mask_stack, tol, degen_tol,
               cg_iters: int = 48, split: str = "svd"):
    """One full jitted two-site DMRG linsolve sweep (CG local solves,
    warm-started); returns ``(x_stack, mask_stack)``. ``split='gram'``
    replaces the in-scan SVD with the eigh-based split."""
    d, R, n, _ = x_stack.shape
    dt = x_stack.dtype
    RA = A_stack.shape[1]
    Rb = b_stack.shape[1]

    def right_envs(x, masks):
        init = (_boundary_env(R, RA, dt), _boundary_env_b(R, Rb, dt))

        def step(carry, inp):
            Renv, Rb_env = carry
            xc, Ac, bc, mr = inp
            xc = xc * mr[None, None, :]
            new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(xc), Ac, xc,
                             Renv, optimize=True)
            new_b = jnp.einsum("aip,uiv,pv->au", jnp.conj(xc), bc, Rb_env,
                               optimize=True)
            return (new, new_b), (new, new_b)

        (_, _), (envs, envs_b) = lax.scan(step, init,
                                          (x, A_stack, b_stack, masks[1:]),
                                          reverse=True)
        envs = jnp.concatenate([envs, init[0][None]], axis=0)
        envs_b = jnp.concatenate([envs_b, init[1][None]], axis=0)
        return envs, envs_b

    Renvs, Rb_envs = right_envs(x_stack, mask_stack)

    def fwd(carry, inp):
        L, Lb, m_l, last = carry
        Ai, Aj, bi, bj, xj, Renv, Rb_env, m_r = inp
        mask4 = _window_mask(m_l, m_r, n)
        v0 = jnp.einsum("anb,bmc->anmc", last, xj * m_r[None, None, :])
        V = _cg_solve2(L, Ai, Aj, Renv, Lb, bi, bj, Rb_env, v0, mask4,
                       cg_iters)
        core, rest, keep = _split_right(V, tol, degen_tol, R, n, split)
        L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(core), L, Ai,
                           core, optimize=True)
        Lb_new = jnp.einsum("aip,au,uiv->pv", jnp.conj(core), Lb, bi,
                            optimize=True)
        return (L_new, Lb_new, keep, rest), (core, keep)

    L0 = _boundary_env(R, RA, dt)
    Lb0 = _boundary_env_b(R, Rb, dt)
    m0 = jnp.zeros((R,), dtype=mask_stack.dtype).at[0].set(1.0)
    inputs = (A_stack[:-1], A_stack[1:], b_stack[:-1], b_stack[1:],
              x_stack[1:], Renvs[2:], Rb_envs[2:], mask_stack[2:])
    (L, Lb, _, last), (fwd_cores, fwd_masks) = lax.scan(
        fwd, (L0, Lb0, m0, x_stack[0]), inputs)
    x_mid = jnp.concatenate([fwd_cores, last[None]], axis=0)
    masks_mid = jnp.concatenate(
        [mask_stack[0][None], fwd_masks, mask_stack[d][None]], axis=0)

    def left_envs(x, masks):
        init = (_boundary_env(R, RA, dt), _boundary_env_b(R, Rb, dt))

        def step(carry, inp):
            L, Lb = carry
            xc, Ac, bc, mr = inp
            xc = xc * mr[None, None, :]
            L_new = jnp.einsum("aic,aWb,Wijw,bjd->cwd", jnp.conj(xc), L, Ac,
                               xc, optimize=True)
            Lb_new = jnp.einsum("aip,au,uiv->pv", jnp.conj(xc), Lb, bc,
                                optimize=True)
            return (L_new, Lb_new), (L_new, Lb_new)

        (_, _), (envs, envs_b) = lax.scan(step, init,
                                          (x, A_stack, b_stack, masks[1:]))
        envs = jnp.concatenate([init[0][None], envs], axis=0)
        envs_b = jnp.concatenate([init[1][None], envs_b], axis=0)
        return envs, envs_b

    Lenvs, Lb_envs = left_envs(x_mid, masks_mid)

    def bwd(carry, inp):
        Renv, Rb_env, m_r, first = carry
        Ai, Aj, bi, bj, xi, Lenv, Lb_env, m_l = inp
        mask4 = _window_mask(m_l, m_r, n)
        v0 = jnp.einsum("anb,bmc->anmc", xi * m_l[:, None, None], first)
        V = _cg_solve2(Lenv, Ai, Aj, Renv, Lb_env, bi, bj, Rb_env, v0, mask4,
                       cg_iters)
        core, rest, keep = _split_left(V, tol, degen_tol, R, n, split)
        R_new = jnp.einsum("aip,Wijw,bjq,pwq->aWb", jnp.conj(core), Aj, core,
                           Renv, optimize=True)
        Rb_new = jnp.einsum("aip,uiv,pv->au", jnp.conj(core), bj, Rb_env,
                            optimize=True)
        return (R_new, Rb_new, keep, rest), (core, keep)

    R0 = _boundary_env(R, RA, dt)
    Rb0 = _boundary_env_b(R, Rb, dt)
    inputs_b = (A_stack[:-1], A_stack[1:], b_stack[:-1], b_stack[1:],
                x_mid[:-1], Lenvs[: d - 1], Lb_envs[: d - 1],
                masks_mid[: d - 1])
    (Renv, Rb_env, _, first), (bwd_cores, bwd_masks) = lax.scan(
        bwd, (R0, Rb0, m0, x_mid[d - 1]), inputs_b, reverse=True)
    x_out = jnp.concatenate([first[None], bwd_cores], axis=0)
    masks_out = jnp.concatenate(
        [mask_stack[0][None], bwd_masks, mask_stack[d][None]], axis=0)
    return x_out, masks_out


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _init_masks(x, rmax, real_dt):
    mask_np = np.zeros((x.N + 1, rmax))
    for i, r in enumerate(x.ranks):
        mask_np[i, :r] = 1.0
    return jnp.asarray(mask_np, dtype=real_dt)


def dmrg_eigsolve_scan(A: TTOperator, x0: TTVector, tol: float = 1e-12,
                       degen_tol: float = 1e-10, rmax: int | None = None,
                       n_sweeps: int = 2, lanczos_iters: int = 24,
                       split: str = "svd"):
    """Jitted rank-adaptive two-site DMRG ground-state solver with
    matrix-free Lanczos local eigensolves; returns ``(E, x)``."""
    if rmax is None:
        rmax = min(int(round(np.sqrt(float(np.prod(x0.dims))))), 64)
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, x.dtype)
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    x_stack = pack_tt(x.astype(dt), rmax)
    real_dt = jnp.zeros((), dt).real.dtype
    masks = _init_masks(x, rmax, real_dt)
    tol_arr = jnp.asarray(tol, real_dt)
    dg_arr = jnp.asarray(degen_tol, real_dt)
    energies = []
    for _ in range(n_sweeps):
        x_stack, masks, lams = dmrg_eig_sweep(A_stack, x_stack, masks,
                                              tol_arr, dg_arr,
                                              lanczos_iters=lanczos_iters,
                                              split=split)
        energies.append(np.asarray(jnp.real(lams)))
    rks = [int(v) for v in np.asarray(jnp.sum(masks, axis=1))]
    return np.concatenate(energies), unpack_tt(x_stack, rks)


def dmrg_linsolve_scan(A: TTOperator, b: TTVector, x0: TTVector,
                       tol: float = 1e-12, degen_tol: float = 1e-10,
                       rmax: int | None = None, n_sweeps: int = 1,
                       cg_iters: int = 48):
    """Jitted rank-adaptive two-site DMRG linear solve (SPD ``A``) with
    matrix-free CG local solves; returns the solution TT with realized
    (data-carried) ranks."""
    if rmax is None:
        rmax = min(int(round(np.sqrt(float(np.prod(x0.dims))))), 64)
    x = orthogonalize(x0, 0)
    dt = jnp.result_type(A.dtype, b.dtype, x.dtype)
    A_stack = pack_op(A.astype(dt), max(A.ranks))
    b_stack = pack_tt(b.astype(dt), max(b.ranks))
    x_stack = pack_tt(x.astype(dt), rmax)
    real_dt = jnp.zeros((), dt).real.dtype
    masks = _init_masks(x, rmax, real_dt)
    tol_arr = jnp.asarray(tol, real_dt)
    dg_arr = jnp.asarray(degen_tol, real_dt)
    for _ in range(n_sweeps):
        x_stack, masks = dmrg_sweep(A_stack, b_stack, x_stack, masks,
                                    tol_arr, dg_arr, cg_iters=cg_iters)
    rks = [int(v) for v in np.asarray(jnp.sum(masks, axis=1))]
    return unpack_tt(x_stack, rks)
