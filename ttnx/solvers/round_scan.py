"""Jitted padded-rank MPO application + TT rounding — the fused
"contraction + rounding" pipeline of the north star, plus a fully-jitted
Crank–Nicolson heat step built from it.

All shapes static: the MPO application blows the padded rank up to
``RA * R`` in one batched einsum, and the rounding scan truncates back to a
fixed target ``R_out``. Together with :func:`ttnx.solvers.als_scan.als_sweeps`
this makes one time step of the d=12 heat equation (BASELINE config 2) a
single compiled XLA program.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ttnx.core.tt import r_and_d_to_rks
from ttnx.solvers.als_scan import als_sweeps, rank_masks

__all__ = ["matvec_padded", "tt_round_scan", "tt_round_gram", "cn_step",
           "make_cn_step", "make_cn_evolve"]


def matvec_padded(A_stack, x_stack):
    """Padded MPO·MPS: ``y[d, RA*R, n, RA*R]`` from ``A[d, RA, n, n, RA]`` and
    ``x[d, R, n, R]`` — one batched einsum over the site axis (the reference's
    hot kernel, /root/reference/src/tt_operations.jl:101-111)."""
    d, RA, n, _, _ = A_stack.shape
    R = x_stack.shape[1]
    y = jnp.einsum("kaijb,kcjd->kacibd", A_stack, x_stack, optimize=True)
    return y.reshape(d, RA * R, n, RA * R)


def _right_orth_scan(y, masks_r, method: str = "qr"):
    """Right-orthogonalize the padded chain (masked LQ sweep); returns new
    stack with site 0 holding the center.

    ``method='qr'`` uses Householder QR of the transposed site matrix;
    ``method='gram'`` factors the site as ``cm = G^{1/2} (G^{-1/2} cm)``
    with ``G = cm cm^H`` via a single eigh — matmul-dominated instead of
    Householder panels. The pseudo-inverted square root handles
    rank-deficient sites exactly (deficient directions carry no mass, their
    rows come out zero), which
    both the padded-zero invariant and the low-true-rank boundary bonds
    of an MPO-apply chain require. Precision: directions below
    ``sqrt(eps)*sigma_max`` lose relative accuracy (squared condition
    number) — fine for the f32 device path; the f64 parity path keeps
    ``method='qr'``."""
    d, R, n, _ = y.shape

    def gram_lq(cm):
        """cm (R, nR) = T @ q; q has orthonormal rows on the row space of
        cm and zero rows in its null space; T = (cm cm^H)^{1/2} (PSD)."""
        G = cm @ cm.conj().T
        w, V = jnp.linalg.eigh(G)                      # ascending
        s = jnp.sqrt(jnp.maximum(w.real, 0.0))
        cutoff = jnp.finfo(s.dtype).eps * R * jnp.max(s)
        keep = s > cutoff
        s_inv = jnp.where(keep, 1.0 / jnp.where(keep, s, 1.0), 0.0)
        s_kept = jnp.where(keep, s, 0.0)
        proj = V.conj().T @ cm                         # (R, nR)
        q = (V * s_inv[None, :].astype(V.dtype)) @ proj
        T = (V * s_kept[None, :].astype(V.dtype)) @ V.conj().T
        return q, T

    def step(carry, inp):
        T, = carry
        core, m_l = inp
        c = jnp.einsum("anb,bc->anc", core, T)
        if method == "gram":
            q2, t2 = gram_lq(c.reshape(R, n * R))
            q = q2.reshape(R, n, R) * m_l[:, None, None]
            t = t2 * m_l[None, :]
        else:
            qt, rt = jnp.linalg.qr(c.reshape(R, n * R).T)
            q = qt.T.reshape(R, n, R) * m_l[:, None, None]
            t = rt.T * m_l[None, :]
        return (t,), q

    T0 = jnp.zeros((R, R), dtype=y.dtype).at[0, 0].set(1.0)
    # process sites d-1 .. 1; site 0 absorbs the final transfer
    (T,), cores = lax.scan(step, (T0,), (y[1:], masks_r[:-1][1:d]),
                           reverse=True)
    first = jnp.einsum("anb,bc->anc", y[0], T)
    return jnp.concatenate([first[None], cores], axis=0)


def tt_round_scan(y, masks_y, R_out: int, masks_out, method: str = "svd"):
    """Truncate a padded chain to buffer rank ``R_out``: right-orthogonalize,
    then a left-to-right masked truncation scan keeping the top ``R_out``
    singular directions per bond (jitted analog of
    :func:`ttnx.core.canonical.tt_round`).

    ``masks_y [d+1, R]`` bounds the input ranks; ``masks_out [d+1, R_out]``
    the (feasibility-clamped) output ranks. ``method='svd'`` (default,
    full-precision) truncates via the site SVD; ``method='gram'`` is the
    matmul-dominated form — Gram-eigh orthogonalization plus an eigh
    of the tiny ``(R_out*n, R_out*n)`` Gram matrix per site (top-k
    eigenvectors = left singular vectors). The Gram form halves the
    attainable precision for directions below ``sqrt(eps)*sigma_max``
    (squared condition number) but keeps every dominant direction exact —
    the trade the f32 device programs make."""
    d, R, n, _ = y.shape
    y = _right_orth_scan(y, masks_y, method=method)
    k = min(R_out, R)

    def step(carry, inp):
        T, = carry  # (R_out, R) transfer into this site
        core, m_r_out = inp
        c = jnp.einsum("ab,bnc->anc", T, core)        # (R_out, n, R)
        cm = c.reshape(R_out * n, R)
        if method == "gram":
            G = cm @ cm.conj().T                      # (R_out*n, R_out*n)
            w, V = jnp.linalg.eigh(G)                 # ascending
            u_k = V[:, ::-1][:, :k]
            t_k = u_k.conj().T @ cm                   # rows scale like s*vt
        elif R_out * n < R:
            # wide site matrix: factor the tall transpose, which is the same
            # factorization: cm = vt2.T @ diag(s) @ ut.T
            ut, s, vt2 = jnp.linalg.svd(cm.T, full_matrices=False)
            u_k = vt2.T[:, :k]
            t_k = s[:k, None] * ut.T[:k, :]
        else:
            u, s, vt = jnp.linalg.svd(cm, full_matrices=False)
            u_k = u[:, :k]
            t_k = s[:k, None] * vt[:k, :]
        u_k = u_k * m_r_out[None, :k]
        pad = jnp.zeros((R_out * n, R_out - k), dtype=cm.dtype)
        new_core = jnp.concatenate([u_k, pad], axis=1).reshape(
            R_out, n, R_out)
        t_k = t_k * m_r_out[:k, None]
        T_new = jnp.concatenate(
            [t_k, jnp.zeros((R_out - k, R), dtype=cm.dtype)], axis=0)
        return (T_new,), new_core

    T0 = jnp.zeros((R_out, R), dtype=y.dtype).at[0, 0].set(1.0)
    (T,), cores = lax.scan(step, (T0,), (y[:-1], masks_out[1:d]))
    # last site absorbs the remaining transfer; pad its right rank to R_out
    last = jnp.einsum("ab,bnc->anc", T, y[d - 1])      # (R_out, n, R)
    last = last[:, :, :1]                              # boundary rank is 1
    last = jnp.pad(last, ((0, 0), (0, 0), (0, R_out - 1)))
    return jnp.concatenate([cores, last[None]], axis=0)


def _gram_chain_xla(y):
    """Right Gram matrices of a padded chain: a backward ``lax.scan`` of the
    pure-matmul recurrence ``G_k = sum_i y_k[:, i, :] G_{k+1} y_k[:, i, :]^H``
    with ``G_d = e_0 e_0^T``. Returns ``Gs (d, R, R)`` with
    ``Gs[k] = G_{k+1}``."""
    d, R, n, _ = y.shape
    G0 = jnp.zeros((R, R), y.dtype).at[0, 0].set(1.0)

    def step(G, yk):
        Gn = jnp.einsum("aib,bc,xic->ax", yk, G, jnp.conj(yk), optimize=True)
        return Gn, G  # emit the PRE-update Gram (the bond right of this site)

    G1, Gs_tail = lax.scan(step, G0, y[1:], reverse=True)
    return jnp.concatenate([G1[None], Gs_tail], axis=0)  # Gs[k] = G_{k+1}


def tt_round_gram(y, R_out: int, masks_out):
    """Gram-chain rounding.

    Orthogonalization-free truncation: a backward pure-matmul sweep computes
    the right Gram matrices ``G_k`` of the (unorthogonalized) chain
    (:func:`_gram_chain_xla`), then a single left-to-right sweep truncates
    each bond with one small
    eigh: at site k, ``B = c G_{k+1} c^H`` is the exact Gram of the remaining
    matricization (the left basis carried in ``T`` is orthonormal), so the
    top ``R_out`` eigenvectors of ``B`` ARE the optimal left singular
    vectors. Equivalent to orthogonalize-then-truncate in exact arithmetic;
    numerically it squares the condition number for directions below
    ``sqrt(eps)*sigma_max`` — the same trade the existing ``method='gram'``
    path makes, accepted for the f32 device pipeline (f64 parity uses
    ``tt_round_scan(method='svd')``). Versus ``tt_round_scan('gram')`` this
    halves the eigh count (d instead of 2d) and needs no
    right-orthogonalization scan.

    Reference semantics: /root/reference/src/tt_tools.jl:743-789.
    """
    d, R, n, _ = y.shape
    if R_out > R:
        raise ValueError(f"R_out={R_out} must be <= padded rank {R}")
    Gs = _gram_chain_xla(y)

    def step(T, inp):
        yk, G, m_r_out = inp
        c = jnp.einsum("ab,bnc->anc", T, yk)          # (R_out, n, R)
        cm = c.reshape(R_out * n, R)
        B = jnp.einsum("ab,bc,xc->ax", cm, G, jnp.conj(cm), optimize=True)
        B = 0.5 * (B + B.conj().T)
        w, V = jnp.linalg.eigh(B)                     # ascending
        u_k = V[:, ::-1][:, :R_out] * m_r_out[None, :]
        T_new = (u_k.conj().T @ cm) * m_r_out[:, None]
        return T_new, u_k.reshape(R_out, n, R_out)

    T0 = jnp.zeros((R_out, R), dtype=y.dtype).at[0, 0].set(1.0)
    T, cores = lax.scan(step, T0, (y[:-1], Gs[: d - 1], masks_out[1:d]))
    last = jnp.einsum("ab,bnc->anc", T, y[d - 1])     # (R_out, n, R)
    last = last[:, :, :1]                             # boundary rank is 1
    last = jnp.pad(last, ((0, 0), (0, 0), (0, R_out - 1)))
    return jnp.concatenate([cores, last[None]], axis=0)


def round_masks(in_rks, R_out: int, dims):
    """Output rank vector for rounding to cap ``R_out`` (host-side)."""
    rks = [min(r, R_out) for r in in_rks]
    return r_and_d_to_rks(rks, dims, rmax=R_out)


@partial(jax.jit, static_argnames=("sweep_count", "solver", "orth",
                                   "round_rhs", "round_method", "precision",
                                   "cg_iters"))
def cn_step(lhs_stack, rhs_stack, u_stack, guess_noise, masks_u,
            masks_rhs_big, masks_u_out, sweep_count: int = 4,
            solver: str = "lu", orth: str = "qr", round_rhs: bool = True,
            round_method: str = "svd", precision: str | None = None,
            cg_iters: int = 48):
    """One Crank–Nicolson step as a single compiled program:
    ``u <- ALS-solve(lhs, round(rhs_op @ u))`` (reference stepper:
    /root/reference/src/solvers/euler.jl:145-191).

    ``guess_noise`` (masked, ~1e-3 of the state scale) is added to the ALS
    *guess only*: a rank-deficient state makes the ALS environments singular
    and locks the rank; the converged ALS solution is guess-independent, so
    the noise never reaches the output while the RHS stays exact.

    ``precision`` ('highest'|'float32'|None) pins the matmul precision for
    every contraction in the step. A GPU may run default-precision f32
    dots in TF32 (about three decimal digits); 'highest' keeps them IEEE
    f32.
    """
    from contextlib import nullcontext

    ctx = (jax.default_matmul_precision(precision) if precision
           else nullcontext())
    with ctx:
        R_out = u_stack.shape[1]
        big = matvec_padded(rhs_stack, u_stack)
        if not round_rhs:
            # keep the rhs at the applied (Kronecker) rank: larger b
            # environments but zero dense-linalg primitives in the whole
            # program when combined with solver='cg' and orth='polar'
            b = big
        elif round_method == "gram_chain":
            b = tt_round_gram(big, R_out, masks_u_out)
        else:
            b = tt_round_scan(big, masks_rhs_big, R_out, masks_u_out,
                              method=round_method)
        guess = u_stack + guess_noise
        return als_sweeps(lhs_stack, b, guess, masks_u, sweep_count,
                          solver=solver, orth=orth, cg_iters=cg_iters)


def make_cn_step(A, h: float, rmax: int, dims, u_rks, dtype=jnp.float64,
                 sweep_count: int = 4, solver: str = "lu", orth: str = "qr",
                 round_rhs: bool = True, round_method: str = "svd",
                 precision: str | None = None, cg_iters: int = 48):
    """Host-side setup for :func:`cn_step` on ``du/dt = A u``: packs
    ``I -/+ h/2 A`` and builds all masks. Returns ``(step_fn, pack, unpack)``.
    """
    from ttnx.core.algebra import add_op, scale_op
    from ttnx.core.tt import id_tto
    from ttnx.solvers.als_scan import pack_op, pack_tt, unpack_tt

    if round_method not in ("svd", "gram", "gram_chain"):
        raise ValueError("round_method must be 'svd', 'gram' or "
                         f"'gram_chain', got {round_method!r}")
    if solver not in ("lu", "cg", "bicgstab"):
        raise ValueError(
            f"solver must be 'lu', 'cg' or 'bicgstab', got {solver!r}")
    if orth not in ("qr", "polar"):
        raise ValueError(f"orth must be 'qr' or 'polar', got {orth!r}")
    d = len(dims)
    A = A.astype(dtype)
    eye = id_tto(d, dtype=dtype)
    lhs = add_op(eye, scale_op(-h / 2, A))
    rhs = add_op(eye, scale_op(h / 2, A))
    RA = max(rhs.ranks)
    lhs_stack = pack_op(lhs, max(lhs.ranks))
    rhs_stack = pack_op(rhs, RA)

    u_rks = r_and_d_to_rks(u_rks, dims, rmax=rmax)
    real_dt = jnp.zeros((), dtype).real.dtype
    masks_u = rank_masks(u_rks, rmax, dtype=real_dt)
    # the applied chain's active positions are the Kronecker pattern
    # {a*R + c : a < rA, c < rx} — a SCATTERED set, not a prefix, so its
    # masks are outer products of the factor masks
    masks_A = np.zeros((d + 1, RA))
    for i, r in enumerate(rhs.ranks):
        masks_A[i, :r] = 1.0
    masks_u_np = np.asarray(masks_u)
    masks_big = jnp.asarray(np.stack(
        [np.outer(masks_A[i], masks_u_np[i]).reshape(-1)
         for i in range(d + 1)]), dtype=real_dt)
    big_rks = [min(a * b, RA * rmax) for a, b in zip(rhs.ranks, u_rks)]
    out_rks = round_masks(big_rks, rmax, dims)
    masks_out = rank_masks(out_rks, rmax, dtype=real_dt)

    # masked guess-noise stack (zero outside the u_rks rank profile)
    rng = np.random.default_rng(0)
    noise_np = np.zeros((d, rmax, 2, rmax))
    for i in range(d):
        noise_np[i, : u_rks[i], :, : u_rks[i + 1]] = 1e-3 * rng.standard_normal(
            (u_rks[i], 2, u_rks[i + 1]))
    guess_noise = jnp.asarray(noise_np, dtype=dtype)

    def step_fn(u_stack):
        return cn_step(lhs_stack, rhs_stack, u_stack, guess_noise, masks_u,
                       masks_big, masks_out, sweep_count, solver, orth,
                       round_rhs, round_method, precision, cg_iters)

    def pack(u):
        from ttnx.core.canonical import tt_round

        if max(u.ranks) > rmax:  # avoid eager SVD sweeps when already feasible
            u = tt_round(u, max_bond=rmax)
        return pack_tt(u.astype(dtype), rmax)

    unpack = lambda s: unpack_tt(s, u_rks)
    return step_fn, pack, unpack


def make_cn_evolve(A, h: float, rmax: int, dims, u_rks, n_steps: int,
                   **kwargs):
    """Whole-trajectory Crank–Nicolson as ONE compiled program:
    ``lax.fori_loop`` over :func:`cn_step`, so ``n_steps`` of time evolution
    cost a single dispatch with no host round trip between steps.

    Returns ``(evolve_fn, pack, unpack)`` with ``evolve_fn(u_stack) ->
    u_stack after n_steps``."""
    step_fn, pack, unpack = make_cn_step(A, h, rmax, dims, u_rks, **kwargs)

    @jax.jit
    def evolve_fn(u_stack):
        return lax.fori_loop(0, n_steps, lambda i, u: step_fn(u), u_stack)

    return evolve_fn, pack, unpack
