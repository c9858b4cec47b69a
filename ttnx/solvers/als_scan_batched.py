"""Explicitly-batched scan-ALS: the B axis written into every contraction.

The same algorithm as :func:`ttnx.solvers.als_scan.als_sweeps` with a
leading batch axis spelled out in every einsum, kept as an independently
tested twin of ``jax.vmap(als_sweeps)`` (gauge-invariant parity test).

One operator, a batch of right-hand sides / states, one shared rank-mask
profile (the continuous-batching contract of ``ttnx.parallel.batch``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["als_sweeps_b"]


def _b_boundary_env(B, R, RA, dtype):
    e = jnp.zeros((B, R, RA, R), dtype=dtype)
    return e.at[:, 0, 0, 0].set(1.0)


def _b_boundary_env_b(B, R, Rb, dtype):
    e = jnp.zeros((B, R, Rb), dtype=dtype)
    return e.at[:, 0, 0].set(1.0)


def _b_local_cg(L, Ac, Renv, Lb, bc, Rb_env, m_l, m_r, cg_iters: int,
                v0=None):
    """Masked matrix-free CG on the batched local system (SPD operators):
    the Triton kernel (one program per problem,
    :mod:`ttnx.kernels.cg_triton`) where :mod:`ttnx.kernels.dispatch`
    admits the shape and backend, the XLA form elsewhere."""
    R = L.shape[1]
    n = Ac.shape[1]
    maskv3 = (m_l[:, None, None] * m_r[None, None, :]
              * jnp.ones((1, n, 1), dtype=m_l.dtype))
    rhs = jnp.einsum("Bau,Buiv,Bcv->Baic", Lb, bc, Rb_env,
                     optimize=True) * maskv3[None]
    from ttnx.kernels.dispatch import use_triton_cg

    if use_triton_cg(L.dtype, R):
        from ttnx.kernels.cg_triton import cg_matfree_batched

        return cg_matfree_batched(L, Ac, Renv, rhs, maskv3, v0,
                                  iters=cg_iters)
    return _b_cg(L, Ac, Renv, rhs, maskv3, v0, cg_iters)


def _b_cg(L, Ac, Renv, rhs, mask, v0, cg_iters: int):
    """The XLA form of the batched masked matrix-free CG: ``cg_iters``
    iterations on ``K v = rhs`` per problem, warm-started at ``v0`` when
    given. ``L/Renv (B, R, RA, R)``, ``rhs/v0 (B, R, n, R)``, shared
    ``Ac (RA, n, n, RA)`` and ``mask (R, n, R)``."""
    B = L.shape[0]
    maskv3 = mask[None]

    def apply_k(v):
        out = jnp.einsum("BaWb,WiJw,Bcwd,BbJd->Baic", L, Ac, Renv,
                         v * maskv3, optimize=True)
        return out * maskv3 + (1.0 - maskv3) * v

    def pdot(a, b):
        return jnp.sum((jnp.conj(a) * b).reshape(B, -1), axis=1)

    if v0 is None:
        x = jnp.zeros_like(rhs)
        r = rhs
    else:
        x = v0 * maskv3
        r = rhs - apply_k(x)
    p = r
    rs = pdot(r, r)

    def body(_, state):
        x, r, p, rs = state
        ap = apply_k(p)
        denom = pdot(p, ap)
        ok = jnp.abs(denom) > 0
        alpha = jnp.where(ok, rs / jnp.where(ok, denom, 1.0), 0.0)
        al = alpha[:, None, None, None]
        x = x + al * p
        r = r - al * ap
        rs_new = pdot(r, r)
        okb = jnp.abs(rs) > 0
        beta = jnp.where(okb, rs_new / jnp.where(okb, rs, 1.0), 0.0)
        p = r + beta[:, None, None, None] * p
        return (x, r, p, rs_new)

    x, _, _, _ = lax.fori_loop(0, cg_iters, body, (x, r, p, rs))
    return x


@partial(jax.jit, static_argnames=("sweep_count", "cg_iters"))
def als_sweeps_b(A_stack, b_batch, x_batch, masks, sweep_count: int = 2,
                 cg_iters: int = 32):
    """Batched ALS half-sweeps with matrix-free CG local solves.

    ``A_stack [d, RA, n, n, RA]`` shared operator; ``b_batch/x_batch
    [B, d, R, n, R]``; ``masks [d+1, R]`` shared rank profile. Returns the
    solved ``[B, d, R, n, R]`` stack. Matches ``vmap(als_sweeps(...,
    solver='cg'))`` up to QR sign gauge (the represented vectors agree to
    roundoff — tests).
    """
    Bb, d, R, n, _ = x_batch.shape
    dt = x_batch.dtype
    RA = A_stack.shape[1]
    Rb = b_batch.shape[2]

    def right_envs(x):
        init = (_b_boundary_env(Bb, R, RA, dt),
                _b_boundary_env_b(Bb, R, Rb, dt))

        def step(carry, inp):
            Renv, Rb_env = carry
            xc, Ac, bc, mr = inp
            xc = xc * mr[None, None, None, :]
            new = jnp.einsum("Baip,Wijw,Bbjq,Bpwq->BaWb", jnp.conj(xc), Ac,
                             xc, Renv, optimize=True)
            new_b = jnp.einsum("Baip,Buiv,Bpv->Bau", jnp.conj(xc), bc,
                               Rb_env, optimize=True)
            return (new, new_b), (new, new_b)

        xs = jnp.moveaxis(x, 1, 0)
        bs = jnp.moveaxis(b_batch, 1, 0)
        (_, _), (envs, envs_b) = lax.scan(
            step, init, (xs, A_stack, bs, masks[1:]), reverse=True)
        envs = jnp.concatenate([envs, init[0][None]], axis=0)
        envs_b = jnp.concatenate([envs_b, init[1][None]], axis=0)
        return envs, envs_b

    def left_envs(x):
        init = (_b_boundary_env(Bb, R, RA, dt),
                _b_boundary_env_b(Bb, R, Rb, dt))

        def step(carry, inp):
            L, Lb = carry
            xc, Ac, bc, mr = inp
            xc = xc * mr[None, None, None, :]
            L_new = jnp.einsum("Baic,BaWb,Wijw,Bbjd->Bcwd", jnp.conj(xc), L,
                               Ac, xc, optimize=True)
            Lb_new = jnp.einsum("Baip,Bau,Buiv->Bpv", jnp.conj(xc), Lb, bc,
                                optimize=True)
            return (L_new, Lb_new), (L_new, Lb_new)

        xs = jnp.moveaxis(x, 1, 0)
        bs = jnp.moveaxis(b_batch, 1, 0)
        (_, _), (envs, envs_b) = lax.scan(step, init,
                                          (xs, A_stack, bs, masks[1:]))
        envs = jnp.concatenate([init[0][None], envs], axis=0)
        envs_b = jnp.concatenate([init[1][None], envs_b], axis=0)
        return envs, envs_b

    def forward(x, Renvs, Rb_envs):
        L0 = _b_boundary_env(Bb, R, RA, dt)
        Lb0 = _b_boundary_env_b(Bb, R, Rb, dt)
        T0 = jnp.zeros((Bb, R, R), dtype=dt).at[:, 0, 0].set(1.0)
        bs = jnp.moveaxis(b_batch, 1, 0)

        def step(carry, inp):
            L, Lb, T = carry
            Ac, bc, Renv, Rb_env, m_l, m_r, xc = inp
            # warm start: the CURRENT iterate's core = T @ x_old[k]
            warm = jnp.einsum("Bab,Bbnc->Banc", T, xc)
            V = _b_local_cg(L, Ac, Renv, Lb, bc, Rb_env, m_l, m_r,
                            cg_iters, v0=warm)
            q, r = jnp.linalg.qr(V.reshape(Bb, R * n, R))
            q = q * m_r[None, None, :]
            r = r * m_r[None, :, None]
            core = q.reshape(Bb, R, n, R)
            L_new = jnp.einsum("Baic,BaWb,Wijw,Bbjd->Bcwd", jnp.conj(core),
                               L, Ac, core, optimize=True)
            Lb_new = jnp.einsum("Baip,Bau,Buiv->Bpv", jnp.conj(core), Lb, bc,
                                optimize=True)
            return (L_new, Lb_new, r), core

        xs_in = jnp.moveaxis(x, 1, 0)
        inputs = (A_stack[:-1], bs[:-1], Renvs[1:d], Rb_envs[1:d],
                  masks[:-2], masks[1:-1], xs_in[:-1])
        (L, Lb, T), new_cores = lax.scan(step, (L0, Lb0, T0), inputs)
        last = jnp.einsum("Bab,Bbnc->Banc", T, x[:, d - 1])
        return jnp.concatenate([jnp.moveaxis(new_cores, 0, 1),
                                last[:, None]], axis=1)

    def backward(x, Lenvs, Lb_envs):
        R0 = _b_boundary_env(Bb, R, RA, dt)
        Rb0 = _b_boundary_env_b(Bb, R, Rb, dt)
        T0 = jnp.zeros((Bb, R, R), dtype=dt).at[:, 0, 0].set(1.0)
        bs = jnp.moveaxis(b_batch, 1, 0)

        def step(carry, inp):
            Renv, Rb_env, T = carry
            Ac, bc, Lenv, Lb_env, m_l, m_r, xc = inp
            # warm start: the CURRENT iterate's core = x_mid[k] @ T
            warm = jnp.einsum("Banb,Bbc->Banc", xc, T)
            V = _b_local_cg(Lenv, Ac, Renv, Lb_env, bc, Rb_env, m_l, m_r,
                            cg_iters, v0=warm)
            qt, rt = jnp.linalg.qr(jnp.swapaxes(V.reshape(Bb, R, n * R),
                                                1, 2))
            q = jnp.swapaxes(qt, 1, 2).reshape(Bb, R, n, R) \
                * m_l[None, :, None, None]
            t = jnp.swapaxes(rt, 1, 2) * m_l[None, None, :]
            R_new = jnp.einsum("Baip,Wijw,Bbjq,Bpwq->BaWb", jnp.conj(q), Ac,
                               q, Renv, optimize=True)
            Rb_new = jnp.einsum("Baip,Buiv,Bpv->Bau", jnp.conj(q), bc,
                                Rb_env, optimize=True)
            return (R_new, Rb_new, t), q

        xs_in = jnp.moveaxis(x, 1, 0)
        inputs = (A_stack[1:], bs[1:], Lenvs[1:d], Lb_envs[1:d],
                  masks[1:-1], masks[2:], xs_in[1:])
        (Renv, Rb_env, T), new_cores = lax.scan(step, (R0, Rb0, T0), inputs,
                                                reverse=True)
        first = jnp.einsum("Banb,Bbc->Banc", x[:, 0], T)
        return jnp.concatenate([first[:, None],
                                jnp.moveaxis(new_cores, 0, 1)], axis=1)

    x = x_batch
    half = 0
    while half < sweep_count:
        Renvs, Rb_envs = right_envs(x)
        x = forward(x, Renvs, Rb_envs)
        half += 1
        if half >= sweep_count:
            break
        Lenvs, Lb_envs = left_envs(x)
        x = backward(x, Lenvs, Lb_envs)
        half += 1
    return x
