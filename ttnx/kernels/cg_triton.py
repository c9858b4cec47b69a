"""Matrix-free CG for the ALS local solve as one Pallas kernel (Triton route).

One program per problem, every CG iteration inside it: the XLA form
(:func:`ttnx.solvers.als_scan._local_solve_padded`, ``solver='cg'``) runs a
``fori_loop`` of about six small operations per iteration, each its own
launch. The kernel computes the same iterates with the same masked operator

    K v[a, i, c] = sum L[a, W, b] Ac[W, i, J, w] Renv[c, w, d] v[b, J, d]

(identity on masked-out, padded directions). The operator core is folded into
the right environment once per solve, outside the kernel:

    T[i, W, J][d, c] = sum_w Ac[W, i, J, w] Renv[c, w, d]

so one apply is ``out_i = sum_W L_W @ (sum_J v_J @ T[i, W, J])``: n*RA*(n+1)
``(R, R) @ (R, R)`` dots, all in IEEE f32 (no TF32). What stays on chip is the
CG state, the 3n ``(R, R)`` tiles of x, r and p plus the apply's temporaries.
L (RA R^2 values) and T (n^2 RA R^2) are re-read from global memory on every
apply: at R=64, RA=4, n=2 they are 320 KB per problem in f32, more than the
227 KB of shared memory a block may hold, so they stream through L2.

:mod:`ttnx.kernels.dispatch` decides where this kernel runs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["cg_matfree_batched"]


def _dot(a, b):
    return jax.lax.dot(a, b, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)


def _kernel(L_ref, T_ref, rhs_ref, mask_ref, x0_ref, o_ref, *, iters: int,
            n: int, RA: int, warm: bool):
    mask = mask_ref[...]

    def apply_k(v):
        vm = [vi * mask for vi in v]
        out = []
        for i in range(n):
            acc = None
            for W in range(RA):
                m = _dot(vm[0], T_ref[i, W, 0])
                for J in range(1, n):
                    m = m + _dot(vm[J], T_ref[i, W, J])
                t = _dot(L_ref[W], m)
                acc = t if acc is None else acc + t
            out.append(acc * mask + (1.0 - mask) * v[i])
        return tuple(out)

    def pdot(a, b):
        s = jnp.sum(a[0] * b[0])
        for ai, bi in zip(a[1:], b[1:]):
            s = s + jnp.sum(ai * bi)
        return s

    rhs = tuple(rhs_ref[i] * mask for i in range(n))
    if warm:
        x = tuple(x0_ref[i] * mask for i in range(n))
        r = tuple(bi - ai for bi, ai in zip(rhs, apply_k(x)))
    else:
        x = tuple(jnp.zeros_like(bi) for bi in rhs)
        r = rhs
    rs = pdot(r, r)

    def body(_, state):
        x, r, p, rs = state
        ap = apply_k(p)
        denom = pdot(p, ap)
        ok = jnp.abs(denom) > 0.0
        alpha = jnp.where(ok, rs / jnp.where(ok, denom, 1.0), 0.0)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * api for ri, api in zip(r, ap))
        rs_new = pdot(r, r)
        okb = jnp.abs(rs) > 0.0
        beta = jnp.where(okb, rs_new / jnp.where(okb, rs, 1.0), 0.0)
        p = tuple(ri + beta * pi for ri, pi in zip(r, p))
        return x, r, p, rs_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, r, rs))
    for i in range(n):
        o_ref[i] = x[i] * mask


@functools.partial(jax.jit, static_argnames=("iters", "interpret"))
def cg_matfree_batched(L, Ac, Renv, rhs, mask, x0=None, iters: int = 16,
                       interpret: bool = False):
    """``iters`` CG iterations on B masked local systems, warm-started at
    ``x0`` when given. ``L/Renv (B, R, RA, R)``, ``rhs/x0 (B, R, n, R)``,
    shared ``Ac (RA, n, n, RA)`` and ``mask (R, n, R)``; returns
    ``x (B, R, n, R)``. Real f32 only, R a power of two >= 16."""
    B, R, RA, _ = L.shape
    n = rhs.shape[2]
    hi = jax.lax.Precision.HIGHEST
    Lw = jnp.transpose(L, (0, 2, 1, 3))                      # [B, W][a, b]
    T = jnp.einsum("WiJw,Bcwd->BiWJdc", Ac, Renv, precision=hi)
    rhs_t = jnp.transpose(rhs, (0, 2, 1, 3))                 # [B, i][a, c]
    warm = x0 is not None
    x0_t = jnp.transpose(x0, (0, 2, 1, 3)) if warm else rhs_t
    kernel = functools.partial(_kernel, iters=iters, n=n, RA=RA, warm=warm)
    per_problem = lambda *shape: pl.BlockSpec(
        (None,) + shape, lambda b: (b,) + (0,) * len(shape))
    out = pl.pallas_call(
        kernel,
        grid=(B,),
        in_specs=[
            per_problem(RA, R, R),
            per_problem(n, RA, n, R, R),
            per_problem(n, R, R),
            pl.BlockSpec((R, R), lambda b: (0, 0)),
            per_problem(n, R, R),
        ],
        out_specs=per_problem(n, R, R),
        out_shape=jax.ShapeDtypeStruct((B, n, R, R), rhs.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=4 if R <= 32 else 8,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ttnx_local_cg",
    )(Lw, T, rhs_t, mask[:, 0, :], x0_t)
    return jnp.transpose(out, (0, 2, 1, 3))
