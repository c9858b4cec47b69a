"""TT algebra: add/scale/dot/norm, MPO·MPS, MPO·MPO, Hadamard, Kronecker.

Every contraction is a single einsum per site (one ``dot_general``),
replacing the reference's ``@tensoropt`` kernels
(/root/reference/src/tt_operations.jl). Rank bookkeeping is static (shapes).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ttnx.core.tt import TTOperator, TTVector, zeros_tt, zeros_tto

__all__ = [
    "add",
    "sub",
    "add_op",
    "sub_op",
    "scale",
    "scale_op",
    "matvec",
    "matmul",
    "inner_core_product",
    "outer_product",
    "dot",
    "norm",
    "hadamard",
    "hadamard_ttm",
    "kron_tt",
    "kron_tto",
    "ttv_to_diag_tto",
    "linear_combination",
    "euclidean_distance",
    "euclidean_distance_normalized",
]


def _result_dtype(*xs):
    return jnp.result_type(*[x.dtype for x in xs])


# ---------------------------------------------------------------------------
# Addition (block-diagonal core concatenation)
# ---------------------------------------------------------------------------


def add(x: TTVector, y: TTVector) -> TTVector:
    """``x + y`` by block-diagonal core concatenation; result ranks are the sum
    of the input ranks (/root/reference/src/tt_operations.jl:10-35)."""
    if x.dims != y.dims:
        raise ValueError("Incompatible dimensions")
    d = x.N
    dt = _result_dtype(x, y)
    if d == 1:
        return TTVector([x.cores[0].astype(dt) + y.cores[0].astype(dt)])
    xr, yr = x.ranks, y.ranks
    cores = []
    for k in range(d):
        n = x.dims[k]
        if k == 0:
            c = jnp.concatenate(
                [x.cores[0].astype(dt), y.cores[0].astype(dt)], axis=2)
        elif k == d - 1:
            c = jnp.concatenate(
                [x.cores[k].astype(dt), y.cores[k].astype(dt)], axis=0)
        else:
            rl, rr = xr[k] + yr[k], xr[k + 1] + yr[k + 1]
            c = jnp.zeros((rl, n, rr), dtype=dt)
            c = c.at[: xr[k], :, : xr[k + 1]].set(x.cores[k].astype(dt))
            c = c.at[xr[k]:, :, xr[k + 1]:].set(y.cores[k].astype(dt))
        cores.append(c)
    return TTVector(cores)


def add_op(x: TTOperator, y: TTOperator) -> TTOperator:
    """MPO addition (/root/reference/src/tt_operations.jl:71-96)."""
    if x.dims != y.dims or x.in_dims != y.in_dims:
        raise ValueError("Incompatible dimensions")
    d = x.N
    dt = _result_dtype(x, y)
    if d == 1:
        return TTOperator([x.cores[0].astype(dt) + y.cores[0].astype(dt)])
    xr, yr = x.ranks, y.ranks
    cores = []
    for k in range(d):
        if k == 0:
            c = jnp.concatenate(
                [x.cores[0].astype(dt), y.cores[0].astype(dt)], axis=3)
        elif k == d - 1:
            c = jnp.concatenate(
                [x.cores[k].astype(dt), y.cores[k].astype(dt)], axis=0)
        else:
            no, ni = x.out_dims[k], x.in_dims[k]
            rl, rr = xr[k] + yr[k], xr[k + 1] + yr[k + 1]
            c = jnp.zeros((rl, no, ni, rr), dtype=dt)
            c = c.at[: xr[k], :, :, : xr[k + 1]].set(x.cores[k].astype(dt))
            c = c.at[xr[k]:, :, :, xr[k + 1]:].set(y.cores[k].astype(dt))
        cores.append(c)
    return TTOperator(cores)


def scale(a, x: TTVector) -> TTVector:
    """Scalar times TT vector: scale the orthogonality-center core
    (/root/reference/src/tt_operations.jl:256-266)."""
    # weak-type the scalar: 0.5 * f32-TT must stay f32 under x64
    dt = jnp.result_type(x.dtype, a)
    if isinstance(a, (int, float, complex)) and a == 0:
        return zeros_tt(x.dims, x.ranks, dtype=dt)
    i = x.ot.index(0) if 0 in x.ot else 0
    cores = [c.astype(dt) for c in x.cores]
    cores[i] = cores[i] * a
    return TTVector(cores, x.ot)


def scale_op(a, x: TTOperator) -> TTOperator:
    dt = jnp.result_type(x.dtype, a)
    if isinstance(a, (int, float, complex)) and a == 0:
        return zeros_tto(x.dims, x.ranks, dtype=dt)
    i = x.ot.index(0) if 0 in x.ot else 0
    cores = [c.astype(dt) for c in x.cores]
    cores[i] = cores[i] * a
    return TTOperator(cores, x.ot)


def sub(x: TTVector, y: TTVector) -> TTVector:
    return add(x, scale(-1.0, y))


def sub_op(x: TTOperator, y: TTOperator) -> TTOperator:
    return add_op(x, scale_op(-1.0, y))


def linear_combination(tts, coeffs) -> TTVector:
    """``sum_i coeffs[i] * tts[i]`` (/root/reference/src/tt_operations.jl:228-234)."""
    out = scale(coeffs[0], tts[0])
    for c, t in zip(coeffs[1:], tts[1:]):
        out = add(out, scale(c, t))
    return out


# ---------------------------------------------------------------------------
# Contractions
# ---------------------------------------------------------------------------


def matvec(A: TTOperator, v: TTVector) -> TTVector:
    """MPO·MPS with multiplicative ranks and no compression — the hot kernel
    (/root/reference/src/tt_operations.jl:101-111). Rectangular operators with
    one extra singleton-input site (prolongations) are dispatched automatically
    (reference lines 116-148)."""
    if A.N == v.N + 1:
        return _matvec_rectangular(A, v)
    if A.in_dims != v.dims:
        raise ValueError("Incompatible dimensions")
    dt = _result_dtype(A, v)
    cores = []
    for k in range(v.N):
        w = A.cores[k].astype(dt)
        x = v.cores[k].astype(dt)
        ra, n, _, rb = w.shape
        rc, _, rd = x.shape
        y = jnp.einsum("aijb,cjd->acibd", w, x)
        cores.append(y.reshape(ra * rc, n, rb * rd))
    return TTVector(cores)


def _matvec_rectangular(A: TTOperator, v: TTVector) -> TTVector:
    singleton = [k for k in range(A.N) if A.in_dims[k] == 1]
    if len(singleton) != 1:
        raise ValueError(
            "Rectangular TToperator must have exactly one singleton input site")
    s = singleton[0]
    exp_in = tuple(A.in_dims[k] for k in range(A.N) if k != s)
    if exp_in != v.dims:
        raise ValueError("Incompatible input dimensions")
    if v.ranks[-1] != 1:
        raise ValueError("Input TTvector must have a closed right boundary rank")
    dt = _result_dtype(A, v)
    cores = []
    for k in range(A.N):
        w = A.cores[k].astype(dt)
        if k == s:
            consumed = k  # number of vector sites consumed before this site
            nu = v.ranks[consumed]
            eye = jnp.eye(nu, dtype=dt)
            y = jnp.einsum("aib,vw->avibw", w[:, :, 0, :], eye)
            ra, rb = w.shape[0], w.shape[3]
            cores.append(y.reshape(ra * nu, w.shape[1], rb * nu))
        else:
            ks = k if k < s else k - 1
            x = v.cores[ks].astype(dt)
            ra, n, _, rb = w.shape
            rc, _, rd = x.shape
            y = jnp.einsum("aijb,cjd->acibd", w, x)
            cores.append(y.reshape(ra * rc, n, rb * rd))
    return TTVector(cores)


def matmul(A: TTOperator, B: TTOperator) -> TTOperator:
    """MPO·MPO, ranks multiply (/root/reference/src/tt_operations.jl:162-173)."""
    if A.in_dims != B.out_dims:
        raise ValueError("Incompatible dimensions")
    dt = _result_dtype(A, B)
    cores = []
    for k in range(A.N):
        a = A.cores[k].astype(dt)
        b = B.cores[k].astype(dt)
        ra, no, _, rb = a.shape
        rc, _, ni, rd = b.shape
        y = jnp.einsum("aizb,czjd->acijbd", a, b)
        cores.append(y.reshape(ra * rc, no, ni, rb * rd))
    return TTOperator(cores)


def inner_core_product(A: TTOperator, B: TTOperator) -> TTOperator:
    """Sitewise Kronecker of physical and bond axes — the QTT `⋈` product
    (/root/reference/src/tt_operations.jl:198-216). A-major index ordering on
    every merged axis."""
    if A.N != B.N:
        raise ValueError("Inner core product requires equal site counts")
    dt = _result_dtype(A, B)
    cores = []
    for k in range(A.N):
        a = A.cores[k].astype(dt)
        b = B.cores[k].astype(dt)
        ra, nAo, nAi, rb = a.shape
        rc, nBo, nBi, rd = b.shape
        y = jnp.einsum("aijb,ckld->acikjlbd", a, b)
        cores.append(y.reshape(ra * rc, nAo * nBo, nAi * nBi, rb * rd))
    return TTOperator(cores)


def outer_product(x: TTVector, y: TTVector) -> TTOperator:
    """``|x><y|`` as an MPO, ranks multiply
    (/root/reference/src/tt_operations.jl:297-304)."""
    dt = _result_dtype(x, y)
    cores = []
    for k in range(x.N):
        a = x.cores[k].astype(dt)
        b = jnp.conj(y.cores[k].astype(dt))
        ra, n, rb = a.shape
        rc, m, rd = b.shape
        z = jnp.einsum("aib,cjd->acijbd", a, b)
        cores.append(z.reshape(ra * rc, n, m, rb * rd))
    return TTOperator(cores)


def ttv_to_diag_tto(x: TTVector) -> TTOperator:
    """Lift a TT vector to the diagonal MPO ``diag(x)``
    (/root/reference/src/tt_operations.jl:310-338)."""
    cores = []
    for c in x.cores:
        n = c.shape[1]
        eye = jnp.eye(n, dtype=c.dtype)
        cores.append(jnp.einsum("aib,ij->aijb", c, eye))
    return TTOperator(cores)


# ---------------------------------------------------------------------------
# Inner products and norms
# ---------------------------------------------------------------------------


def dot(a: TTVector, b: TTVector):
    """``<a, b>`` via left-to-right transfer matrices, conjugating ``a``
    (/root/reference/src/tt_operations.jl:239-250)."""
    if a.dims != b.dims:
        raise ValueError("TT dimensions are not compatible")
    dt = _result_dtype(a, b)
    env = jnp.ones((1, 1), dtype=dt)
    for k in range(a.N):
        ac = jnp.conj(a.cores[k].astype(dt))
        bc = b.cores[k].astype(dt)
        tmp = jnp.einsum("ac,cid->aid", env, bc)
        env = jnp.einsum("aib,aid->bd", ac, tmp)
    return env[0, 0]


def norm(a: TTVector):
    """``sqrt(max(Re <a,a>, 0))`` (/root/reference/src/tt_operations.jl:465-470)."""
    v = jnp.real(dot(a, a))
    return jnp.sqrt(jnp.maximum(v, 0.0))


def euclidean_distance(a: TTVector, b: TTVector):
    """(/root/reference/src/tt_operations.jl:452-455)"""
    v = jnp.real(dot(a, a)) - 2.0 * jnp.real(dot(b, a)) + jnp.real(dot(b, b))
    return jnp.sqrt(jnp.maximum(v, 0.0))


def euclidean_distance_normalized(a: TTVector, b: TTVector):
    """(/root/reference/src/tt_operations.jl:457-460)"""
    bb = dot(b, b)
    v = 1.0 + jnp.real(dot(a, a) / bb) - 2.0 * jnp.real(dot(b, a) / bb)
    return jnp.sqrt(jnp.maximum(v, 0.0))


# ---------------------------------------------------------------------------
# Hadamard and Kronecker products
# ---------------------------------------------------------------------------


def hadamard(x: TTVector, y: TTVector) -> TTVector:
    """Elementwise product; per-physical-index Kronecker of bond matrices,
    ranks multiply (/root/reference/src/tt_operations.jl:343-361)."""
    if x.dims != y.dims:
        raise ValueError("Incompatible TT dimensions")
    dt = _result_dtype(x, y)
    cores = []
    for k in range(x.N):
        a = x.cores[k].astype(dt)
        b = y.cores[k].astype(dt)
        ra, n, rb = a.shape
        rc, _, rd = b.shape
        y_k = jnp.einsum("aib,cid->acibd", a, b)
        cores.append(y_k.reshape(ra * rc, n, rb * rd))
    return TTVector(cores)


def _ttm_swap(cores, j, tol, rmax):
    """Swap-SVD at bond j for the TTM zip-up
    (/root/reference/src/tt_operations.jl:366-383)."""
    from ttnx.core.canonical import svdtrunc

    a, b = cores[j], cores[j + 1]
    rl, da, _ = a.shape
    _, db, rr = b.shape
    m = jnp.einsum("lam,mbr->lbar", a, b).reshape(rl * db, da * rr)
    u, s, vt = svdtrunc(m, max_bond=None if rmax is None else rmax, truncerr=tol)
    r = s.shape[0]
    cores[j] = u.reshape(rl, db, r)
    cores[j + 1] = (s[:, None] * vt).reshape(r, da, rr)


def _ttm_contract(cores, p):
    """Elementwise contraction of two same-physical-dim cores
    (/root/reference/src/tt_operations.jl:385-397)."""
    a, b = cores[p], cores[p + 1]
    cores[p] = jnp.einsum("lsm,msr->lsr", a, b)
    del cores[p + 1]


def hadamard_ttm(x: TTVector, y: TTVector, tol: float = 1e-14,
                 rmax: int | None = None) -> TTVector:
    """Rank-controlled Hadamard product via the TTM zip-up (arXiv:2410.19747
    Eq. 10; /root/reference/src/tt_operations.jl:399-422): append the reversed
    ``y`` chain, then repeatedly swap-SVD and contract."""
    if x.dims != y.dims:
        raise ValueError("Incompatible TT dimensions")
    d = x.N
    dt = _result_dtype(x, y)
    cores = [c.astype(dt) for c in x.cores]
    for k in range(d):
        cores.append(jnp.swapaxes(y.cores[d - 1 - k].astype(dt), 0, 2))
    for it in range(1, d + 1):
        for j in range(d - 1, d - it, -1):
            _ttm_swap(cores, j, tol, rmax)
        _ttm_contract(cores, d - it)
    return TTVector(cores)


def kron_tt(a: TTVector, b: TTVector) -> TTVector:
    """Kronecker product over disjoint sites = chain concatenation
    (/root/reference/src/tt_operations.jl:440-448)."""
    dt = _result_dtype(a, b)
    return TTVector([c.astype(dt) for c in a.cores + b.cores], a.ot + b.ot)


def kron_tto(A: TTOperator, B: TTOperator) -> TTOperator:
    """(/root/reference/src/tt_operations.jl:427-433)"""
    dt = _result_dtype(A, B)
    return TTOperator([c.astype(dt) for c in A.cores + B.cores], A.ot + B.ot)
