"""Canonical forms: orthogonalization, entropy, SVD truncation, compression.

All functional (return new ``TTVector``s). QR/LQ sweeps are single
reshape+``jnp.linalg.qr`` calls per site — the XLA-native formulation of the
reference's sweeps (/root/reference/src/tt_tools.jl:511-543).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ttnx.core.tt import TTVector

__all__ = [
    "orthogonalize",
    "entanglement_entropy",
    "svdtrunc",
    "tt_compress",
    "tt_round",
]


def _left_orth_step(core, nxt):
    """Left-orthogonalize ``core``; absorb the triangular factor into ``nxt``."""
    rl, n, rr = core.shape
    q, r = jnp.linalg.qr(core.reshape(rl * n, rr))
    return q.reshape(rl, n, -1), jnp.einsum("ab,bnc->anc", r, nxt)


def _right_orth_step(prev, core):
    """Right-orthogonalize ``core``; absorb the triangular factor into ``prev``."""
    rl, n, rr = core.shape
    qt, rt = jnp.linalg.qr(core.reshape(rl, n * rr).T)
    new_core = qt.T.reshape(-1, n, rr)
    return jnp.einsum("anb,bc->anc", prev, rt.T), new_core


def orthogonalize(x: TTVector, i: int = 0) -> TTVector:
    """Bring ``x`` into mixed-canonical form with the center at site ``i``.

    Sites ``< i`` become left-orthogonal (ot=+1), sites ``> i`` right-orthogonal
    (ot=-1); the center absorbs both triangular factors
    (/root/reference/src/tt_tools.jl:511-543).
    """
    d = x.N
    if not 0 <= i < d:
        raise ValueError("orthogonalization center out of range")
    cores = list(x.cores)
    for j in range(i):
        cores[j], cores[j + 1] = _left_orth_step(cores[j], cores[j + 1])
    for j in range(d - 1, i, -1):
        cores[j - 1], cores[j] = _right_orth_step(cores[j - 1], cores[j])
    ot = [1] * i + [0] + [-1] * (d - 1 - i)
    return TTVector(cores, ot)


def entanglement_entropy(psi: TTVector, base: float = math.e) -> np.ndarray:
    """Von Neumann entanglement entropy at every bond
    (/root/reference/src/tt_tools.jl:554-587).

    Entry ``k`` is the entropy of the bipartition ``0:k+1 | k+1:N``. Returns a
    host numpy vector of length ``N - 1``.
    """
    if base <= 0 or base == 1:
        raise ValueError("base must be positive and not equal to 1")
    n_sites = psi.N
    out = np.zeros(max(n_sites - 1, 0))
    if n_sites <= 1:
        return out
    logscale = math.log(base)
    y = orthogonalize(psi, 0)
    cores = list(y.cores)
    for k in range(n_sites - 1):
        rl, n, rr = cores[k].shape
        u, s, vt = jnp.linalg.svd(cores[k].reshape(rl * n, rr), full_matrices=False)
        p = np.asarray(jnp.abs(s) ** 2)
        tot = p.sum()
        if tot > 0:
            p = p / tot
            nz = p[p > 0]
            out[k] = float(-(nz * np.log(nz)).sum() / logscale)
        if k < n_sites - 2:
            transfer = s[:, None] * vt
            cores[k + 1] = jnp.einsum("ab,bnc->anc", transfer, cores[k + 1])
    return out


# alias matching the reference export name
entanglemententropy = entanglement_entropy


def svdtrunc(a, max_bond: int | None = None, truncerr: float = 0.0):
    """Truncated SVD with the reference's absolute-threshold criterion
    (/root/reference/src/tt_tools.jl:737-741): keep
    ``min(max_bond, #{s_i >= truncerr})`` singular values (at least one).

    Returns ``(U, s, Vt)`` with ``s`` a vector. Rank selection happens on host,
    so call outside jit (solvers use masked fixed-width variants instead).
    """
    u, s, vt = jnp.linalg.svd(a, full_matrices=False)
    s_host = np.asarray(s)
    keep = int(np.sum(s_host >= truncerr)) if truncerr > 0 else s_host.size
    if max_bond is not None:
        keep = min(keep, max_bond)
    keep = max(keep, 1)
    return u[:, :keep], s[:keep], vt[:keep, :]


def _bond_truncate(cores, k, max_bond, truncerr):
    """Two-site merge -> truncated SVD -> sqrt-balanced split at bond k
    (/root/reference/src/tt_tools.jl:743-770)."""
    a, b = cores[k], cores[k + 1]
    rl, n1, _ = a.shape
    _, n2, rr = b.shape
    merged = jnp.einsum("anb,bmc->anmc", a, b).reshape(rl * n1, n2 * rr)
    u, s, vt = svdtrunc(merged, max_bond=max_bond, truncerr=truncerr)
    sq = jnp.sqrt(s)
    cores[k] = (u * sq[None, :]).reshape(rl, n1, -1)
    cores[k + 1] = (sq[:, None] * vt).reshape(-1, n2, rr)


def tt_compress(x: TTVector, max_bond: int, truncerr: float = 0.0,
                sweeps: int = 1) -> TTVector:
    """Sweeping two-site SVD compression (functional version of the reference's
    in-place ``tt_compress!``, /root/reference/src/tt_tools.jl:772-789)."""
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    cores = list(x.cores)
    d = len(cores)
    for _ in range(sweeps):
        for k in range(d - 1):
            _bond_truncate(cores, k, max_bond, truncerr)
        for k in range(d - 2, -1, -1):
            _bond_truncate(cores, k, max_bond, truncerr)
    return TTVector(cores)


def tt_round(x: TTVector, max_bond: int | None = None,
             rel_tol: float = 0.0) -> TTVector:
    """TT rounding (Oseledets): right-orthogonalize, then one left-to-right
    truncated-SVD sweep with relative discarded-weight tolerance.

    This is the numerically optimal compression the library uses internally
    (Krylov vectors, steppers); ``tt_compress`` reproduces the reference's
    two-site sweep semantics for parity.
    """
    d = x.N
    if d == 1:
        return x.copy()
    y = orthogonalize(x, 0)
    cores = list(y.cores)
    for k in range(d - 1):
        rl, n, rr = cores[k].shape
        u, s, vt = jnp.linalg.svd(cores[k].reshape(rl * n, rr), full_matrices=False)
        s_host = np.asarray(s)
        keep = s_host.size
        if rel_tol > 0:
            nrm2 = float((s_host ** 2).sum())
            tail = np.cumsum(s_host[::-1] ** 2)[::-1]  # tail[i] = sum_{j>=i} s_j^2
            ok = tail > (rel_tol ** 2) * nrm2
            keep = int(ok.sum()) if ok.any() else 1
        if max_bond is not None:
            keep = min(keep, max_bond)
        keep = max(keep, 1)
        cores[k] = u[:, :keep].reshape(rl, n, keep)
        transfer = s[:keep, None] * vt[:keep, :]
        cores[k + 1] = jnp.einsum("ab,bnc->anc", transfer, cores[k + 1])
    ot = [1] * (d - 1) + [0]
    return TTVector(cores, ot)
