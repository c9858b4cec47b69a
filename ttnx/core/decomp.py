"""Dense <-> TT conversions (TT-SVD and reconstruction).

Notes: reconstruction is a single chain of matmuls with a running
``(prefix, rank)`` matrix — O(N · r² · 2^d), matmul-only — instead of the
reference's per-entry contraction loop (/root/reference/src/tt_tools.jl:265-279).
Decomposition utilities operate on host-resident dense data (they exist for
setup and oracle testing, like the reference's `ttv_decomp`); rank selection by
tolerance is inherently data-dependent, so it happens at trace-free call sites.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ttnx.core.tt import TTOperator, TTVector

__all__ = [
    "ttv_decomp",
    "tto_decomp",
    "ttv_to_tensor",
    "tto_to_tensor",
    "tto_to_ttv",
    "ttv_to_tto",
    "matricize",
]


def ttv_decomp(tensor, index: int = 0, tol: float = 1e-12) -> TTVector:
    """Hierarchical TT-SVD of a dense tensor, root core at ``index``.

    Cores left of the root are left-orthogonal (ot=+1 convention of the
    reference is mirrored: here ot[k] = 1 for k < index, -1 for k > index,
    0 at the root — matching /root/reference/src/tt_tools.jl:186-252 up to the
    reference's flipped sign bookkeeping, see its lines 190-196 where ot is
    -1 left / +1 right of the root; we store +1 = left-orthogonal which is the
    meaning both agree on). Singular values < ``tol`` are discarded.
    """
    a = np.asarray(tensor)
    dims = a.shape
    d = len(dims)
    assert 0 <= index < d
    dtype = a.dtype

    cores: list[np.ndarray] = [None] * d  # type: ignore[list-item]
    rks = [1] * (d + 1)

    cur = a
    # Left sweep: cores 0 .. index-1 become left-orthogonal.
    for i in range(index):
        cur = cur.reshape(rks[i] * dims[i], -1)
        u, s, vt = np.linalg.svd(cur, full_matrices=False)
        r = max(1, int(np.sum(s >= tol)))
        rks[i + 1] = r
        cores[i] = u[:, :r].reshape(rks[i], dims[i], r)
        cur = (s[:r, None] * vt[:r, :])

    # Right sweep: cores d-1 .. index+1 become right-orthogonal.
    for i in range(d - 1, index, -1):
        cur = cur.reshape(-1, dims[i] * rks[i + 1])
        u, s, vt = np.linalg.svd(cur, full_matrices=False)
        r = max(1, int(np.sum(s >= tol)))
        rks[i] = r
        cores[i] = vt[:r, :].reshape(r, dims[i], rks[i + 1])
        cur = u[:, :r] * s[:r][None, :]

    cores[index] = cur.reshape(rks[index], dims[index], rks[index + 1]).astype(dtype)

    ot = [1] * index + [0] + [-1] * (d - index - 1)
    return TTVector([jnp.asarray(c) for c in cores], ot)


def ttv_to_tensor(x: TTVector):
    """Contract a TT chain back to the dense tensor (progressive matmuls)."""
    P = x.cores[0].reshape(x.dims[0], x.ranks[1])
    for k in range(1, x.N):
        r, n, rn = x.cores[k].shape
        P = P @ x.cores[k].reshape(r, n * rn)
        P = P.reshape(-1, rn)
    return P.reshape(x.dims)


def _op_as_vec(A: TTOperator) -> TTVector:
    cores = []
    for c in A.cores:
        r, no, ni, rn = c.shape
        cores.append(c.reshape(r, no * ni, rn))
    return TTVector(cores, A.ot)


def tto_to_ttv(A: TTOperator) -> TTVector:
    """Reshape MPO cores to MPS cores over the merged (out, in) physical index
    (/root/reference/src/tt_tools.jl:296-304)."""
    return _op_as_vec(A)


def ttv_to_tto(x: TTVector) -> TTOperator:
    """Inverse of :func:`tto_to_ttv`; physical dims must be perfect squares
    (/root/reference/src/tt_tools.jl:323-333)."""
    cores = []
    for c in x.cores:
        r, n2, rn = c.shape
        n = int(round(n2 ** 0.5))
        if n * n != n2:
            raise ValueError("physical dimensions must be perfect squares")
        cores.append(c.reshape(r, n, n, rn))
    return TTOperator(cores, x.ot)


def tto_to_tensor(A: TTOperator):
    """Dense tensor ``T[x1..xd, y1..yd]`` of an MPO
    (/root/reference/src/tt_tools.jl:375-392)."""
    d = A.N
    t = ttv_to_tensor(_op_as_vec(A))  # axes (x1,y1,x2,y2,...,xd,yd) merged pairwise
    shape = []
    for no, ni in zip(A.out_dims, A.in_dims):
        shape.extend([no, ni])
    t = t.reshape(shape)
    perm = list(range(0, 2 * d, 2)) + list(range(1, 2 * d, 2))
    return jnp.transpose(t, perm)


def tto_decomp(tensor, index: int = 0, tol: float = 1e-12) -> TTOperator:
    """TT-SVD of a dense operator given as ``T[x1..xd, y1..yd]``
    (/root/reference/src/tt_tools.jl:338-362)."""
    a = np.asarray(tensor)
    assert a.ndim % 2 == 0
    d = a.ndim // 2
    dims = a.shape[:d]
    assert a.shape[d:] == dims
    # interleave to (x1,y1,...,xd,yd) and merge pairs: index (x_k, y_k) C-order.
    perm = []
    for k in range(d):
        perm.extend([k, d + k])
    merged = np.transpose(a, perm).reshape(tuple(n * n for n in dims))
    ttv = ttv_decomp(merged, index=index, tol=tol)
    return ttv_to_tto(ttv)


def matricize(qtt: TTVector, core: int | None = None):
    """Flatten a QTT state to its grid vector of length ``prod(dims[:core])``.

    With big-endian cores and C-order reshape the full-chain case is exactly
    ``ttv_to_tensor(...).reshape(-1)`` (/root/reference/src/tt_tools.jl:694-705).
    For ``core < N`` the trailing sites are read at physical index 0 — the
    reference indexes the dense tensor with only ``core`` bit indices, which
    is Julia's implicit trailing-index-1 convention — computed here by
    contracting the trailing cores into a right boundary vector instead of
    densifying all ``2^N`` entries. ``core`` defaults to the chain length.
    """
    if core is None:
        core = qtt.N
    if not 1 <= core <= qtt.N:
        raise ValueError(f"core must be in [1, {qtt.N}], got {core}")
    # Right boundary: trailing cores contracted at physical index 0.
    right = jnp.ones((1,), dtype=qtt.cores[-1].dtype)
    for k in range(qtt.N - 1, core - 1, -1):
        right = qtt.cores[k][:, 0, :] @ right
    # Progressive contraction of the leading `core` sites.
    P = qtt.cores[0].reshape(qtt.dims[0], qtt.ranks[1])
    for k in range(1, core):
        r, n, rn = qtt.cores[k].shape
        P = (P @ qtt.cores[k].reshape(r, n * rn)).reshape(-1, rn)
    return (P @ right).reshape(-1)
