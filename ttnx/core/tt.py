"""TT/MPS containers for the tensor-train numerics framework.

Design (not a port):

* ``TTVector`` cores live in ``(r_left, n, r_right)`` layout — the natural MPS
  layout on XLA: left-orthogonalization is one reshape + QR, core contraction
  is one ``dot_general``. (The Julia reference stores ``(n, r-, r+)``
  column-major, see /root/reference/src/tt_tools.jl:23-29; both describe the
  same object.)
* ``TTOperator`` cores live in ``(r_left, n_out, n_in, r_right)`` layout
  (reference: ``(n_row, n_col, r-, r+)``, /root/reference/src/tt_tools.jl:48-54).
* Ranks and dims are *derived from core shapes* — static at trace time, which
  is exactly what XLA wants. Orthogonality flags ``ot`` are static pytree
  metadata (``-1`` right-canonical, ``0`` center/none, ``+1`` left-canonical),
  mirroring reference semantics (/root/reference/src/tt_tools.jl:190-196).
* Bit convention is big-endian (site 0 = most significant bit), so a C-order
  ``reshape(-1)`` of the dense tensor *is* the grid vector — no index shuffling
  (reference uses the same big-endian convention via explicit index maps,
  /root/reference/src/qtt_tools.jl:15-23).
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "TTVector",
    "TTOperator",
    "zeros_tt",
    "ones_tt",
    "rand_tt",
    "rand_tt_like",
    "zeros_tto",
    "rand_tto",
    "id_tto",
    "r_and_d_to_rks",
    "increase_ranks",
    "concatenate",
    "visualize",
]


def _as_tuple(x):
    if isinstance(x, (int, np.integer)):
        return (int(x),)
    return tuple(int(v) for v in x)


@jax.tree_util.register_pytree_node_class
class TTVector:
    """A tensor in TT (tensor-train / MPS) format.

    ``cores[k]`` has shape ``(r_k, n_k, r_{k+1})`` with ``r_0 = r_N = 1``.
    """

    __slots__ = ("cores", "ot")

    def __init__(self, cores: Sequence[jax.Array], ot: Sequence[int] | None = None):
        self.cores = tuple(cores)
        self.ot = tuple(int(o) for o in ot) if ot is not None else (0,) * len(self.cores)

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return self.cores, (self.ot,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (ot,) = aux
        obj = object.__new__(cls)
        obj.cores = tuple(children)
        obj.ot = ot
        return obj

    # -- shape metadata (static, host-side) --------------------------------
    @property
    def N(self) -> int:
        return len(self.cores)

    @property
    def dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[1]) for c in self.cores)

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(int(c.shape[0]) for c in self.cores) + (int(self.cores[-1].shape[2]),)

    @property
    def dtype(self):
        return self.cores[0].dtype

    def astype(self, dtype) -> "TTVector":
        return TTVector([c.astype(dtype) for c in self.cores], self.ot)

    def conj(self) -> "TTVector":
        return TTVector([jnp.conj(c) for c in self.cores], self.ot)

    @property
    def is_complex(self) -> bool:
        return jnp.issubdtype(self.dtype, jnp.complexfloating)

    def copy(self) -> "TTVector":
        return TTVector(self.cores, self.ot)

    def with_ot(self, ot: Sequence[int]) -> "TTVector":
        return TTVector(self.cores, ot)

    # -- operator sugar (wired to core.algebra lazily to avoid cycles) -----
    def __add__(self, other):
        from ttnx.core import algebra

        return algebra.add(self, other)

    def __sub__(self, other):
        from ttnx.core import algebra

        return algebra.sub(self, other)

    def __mul__(self, a):
        from ttnx.core import algebra

        return algebra.scale(a, self)

    __rmul__ = __mul__

    def __truediv__(self, a):
        from ttnx.core import algebra

        return algebra.scale(1.0 / a, self)

    def __neg__(self):
        from ttnx.core import algebra

        return algebra.scale(-1.0, self)

    def __matmul__(self, other):
        from ttnx.core import algebra

        if isinstance(other, TTVector):
            return algebra.dot(self, other)
        raise TypeError(f"cannot contract TTVector with {type(other)}")

    def __repr__(self):
        return (
            f"TTVector(dtype={self.dtype}, sites={self.N}, dims={self.dims}, "
            f"ranks={self.ranks}, ot={_ot_description(self.ot)})"
        )


@jax.tree_util.register_pytree_node_class
class TTOperator:
    """A linear operator in TT (MPO) format.

    ``cores[k]`` has shape ``(r_k, n_out_k, n_in_k, r_{k+1})``.
    """

    __slots__ = ("cores", "ot")

    def __init__(self, cores: Sequence[jax.Array], ot: Sequence[int] | None = None):
        self.cores = tuple(cores)
        self.ot = tuple(int(o) for o in ot) if ot is not None else (0,) * len(self.cores)

    def tree_flatten(self):
        return self.cores, (self.ot,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        (ot,) = aux
        obj = object.__new__(cls)
        obj.cores = tuple(children)
        obj.ot = ot
        return obj

    @property
    def N(self) -> int:
        return len(self.cores)

    @property
    def out_dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[1]) for c in self.cores)

    @property
    def in_dims(self) -> tuple[int, ...]:
        return tuple(int(c.shape[2]) for c in self.cores)

    # reference operators are square per site; `dims` mirrors `tto_dims`
    @property
    def dims(self) -> tuple[int, ...]:
        return self.out_dims

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(int(c.shape[0]) for c in self.cores) + (int(self.cores[-1].shape[3]),)

    @property
    def dtype(self):
        return self.cores[0].dtype

    def astype(self, dtype) -> "TTOperator":
        return TTOperator([c.astype(dtype) for c in self.cores], self.ot)

    def conj(self) -> "TTOperator":
        return TTOperator([jnp.conj(c) for c in self.cores], self.ot)

    @property
    def is_complex(self) -> bool:
        return jnp.issubdtype(self.dtype, jnp.complexfloating)

    def copy(self) -> "TTOperator":
        return TTOperator(self.cores, self.ot)

    def transpose(self) -> "TTOperator":
        """Operator transpose (swap output and input physical legs)."""
        return TTOperator([jnp.swapaxes(c, 1, 2) for c in self.cores], self.ot)

    @property
    def T(self) -> "TTOperator":
        return self.transpose()

    def adjoint(self) -> "TTOperator":
        return TTOperator([jnp.conj(jnp.swapaxes(c, 1, 2)) for c in self.cores], self.ot)

    @property
    def H(self) -> "TTOperator":
        return self.adjoint()

    def __add__(self, other):
        from ttnx.core import algebra

        return algebra.add_op(self, other)

    def __sub__(self, other):
        from ttnx.core import algebra

        return algebra.sub_op(self, other)

    def __mul__(self, a):
        from ttnx.core import algebra

        if isinstance(a, (TTVector, TTOperator)):
            return self.__matmul__(a)
        return algebra.scale_op(a, self)

    def __rmul__(self, a):
        from ttnx.core import algebra

        return algebra.scale_op(a, self)

    def __neg__(self):
        from ttnx.core import algebra

        return algebra.scale_op(-1.0, self)

    def __matmul__(self, other):
        from ttnx.core import algebra

        if isinstance(other, TTVector):
            return algebra.matvec(self, other)
        if isinstance(other, TTOperator):
            return algebra.matmul(self, other)
        raise TypeError(f"cannot contract TTOperator with {type(other)}")

    def __call__(self, x: TTVector) -> TTVector:
        from ttnx.core import algebra

        return algebra.matvec(self, x)

    def __repr__(self):
        return (
            f"TTOperator(dtype={self.dtype}, sites={self.N}, dims={self.dims}, "
            f"ranks={self.ranks}, ot={_ot_description(self.ot)})"
        )


def _ot_description(ot) -> str:
    """Human-readable canonical-form summary of the per-site ot flags
    (/root/reference/src/tt_tools.jl:589-601)."""
    ot = tuple(int(o) for o in ot)
    if all(o == 0 for o in ot):
        return "none"
    if all(o == 1 for o in ot):
        return "left-canonical"
    if all(o == -1 for o in ot):
        return "right-canonical"
    zeros_at = [i for i, o in enumerate(ot) if o == 0]
    if len(zeros_at) == 1:
        c = zeros_at[0]
        left_ok = all(o == 1 for o in ot[:c])
        right_ok = all(o == -1 for o in ot[c + 1:])
        if left_ok and right_ok:
            return f"center @ site {c}"
    return str(list(ot))


# ---------------------------------------------------------------------------
# Rank feasibility
# ---------------------------------------------------------------------------


def r_and_d_to_rks(rks, dims, rmax: int = 1024) -> tuple[int, ...]:
    """Clamp a rank vector to the feasible TT ranks of a tensor with ``dims``.

    ``r_k <= min(prod(dims[:k]), prod(dims[k:]), rmax)`` — the exact feasibility
    bound used everywhere in the reference (/root/reference/src/tt_tools.jl:407-425).
    Pure host-side integer arithmetic: ranks are static shapes under XLA.
    """
    dims = _as_tuple(dims)
    rks = [int(r) for r in rks]
    assert len(rks) == len(dims) + 1, "rks must have length len(dims)+1"
    out = []
    for k in range(len(rks)):
        left = int(np.prod(dims[:k], dtype=object)) if k > 0 else 1
        right = int(np.prod(dims[k:], dtype=object)) if k < len(dims) else 1
        out.append(int(min(rks[k], left, right, rmax)))
    return tuple(out)


def _full_rks(dims, rmax: int) -> tuple[int, ...]:
    dims = _as_tuple(dims)
    return r_and_d_to_rks([rmax] * (len(dims) + 1), dims, rmax=rmax)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def zeros_tt(dims, rks=None, *, rmax: int | None = None, dtype=jnp.float64,
             ot=None) -> TTVector:
    """All-zero TT vector with the given dims and ranks.

    Mirrors ``zeros_tt`` (/root/reference/src/tt_operators.jl:548-573). Provide
    either an explicit rank vector ``rks`` or a uniform cap ``rmax``.
    """
    dims = _as_tuple(dims)
    if rks is None:
        rks = _full_rks(dims, 1 if rmax is None else rmax)
    else:
        rks = tuple(int(r) for r in rks)
        assert len(rks) == len(dims) + 1
    cores = [
        jnp.zeros((rks[k], dims[k], rks[k + 1]), dtype=dtype) for k in range(len(dims))
    ]
    return TTVector(cores, ot)


def ones_tt(dims, dtype=jnp.float64) -> TTVector:
    """Rank-1 TT of all ones (/root/reference/src/tt_operators.jl:583-598)."""
    dims = _as_tuple(dims)
    return TTVector([jnp.ones((1, n, 1), dtype=dtype) for n in dims])


def rand_tt(key, dims, rks=None, *, rmax: int | None = None, normalise=False,
            orthogonal=False, dtype=jnp.float64) -> TTVector:
    """Random-Gaussian TT vector (/root/reference/src/tt_tools.jl:100-139).

    PRNG keys are threaded explicitly (JAX style) rather than via a global seed.
    """
    dims = _as_tuple(dims)
    if rks is None:
        rks = _full_rks(dims, 4 if rmax is None else rmax)
    else:
        rks = r_and_d_to_rks(rks, dims, rmax=10**9)
    keys = jax.random.split(key, len(dims))
    cores = []
    for k in range(len(dims)):
        shape = (rks[k], dims[k], rks[k + 1])
        if jnp.issubdtype(dtype, jnp.complexfloating):
            kr, ki = jax.random.split(keys[k])
            real_dt = jnp.finfo(dtype).dtype
            c = (jax.random.normal(kr, shape, real_dt)
                 + 1j * jax.random.normal(ki, shape, real_dt)).astype(dtype)
        else:
            c = jax.random.normal(keys[k], shape, dtype)
        if normalise:
            c = c / math.sqrt(dims[k] * rks[k + 1])
            if orthogonal:
                # left-orthogonalize the core exactly
                q, _ = jnp.linalg.qr(c.reshape(rks[k] * dims[k], rks[k + 1]))
                c = q.reshape(rks[k], dims[k], -1)
        cores.append(c)
    return TTVector(cores)


def rand_tt_like(key, x: TTVector, eps: float = 1e-5) -> TTVector:
    """Perturb ``x`` with Gaussian noise of scale ``eps``
    (/root/reference/src/tt_tools.jl:153-159)."""
    keys = jax.random.split(key, x.N)
    cores = []
    for k, c in enumerate(x.cores):
        noise = jax.random.normal(keys[k], c.shape, jnp.result_type(c.real))
        if x.is_complex:
            noise = noise.astype(c.dtype)
        cores.append(c + eps * noise)
    return TTVector(cores)


def zeros_tto(dims, rks=None, *, rmax: int | None = None, dtype=jnp.float64) -> TTOperator:
    """All-zero TT operator (/root/reference/src/tt_operators.jl:601-616)."""
    dims = _as_tuple(dims)
    if rks is None:
        sq = tuple(n * n for n in dims)
        rks = r_and_d_to_rks([1 if rmax is None else rmax] * (len(dims) + 1), sq,
                             rmax=1 if rmax is None else rmax)
    else:
        rks = tuple(int(r) for r in rks)
    cores = [
        jnp.zeros((rks[k], dims[k], dims[k], rks[k + 1]), dtype=dtype)
        for k in range(len(dims))
    ]
    return TTOperator(cores)


def rand_tto(key, dims, rmax: int, dtype=jnp.float64) -> TTOperator:
    """Random TT operator with feasibility-clamped ranks
    (/root/reference/src/tt_operators.jl:534-545)."""
    dims = _as_tuple(dims)
    d = len(dims)
    rks = [1]
    for i in range(1, d):
        left = int(np.prod(dims[:i], dtype=object))
        right = int(np.prod(dims[i:], dtype=object))
        rks.append(min(left, right, rmax))
    rks.append(1)
    keys = jax.random.split(key, d)
    cores = [
        jax.random.normal(keys[k], (rks[k], dims[k], dims[k], rks[k + 1]), dtype)
        for k in range(d)
    ]
    return TTOperator(cores)


def id_tto(d: int, n_dim: int = 2, dtype=jnp.float64) -> TTOperator:
    """Rank-1 identity MPO (/root/reference/src/tt_operators.jl:519-532)."""
    eye = jnp.eye(n_dim, dtype=dtype).reshape(1, n_dim, n_dim, 1)
    return TTOperator([eye] * d)


# ---------------------------------------------------------------------------
# Rank enrichment
# ---------------------------------------------------------------------------


def _rand_orthogonal(key, n: int, m: int, dtype) -> jax.Array:
    big = max(n, m)
    q, _ = jnp.linalg.qr(jax.random.uniform(key, (big, big), dtype))
    return q[:n, :m]


def increase_ranks(x: TTVector, max_bond: int, *, rks=None, noise: float = 0.0,
                   key=None) -> TTVector:
    """Pad cores to larger bond dims, optionally filling new slices with
    noise-scaled random-orthogonal blocks so fixed-rank solvers can grow
    structure (/root/reference/src/tt_tools.jl:443-496).

    With ``noise == 0`` this is exact zero-padding. ``key`` is required when
    ``noise > 0``.
    """
    d = x.N
    dims = x.dims
    old = x.ranks
    if max_bond <= max(old):
        raise ValueError("New bond dimension too low")
    if rks is None:
        rks = [1] + [max_bond] * (d - 1) + [1]
    rks = r_and_d_to_rks(rks, dims, rmax=max_bond)
    if noise != 0.0 and key is None:
        raise ValueError("increase_ranks with noise>0 needs an explicit PRNG key")
    keys = jax.random.split(key, d) if key is not None else [None] * d

    cores = []
    for i in range(d):
        c = x.cores[i]
        rl_old, n, rr_old = c.shape
        rl, rr = rks[i], rks[i + 1]
        out = jnp.zeros((rl, n, rr), dtype=c.dtype)
        out = out.at[:rl_old, :, :rr_old].set(c)
        if noise != 0.0:
            if rl == rl_old and rr > rr_old:
                q = _rand_orthogonal(keys[i], n * rl, rr - rr_old, c.dtype)
                out = out.at[:, :, rr_old:].set(
                    noise * q.reshape(rl, n, rr - rr_old))
            elif rr == rr_old and rl > rl_old:
                q = _rand_orthogonal(keys[i], rl - rl_old, n * rr, c.dtype)
                out = out.at[rl_old:, :, :].set(
                    noise * q.reshape(rl - rl_old, n, rr))
            elif rr > rr_old and rl > rl_old:
                q = _rand_orthogonal(keys[i], (rl - rl_old) * n, rr - rr_old, c.dtype)
                out = out.at[rl_old:, :, rr_old:].set(
                    noise * q.reshape(rl - rl_old, n, rr - rr_old))
        cores.append(out)
    return TTVector(cores)


# ---------------------------------------------------------------------------
# Structure utilities
# ---------------------------------------------------------------------------


def concatenate(a, b):
    """Glue two TT chains end-to-end (boundary ranks must match)
    (/root/reference/src/tt_tools.jl:708-735)."""
    if isinstance(a, TTVector) and isinstance(b, TTVector):
        if a.ranks[-1] != b.ranks[0]:
            raise ValueError(
                "The final rank of the first TT must equal the initial rank of the second.")
        return TTVector(a.cores + b.cores, a.ot + b.ot)
    if isinstance(a, TTOperator) and isinstance(b, TTOperator):
        if a.ranks[-1] != b.ranks[0]:
            raise ValueError(
                "The final rank of the first TT must equal the initial rank of the second.")
        return TTOperator(a.cores + b.cores, a.ot + b.ot)
    raise TypeError("concatenate expects two TTVectors or two TTOperators")


def visualize(tt) -> str:
    """ASCII bond diagram (/root/reference/src/tt_tools.jl:630-677). Returns the
    string (and prints it), so it is usable in tests and docs."""
    dims = tt.dims
    ranks = tt.ranks
    rwidth = max(max(len(str(r)) for r in ranks), 2)
    line1 = str(ranks[0]).rjust(rwidth)
    line2 = " " * len(line1)
    line3 = " " * len(line1)
    for i in range(len(dims)):
        seg = "-- • --" + str(ranks[i + 1]).rjust(rwidth)
        line1 += seg
        pos = len(line1) - rwidth - 4
        line2 += " " * (pos - len(line2)) + "|"
        dstr = str(dims[i])
        line3 += " " * (pos - len(line3) - len(dstr) // 2) + dstr
    out = "\n".join([line1, line2, line3])
    print(out)
    return out
