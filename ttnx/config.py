"""Explicit configuration objects (SURVEY §5: the reference drives options
through keyword args plus module-level ``Ref`` globals; here every option is
an explicit dataclass — no globals, jit-pure)."""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import asdict, dataclass, field

import jax

__all__ = ["ALSConfig", "MALSConfig", "DMRGConfig", "TDVPConfig",
           "KrylovConfig", "matmul_precision"]


@dataclass(frozen=True)
class ALSConfig:
    """Options for :func:`ttnx.als_linsolve` (`**asdict(cfg)`)."""

    sweep_count: int = 2
    return_info: bool = False


@dataclass(frozen=True)
class MALSConfig:
    tol: float = 1e-12
    rmax: int | None = None
    return_info: bool = False


@dataclass(frozen=True)
class DMRGConfig:
    n_sites: int = 2
    tol: float = 1e-12
    sweep_schedule: tuple = (2,)
    rmax_schedule: tuple | None = None
    it_solver: bool = True
    linsolv_maxiter: int = 200
    itslv_thresh: int = 256


@dataclass(frozen=True)
class TDVPConfig:
    normalize: bool = True
    sweeps: int = 1
    carry_env: bool = True
    imaginary_time: bool = False
    max_bond: int | None = None
    truncerr: float = 0.0


@dataclass(frozen=True)
class KrylovConfig:
    max_bond: int = 0
    krylov_solver: str = "auto"
    krylovdim: int = 8
    maxiter: int = 20
    rtol: float = 1e-8
    atol: float = 1e-12


def to_kwargs(cfg) -> dict:
    """Dataclass config -> keyword arguments, dropping Nones for schedule
    fields that solvers default themselves."""
    out = {}
    for k, v in asdict(cfg).items():
        if v is None:
            continue
        out[k] = list(v) if isinstance(v, tuple) else v
    return out


@contextmanager
def matmul_precision(level: str = "highest"):
    """Scoped default matmul precision ('default' | 'high' | 'highest').
    Parity tests need 'highest'; on a GPU 'default' may run f32 dots in
    TF32."""
    with jax.default_matmul_precision(level):
        yield
