"""ttnx — tensor-train / quantics-tensor-train numerics in JAX.

A from-scratch accelerator framework with the capabilities of
``MartinMikkelsen/TensorTrainNumerics.jl`` (mounted read-only at
/root/reference): TT/QTT containers and algebra, SVD decomposition and
rounding, sweep solvers (ALS/MALS/DMRG), time evolution (TDVP, Euler family,
Krylov), QTT function encodings and operators, the QTT Fourier transform,
TT-cross black-box approximation, and quadrature — plus the layers the
reference does not have: mesh/sharding parallelism, batched jitted solves, a
Triton local-solve kernel, checkpointing, and profiling.

Numerical parity with the reference requires float64, so x64 mode is enabled on
import (pass-through if the user already configured it).
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from ttnx.core.tt import (  # noqa: E402
    TTVector,
    TTOperator,
    zeros_tt,
    ones_tt,
    rand_tt,
    rand_tt_like,
    zeros_tto,
    rand_tto,
    id_tto,
    r_and_d_to_rks,
    increase_ranks,
    concatenate,
    visualize,
)
from ttnx.core.decomp import (  # noqa: E402
    ttv_decomp,
    tto_decomp,
    ttv_to_tensor,
    tto_to_tensor,
    tto_to_ttv,
    ttv_to_tto,
    matricize,
)
from ttnx.core.canonical import (  # noqa: E402
    orthogonalize,
    entanglement_entropy,
    entanglemententropy,
    svdtrunc,
    tt_compress,
    tt_round,
)
from ttnx.core.algebra import (  # noqa: E402
    add,
    sub,
    scale,
    matvec,
    matmul,
    inner_core_product,
    outer_product,
    dot,
    norm,
    hadamard,
    hadamard_ttm,
    kron_tt,
    kron_tto,
    ttv_to_diag_tto,
    linear_combination,
    euclidean_distance,
    euclidean_distance_normalized,
)

from ttnx.ops.operators import (  # noqa: E402
    toeplitz_to_qtto,
    shift,
    gradient,
    laplacian,
    laplacian_DN,
    laplacian_ND,
    laplacian_NN,
    laplacian_P,
    inv_laplacian_DN,
    qtto_prolongation,
    qtto_constant_prolongation,
    qtto_linear_prolongation,
    pauli_matrix,
    pauli_sum_tto,
    pauli_pair_sum_tto,
    H_mu,
    H_munu,
    heisenberg_xyz_tto,
    ising_tto,
    xxz_tto,
    xxx_tto,
    xy_tto,
    qtt_laplacian,
)
from ttnx.ops.qtt import (  # noqa: E402
    gauss_chebyshev_lobatto,
    index_to_point,
    tuple_to_index,
    function_to_tensor,
    tensor_to_grid,
    function_to_qtt,
    function_to_qtt_uniform,
    qtt_to_function,
    qtt_to_vector,
    qtt_polynom,
    qtt_cos,
    qtt_sin,
    qtt_exp,
    qtt_chebyshev,
    qtt_basis_vector,
    qtt_trapezoidal,
    qtto_to_matrix,
    to_qtt,
    to_ttv,
    QTTVector,
    QTTOperator,
    check_compat,
    reorder,
    function_to_qttv,
    qttv_to_array,
)
from ttnx.ops.interpolation import (  # noqa: E402
    interpolating_qtt,
    lagrange_rank_revealing,
)
from ttnx.ops.fourier import (  # noqa: E402
    fourier_qtto,
    reverse_qtt_bits,
)
from ttnx.solvers.als import (  # noqa: E402
    als_linsolve,
    als_eigsolve,
    als_gen_eigsolv,
)
from ttnx.solvers.mals import (  # noqa: E402
    mals_linsolve,
    mals_eigsolve,
)
from ttnx.solvers.dmrg import (  # noqa: E402
    dmrg_linsolve,
    dmrg_eigsolve,
)
from ttnx.solvers.tdvp import (  # noqa: E402
    tdvp,
    tdvp2,
)
from ttnx.solvers.steppers import (  # noqa: E402
    euler_method,
    implicit_euler_method,
    crank_nicholson_method,
    rk4_method,
)
from ttnx.solvers.krylov import (  # noqa: E402
    krylov_linsolve,
    expm_multiply,
    expintegrator_tt,
)
from ttnx.cross.cross import (  # noqa: E402
    MaxVol,
    Greedy,
    DMRGCross,
    MaxVolPivot,
    RandomPivot,
    tt_cross,
    tt_integrate,
)
from ttnx.utils.manifold import (  # noqa: E402
    ttvector_manifold,
    manifold_gradient_descent,
    rayleigh_quotient,
)
from ttnx.utils.convert import (  # noqa: E402
    to_ttvector,
    from_reference_layout,
)
from ttnx.utils.checkpoint import save_tt, load_tt  # noqa: E402
from ttnx.config import (  # noqa: E402
    ALSConfig,
    DMRGConfig,
    KrylovConfig,
    MALSConfig,
    TDVPConfig,
    matmul_precision,
)
from ttnx.utils.profiling import SolverTelemetry, Timer  # noqa: E402

# reference-name aliases
from ttnx.cross.cross import DMRG  # noqa: E402  (the cross algorithm config)
from ttnx.ops.operators import Δ, Δ_DN, Δ_ND, Δ_NN, Δ_P  # noqa: E402

AbstractTTvector = TTVector
AbstractTToperator = TTOperator
# reference capitalization (reference exports TTvector/TToperator,
# /root/reference/src/TensorTrainNumerics.jl:3)
TTvector = TTVector
TToperator = TTOperator
QTTvector = QTTVector
QTToperator = QTTOperator

__version__ = "0.1.0"
