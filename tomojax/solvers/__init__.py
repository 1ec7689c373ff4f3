"""Reconstruction solvers (SURVEY.md §2.4 algorithm inventory).

All solvers are pure functions over ``(Ns, N, N)`` volumes; per-iteration
work is one XLA program (vs. the reference's per-slice ASTRA host loops).
"""

from tomojax.solvers.base import System, make_system
from tomojax.solvers.iterative import (
    sirt_sweep,
    sart_sweep,
    make_sart_weights,
    art_sweep,
    cgls_run,
    poisson_ml_step,
    least_squares_step,
)
from tomojax.solvers.wbp import fbp
from tomojax.solvers.fista import (
    FistaState,
    fista_init,
    fista_run,
    fista_step,
)
from tomojax.solvers.asd_pocs import (
    AsdPocsParams,
    make_asd_pocs_iteration,
    make_asd_pocs_run,
)

__all__ = [
    "System",
    "make_system",
    "sirt_sweep",
    "sart_sweep",
    "make_sart_weights",
    "art_sweep",
    "cgls_run",
    "poisson_ml_step",
    "least_squares_step",
    "fbp",
    "FistaState",
    "fista_init",
    "fista_run",
    "fista_step",
    "AsdPocsParams",
    "make_asd_pocs_iteration",
    "make_asd_pocs_run",
]
