"""Golden convergence-trace regression tests.

The reference has no automated tests; its correctness contract is "the
per-iteration dd/rmse curves look right" (SURVEY.md §4). These tests pin
exact recorded traces for fixed deterministic setups so any accidental
change to the operator pair, weights, or solver update rules shows up as
a trace shift. Tolerances allow only float-reassociation noise — a real
algorithmic change moves these by orders of magnitude more.

Recorded on the CPU backend (tests force CPU), projector mode 'mxu'
(the CPU computes float32 products in float32 at any matmul precision).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tomojax.geometry import Geometry
from tomojax.solvers import make_system, fista_init, fista_step, sirt_sweep
from tomojax.projector.joseph import fp
from tomojax.sim import shepp_logan, create_projections
from tomojax import ops

N = 32

GOLDEN_FISTA_DD = [
    35.9043, 30.2624, 25.8059, 22.7951, 20.8521,
    19.4849, 18.5064, 17.8047, 17.3067, 16.9604,
]
GOLDEN_FISTA_RMSE = [
    0.20031, 0.19073, 0.18303, 0.17716, 0.17262,
    0.16903, 0.16624, 0.16413, 0.16258, 0.16149,
]
GOLDEN_SIRT_DD = [29.3667, 22.3681, 18.7679, 16.4471, 14.7511]


@pytest.fixture(scope="module")
def problem():
    angles = np.deg2rad(np.linspace(-70, 70, 20))
    geom = Geometry.make(N, angles)
    sysd = make_system(geom)
    ph = jnp.asarray(shepp_logan(N)[None])
    b = create_projections(ph, geom)
    return geom, sysd, ph, b


def test_fista_trace(problem):
    geom, sysd, ph, b = problem
    st = fista_init(jnp.zeros_like(ph), sysd)
    dd_trace, rmse_trace = [], []
    for _ in range(10):
        st, (cost, dd, tvv) = fista_step(st, b, sysd, 0.01, 5, True)
        dd_trace.append(float(dd))
        rmse_trace.append(float(ops.rmse(st.x, ph)))
    np.testing.assert_allclose(dd_trace, GOLDEN_FISTA_DD, rtol=2e-3)
    np.testing.assert_allclose(rmse_trace, GOLDEN_FISTA_RMSE, rtol=2e-3)


def test_sirt_trace(problem):
    geom, sysd, ph, b = problem
    x = jnp.zeros_like(ph)
    trace = []
    for _ in range(5):
        x = sirt_sweep(x, b, sysd, 2)
        trace.append(float(ops.data_distance(fp(x, geom), b)))
    np.testing.assert_allclose(trace, GOLDEN_SIRT_DD, rtol=2e-3)
