"""Solver convergence tests on analytic phantoms (SURVEY.md §4 golden-value
strategy: the reference judges correctness by per-iteration rmse/dd curves;
here those become hard assertions)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tomojax.geometry import Geometry
from tomojax.solvers import (
    make_system,
    make_sart_weights,
    sirt_sweep,
    sart_sweep,
    art_sweep,
    cgls_run,
    poisson_ml_step,
    least_squares_step,
    fbp,
    fista_init,
    fista_step,
    AsdPocsParams,
    make_asd_pocs_iteration,
)
from tomojax.projector.joseph import fp
from tomojax.sim import shepp_logan, create_projections
from tomojax import ops

N = 48


@pytest.fixture(scope="module")
def problem():
    angles = np.deg2rad(np.linspace(0, 180, 50, endpoint=False))
    geom = Geometry.make(N, angles)
    sysd = make_system(geom)
    ph = jnp.asarray(shepp_logan(N)[None])
    b = create_projections(ph, geom)
    return geom, sysd, ph, b


@pytest.fixture(scope="module")
def tilt_problem():
    """Missing-wedge tilt range like real electron tomography."""
    angles = np.deg2rad(np.linspace(-70, 70, 40))
    geom = Geometry.make(N, angles)
    sysd = make_system(geom)
    ph = jnp.asarray(shepp_logan(N)[None])
    b = create_projections(ph, geom)
    return geom, sysd, ph, b


def test_sirt_converges(problem):
    geom, sysd, ph, b = problem
    x = jnp.zeros_like(ph)
    dds = []
    step = jax.jit(lambda x: sirt_sweep(x, b, sysd, 5))
    for _ in range(12):
        x = step(x)
        dds.append(float(ops.data_distance(fp(x, geom), b)))
    assert all(a > c for a, c in zip(dds, dds[1:])), dds
    assert float(ops.rmse(x, ph)) < 0.09
    assert float(jnp.min(x)) >= 0.0


def test_sirt_variants(problem):
    """Landweber and Cimmino weightings (reference CPU SIRT styles,
    ctvlib.cpp:205-251) converge; row-norm weights match a dense check."""
    from tomojax.solvers.base import row_norms_sq
    from tomojax.projector.joseph import fp as _fp

    geom, sysd, ph, b = problem
    from tomojax.projector.joseph import bp as _bp

    rn = row_norms_sq(geom)
    # check ||a_r||^2 on a few rays: the operator row a_r is the exact
    # backprojection of a delta sinogram (gather mode = exact transpose)
    n = geom.n
    for a, j in [(0, n // 2), (len(geom.angles) // 2, 3)]:
        e = np.zeros((1, geom.nproj, geom.nray), np.float32)
        e[0, a, j] = 1.0
        row_img = np.asarray(_bp(jnp.asarray(e), geom, "gather"))
        assert np.isclose(
            float(rn[0, a, j]), float((row_img**2).sum()), rtol=1e-3
        ), (a, j)

    x_lw = sirt_sweep(jnp.zeros_like(ph), b, sysd, 40, variant="landweber")
    assert float(ops.rmse(jnp.maximum(x_lw, 0), ph)) < 0.15
    x_ci = sirt_sweep(
        jnp.zeros_like(ph), b, sysd, 40, variant="cimmino",
        beta=float(geom.nproj * geom.nray) / float(sysd.lipschitz) * 2.0,
        row_nsq=rn,
    )
    assert float(ops.rmse(jnp.maximum(x_ci, 0), ph)) < 0.3
    with pytest.raises(ValueError):
        sirt_sweep(jnp.zeros_like(ph), b, sysd, 1, variant="bogus")


def test_fbp_quality(problem):
    geom, sysd, ph, b = problem
    x = fbp(b, geom, "ram-lak")
    assert float(ops.rmse(x, ph)) < 0.09
    # amplitude calibration: clamped-mean within ~20%
    ratio = float(jnp.mean(x) / jnp.mean(ph))
    assert 0.8 < ratio < 1.25, ratio


@pytest.mark.parametrize("name", ["shepp-logan", "hamming", "hann", "cosine"])
def test_fbp_filters_run(problem, name):
    geom, sysd, ph, b = problem
    x = fbp(b, geom, name)
    assert float(ops.rmse(x, ph)) < 0.15


def test_cgls_beats_sirt_periter(problem):
    geom, sysd, ph, b = problem
    x = cgls_run(jnp.zeros_like(ph), b, sysd, 15)
    x = jnp.maximum(x, 0)
    assert float(ops.rmse(x, ph)) < 0.06


def test_sart_converges(tilt_problem):
    geom, sysd, ph, b = tilt_problem
    w = make_sart_weights(sysd)
    x = jnp.zeros_like(ph)
    step = jax.jit(lambda x: sart_sweep(x, b, sysd, w, 1.0))
    for _ in range(5):
        x = step(x)
    assert float(ops.rmse(x, ph)) < 0.09
    # random order also works
    order = jnp.asarray(np.random.default_rng(0).permutation(geom.nproj), jnp.int32)
    x2 = sart_sweep(jnp.zeros_like(ph), b, sysd, w, 1.0, order)
    assert float(ops.rmse(x2, ph)) < 0.2


def test_art_kaczmarz(tilt_problem):
    geom, sysd, ph, b = tilt_problem
    x = art_sweep(jnp.zeros_like(ph), b, sysd, beta=0.5)
    r0 = float(ops.rmse(x, ph))
    x = art_sweep(x, b, sysd, beta=0.5)
    assert float(ops.rmse(x, ph)) < r0


def test_poisson_ml(problem):
    geom, sysd, ph, b = problem
    bn = b / jnp.max(b)
    x = jnp.zeros_like(ph)
    step = jax.jit(lambda x: poisson_ml_step(x, bn, sysd, 0.5))
    costs = []
    for _ in range(120):
        x, c = step(x)
        costs.append(float(c))
    assert costs[-1] < costs[0]
    # reconstruction proportional to phantom
    corr = np.corrcoef(np.asarray(x).ravel(), np.asarray(ph).ravel())[0, 1]
    assert corr > 0.93, corr


def test_least_squares_step(problem):
    geom, sysd, ph, b = problem
    x = jnp.zeros_like(ph)
    step = jax.jit(lambda x: least_squares_step(x, b, sysd))
    r_prev = float(ops.rmse(jnp.maximum(x, 0), ph))
    for _ in range(40):
        x = step(x)
    r = float(ops.rmse(jnp.maximum(x, 0), ph))
    assert r < r_prev and r < 0.15, r


def test_fista_tv(tilt_problem):
    geom, sysd, ph, b = tilt_problem
    st = fista_init(jnp.zeros_like(ph), sysd)
    step = jax.jit(lambda st: fista_step(st, b, sysd, 0.005, 10, True))
    costs = []
    for _ in range(25):
        st, (cost, dd, tvv) = step(st)
        costs.append(float(cost))
    assert costs[-1] < costs[0]
    # TV-regularized solution: biased vs the clean phantom, so the bound is
    # looser than SIRT's (TV pays off under noise, not on clean data).
    assert float(ops.rmse(st.x, ph)) < 0.15
    # reference-compat mode (prox discarded) also runs & converges in dd
    st2 = fista_init(jnp.zeros_like(ph), sysd)
    step2 = jax.jit(
        lambda st: fista_step(st, b, sysd, 0.02, 10, True, compat="reference")
    )
    for _ in range(5):
        st2, m2 = step2(st2)
    assert np.isfinite(float(m2[0]))


def test_fista_run_matches_stepped(tilt_problem):
    """fista_run (one scanned program, used by bench.py) is the same math
    as n calls of fista_step — state and per-iteration metrics agree."""
    from tomojax.solvers import fista_run

    geom, sysd, ph, b = tilt_problem
    st_a = fista_init(jnp.zeros_like(ph), sysd)
    st_b = st_a
    step = jax.jit(lambda st: fista_step(st, b, sysd, 0.005, 5, True))
    metrics = []
    for _ in range(4):
        st_a, m = step(st_a)
        metrics.append([float(v) for v in m])
    run = jax.jit(lambda st: fista_run(st, b, sysd, 0.005, 4, 5, True))
    st_b, ms = run(st_b)
    np.testing.assert_allclose(
        np.asarray(ms), np.asarray(metrics), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st_b.x), np.asarray(st_a.x), rtol=2e-5, atol=1e-6
    )


def test_asd_pocs_loop(tilt_problem):
    """Host-side adaptation loop exactly as the reference's working driver
    (cpu/sim_ASD.py:65-96), including the first-iteration dPOCS init."""
    geom, sysd, ph, b = tilt_problem
    p = AsdPocsParams(ng=5)
    w = make_sart_weights(sysd)
    run = make_asd_pocs_iteration(sysd, w, p.ng)
    order = jnp.arange(geom.nproj, dtype=jnp.int32)
    x = jnp.zeros_like(ph)
    beta, dpocs = p.beta0, 0.0
    dds = []
    for i in range(15):
        x, dp, dd, dg, tv0, dpocs_eff = run(
            x, b, beta, dpocs, order, first=(i == 0), alpha=p.alpha
        )
        beta *= p.beta_red
        dp, dd, dg, dpocs = float(dp), float(dd), float(dg), float(dpocs_eff)
        if dg > p.r_max * dp and dd > p.eps:
            dpocs *= p.alpha_red
        dds.append(dd)
    assert dds[-1] < dds[0]
    assert float(ops.rmse(x, ph)) < 0.15


def test_asd_pocs_fused_scan_matches_host_loop(tilt_problem):
    """The fully-jitted scan variant reproduces the host-loop trajectory."""
    from tomojax.solvers.asd_pocs import make_asd_pocs_run

    geom, sysd, ph, b = tilt_problem
    p = AsdPocsParams(niter=8, ng=5)
    w = make_sart_weights(sysd)
    # host loop
    run1 = make_asd_pocs_iteration(sysd, w, p.ng)
    order = jnp.arange(geom.nproj, dtype=jnp.int32)
    x1 = jnp.zeros_like(ph)
    beta, dpocs = p.beta0, 0.0
    dds1 = []
    for i in range(p.niter):
        x1, dp, dd, dg, tv0, dpocs_eff = run1(
            x1, b, beta, dpocs, order, first=(i == 0), alpha=p.alpha
        )
        beta *= p.beta_red
        dp, dd, dg, dpocs = float(dp), float(dd), float(dg), float(dpocs_eff)
        if dg > p.r_max * dp and dd > p.eps:
            dpocs *= p.alpha_red
        dds1.append(dd)
    # fused scan
    run2 = make_asd_pocs_run(sysd, w, p)
    x2, dd2, tv2 = run2(jnp.zeros_like(ph), b, jax.random.PRNGKey(0))
    # host loop round-trips the adaptive scalars through python floats;
    # the scan carries them in f32 — trajectories agree to that rounding
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x1), atol=2e-3)
    np.testing.assert_allclose(np.asarray(dd2), np.asarray(dds1), rtol=1e-3)


def test_fista_momentum_toggle_keeps_invariants(tilt_problem):
    """Toggling momentum across calls on the same state must keep the
    carried projections valid: ay == A yk and ax == A x_old at every
    point (review finding: the old non-momentum branch stored a stale
    x_old, corrupting the next momentum extrapolation by ~0.1)."""
    from tomojax.solvers import fista_init, fista_step

    geom, sysd, ph, b = tilt_problem
    st = fista_init(jnp.zeros_like(ph), sysd)
    for mom in (True, True, False, True, False, False, True):
        st, m = fista_step(st, b, sysd, 0.01, 3, mom)
        ay_true = fp(st.yk, geom)
        ax_true = fp(st.x_old, geom)
        assert float(jnp.max(jnp.abs(st.ay - ay_true))) < 1e-4, mom
        assert float(jnp.max(jnp.abs(st.ax - ax_true))) < 1e-4, mom
        assert np.isfinite(float(m[0]))


def test_seed_fp_cache_keys_on_config_knobs(tilt_problem):
    """The cached seeding FP must key on every trace-time config knob the
    projector dispatch reads (changing the matmul precision after the
    first fista_init must not reuse a stale-precision seed)."""
    from tomojax.solvers import fista_init
    from tomojax.solvers.fista import _seed_fp
    from tomojax import config as tjconfig

    geom, sysd, ph, b = tilt_problem
    x0 = jnp.zeros_like(ph)
    fista_init(x0, sysd)
    size0 = _seed_fp.cache_info().currsize
    fista_init(x0, sysd)  # same knobs: no new entry, no re-trace
    assert _seed_fp.cache_info().currsize == size0
    prec = tjconfig.mxu_precision
    try:
        tjconfig.set_projector_mode("auto", precision=jax.lax.Precision.HIGH)
        fista_init(x0, sysd)
        assert _seed_fp.cache_info().currsize == size0 + 1
    finally:
        tjconfig.projector_mode = "auto"
        tjconfig.mxu_precision = prec
