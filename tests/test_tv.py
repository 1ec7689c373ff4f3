"""TV value / TV-GD / TV-FGP tests vs small numpy references.

The numpy references below re-implement the reference CUDA kernels' math
directly from their definitions (tv_gd.cu:27-47 value; tv_fgp.cu:44-281
FGP loop) so the JAX stencils can be checked exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tomojax import tv as tvmod


def _np_tv(x):
    eps = 1e-6
    ip = np.roll(x, -1, 0)
    jp = np.roll(x, -1, 1)
    kp = np.roll(x, -1, 2)
    return np.sum(
        np.sqrt(eps + (x - ip) ** 2 + (x - jp) ** 2 + (x - kp) ** 2)
    )


def _np_fgp(x, n_iter, lam):
    """Direct numpy port of the reference FGP loop semantics
    (tv_fgp.cu:244-268: Obj -> nonneg -> Grad -> iso projection)."""
    multip = 1.0 / (26.0 * lam)
    p1 = np.zeros_like(x)
    p2 = np.zeros_like(x)
    p3 = np.zeros_like(x)
    d = np.zeros_like(x)
    for _ in range(n_iter):
        # divergence with zero low-boundary (Obj_func3D_kernel)
        r1 = p1 - np.concatenate([np.zeros_like(p1[:1]), p1[:-1]], 0)
        r2 = p2 - np.concatenate([np.zeros_like(p2[:, :1]), p2[:, :-1]], 1)
        r3 = p3 - np.concatenate(
            [np.zeros_like(p3[:, :, :1]), p3[:, :, :-1]], 2
        )
        d = x - lam * (r1 + r2 + r3)
        d = np.maximum(d, 0.0)
        # forward differences, zero at far boundary (Grad_func3D_kernel)
        g1 = d - np.concatenate([d[1:], d[-1:]], 0)
        g1[-1] = 0
        g2 = d - np.concatenate([d[:, 1:], d[:, -1:]], 1)
        g2[:, -1] = 0
        g3 = d - np.concatenate([d[:, :, 1:], d[:, :, -1:]], 2)
        g3[:, :, -1] = 0
        p1 = p1 + multip * g1
        p2 = p2 + multip * g2
        p3 = p3 + multip * g3
        denom = p1**2 + p2**2 + p3**2
        with np.errstate(divide="ignore"):  # where() evaluates both arms
            scale = np.where(denom > 1.0, 1.0 / np.sqrt(denom), 1.0)
        p1, p2, p3 = p1 * scale, p2 * scale, p3 * scale
    return d


def _vol(shape=(6, 8, 8), seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, shape).astype(np.float32)


def test_tv_value_matches_numpy():
    x = _vol()
    got = float(tvmod.tv(jnp.asarray(x)))
    assert np.isclose(got, _np_tv(x.astype(np.float64)), rtol=1e-5)


def test_tv_batch_axis():
    x = _vol((3, 6, 8, 8))
    got = float(tvmod.tv(jnp.asarray(x)))
    want = sum(_np_tv(x[i].astype(np.float64)) for i in range(3))
    assert np.isclose(got, want, rtol=1e-5)


def test_tv_gd_decreases_tv_and_is_nonneg():
    x = _vol((8, 12, 12))
    x_new, tv0 = tvmod.tv_gd(jnp.asarray(x), 10, 0.5)
    assert np.isclose(float(tv0), _np_tv(x.astype(np.float64)), rtol=1e-5)
    assert float(tvmod.tv(x_new)) < float(tv0)
    assert float(jnp.min(x_new)) >= 0.0


def test_tv_gd_step_math():
    """Single unnormalized-direction step: x1 = x - dPOCS * g/||g||."""
    x = _vol((4, 6, 6))
    dpocs = 0.3
    x1, _ = tvmod.tv_gd(jnp.asarray(x), 1, dpocs)
    g = np.asarray(tvmod._tv_grad(jnp.asarray(x)))
    step = dpocs * g / np.linalg.norm(g)
    expect = np.maximum(x - step, 0.0)
    np.testing.assert_allclose(np.asarray(x1), expect, atol=1e-5)


def test_tv_fgp_matches_numpy_port():
    x = _vol((6, 8, 8))
    for it in (1, 3, 7):
        got, tv0 = tvmod.tv_fgp(jnp.asarray(x), it, 0.2)
        want = _np_fgp(x.astype(np.float64), it, 0.2)
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)
        assert np.isclose(float(tv0), _np_tv(x.astype(np.float64)), rtol=1e-5)


def test_tv_fgp_denoises():
    rng = np.random.default_rng(1)
    clean = np.zeros((8, 16, 16), np.float32)
    clean[:, 4:12, 4:12] = 1.0
    noisy = clean + 0.2 * rng.standard_normal(clean.shape).astype(np.float32)
    den, _ = tvmod.tv_fgp(jnp.asarray(noisy), 20, 0.1)
    assert float(tvmod.tv(den)) < _np_tv(noisy.astype(np.float64)) * 0.7
    # still close to the clean signal
    assert np.sqrt(np.mean((np.asarray(den) - clean) ** 2)) < 0.15


def test_tv_4d_per_element():
    x = _vol((3, 4, 6, 6))
    got, tv0 = tvmod.tv_fgp_4d(jnp.asarray(x), 3, 0.2)
    for e in range(3):
        per, _ = tvmod.tv_fgp(jnp.asarray(x[e]), 3, 0.2)
        np.testing.assert_allclose(np.asarray(got[e]), np.asarray(per), atol=1e-6)
    # 4D tv-gd normalizes per element
    g4, _ = tvmod.tv_gd_4d(jnp.asarray(x), 2, 0.1)
    for e in range(3):
        g3, _ = tvmod.tv_gd(jnp.asarray(x[e]), 2, 0.1)
        np.testing.assert_allclose(np.asarray(g4[e]), np.asarray(g3), atol=1e-6)


def _np_tv_grad(x):
    """Numpy port of the 4-term isotropic subgradient (tv_gd.cu:52-106,
    intended math: periodic neighbors on every axis)."""
    eps = 1e-6

    def d_at(v):
        return np.sqrt(eps + (v - np.roll(v, -1, 0)) ** 2
                       + (v - np.roll(v, -1, 1)) ** 2
                       + (v - np.roll(v, -1, 2)) ** 2)

    d = d_at(x)
    g = (3 * x - np.roll(x, -1, 0) - np.roll(x, -1, 1) - np.roll(x, -1, 2)) / d
    for ax in range(3):
        g = g + (x - np.roll(x, 1, ax)) / np.roll(d, 1, ax)
    return g


def _np_tv_gd(x, ng, dpocs):
    for _ in range(ng):
        g = _np_tv_grad(x)
        x = x - dpocs * g / np.linalg.norm(g)
    return np.maximum(x, 0.0)


# iteration counts and shapes of the fused-kernel era's FGP cases
FGP_CASES = [
    (1, (6, 16, 16)), (3, (6, 16, 16)), (7, (6, 16, 16)),
    (1, (8, 16, 16)), (4, (12, 16, 16)), (10, (16, 24, 24)),
    (7, (5, 12, 12)), (3, (8, 16, 16)), (4, (8, 16, 16)),
    (5, (8, 16, 16)), (9, (8, 16, 16)), (3, (12, 16, 16)),
    (5, (12, 16, 16)), (9, (12, 16, 16)),
]


@pytest.mark.parametrize("iters,shape", FGP_CASES)
def test_fgp_cases_match_numpy(iters, shape):
    rng = np.random.default_rng(iters)
    x = (rng.normal(size=shape) + 0.5).astype(np.float32)
    got, tv0 = tvmod.tv_fgp(jnp.asarray(x), iters, 0.2)
    want = _np_fgp(x.astype(np.float64), iters, 0.2)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)
    assert np.isclose(float(tv0), _np_tv(x.astype(np.float64)), rtol=1e-5)


@pytest.mark.parametrize("iters,shape", [(5, (2, 8, 12, 12)),
                                         (6, (3, 8, 12, 12))])
def test_fgp_4d_matches_numpy_per_element(iters, shape):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) + 0.4).astype(np.float32)
    got, tv0 = tvmod.tv_fgp_4d(jnp.asarray(x), iters, 0.15)
    for e in range(shape[0]):
        want = _np_fgp(x[e].astype(np.float64), iters, 0.15)
        np.testing.assert_allclose(np.asarray(got[e]), want,
                                   rtol=1e-5, atol=1e-5)
    want_tv = sum(_np_tv(x[e].astype(np.float64)) for e in range(shape[0]))
    assert np.isclose(float(tv0), want_tv, rtol=1e-5)


def test_fgp_boundary_planes():
    """Boundary planes (z=0 and z=nz-1) carry the zero-flux semantics."""
    x = np.zeros((4, 8, 8), np.float32)
    x[0], x[-1] = 1.0, 2.0
    got, _ = tvmod.tv_fgp(jnp.asarray(x), 5, 0.1)
    want = _np_fgp(x.astype(np.float64), 5, 0.1)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 16, 16), (3, 8, 16, 16)])
def test_tv_value_cases(shape):
    rng = np.random.default_rng(13)
    x = rng.normal(size=shape).astype(np.float32)
    xs = x.reshape((-1,) + shape[-3:]).astype(np.float64)
    want = sum(_np_tv(v) for v in xs)
    assert np.isclose(float(tvmod.tv(jnp.asarray(x))), want, rtol=1e-5)


def test_tv_value_wraps_periodically():
    """Changing only plane 0 moves the TV term of plane nz-1 (periodic)."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(16, 16, 16)).astype(np.float32)
    xb = x.copy()
    xb[0] += 1.0
    d_got = float(tvmod.tv(jnp.asarray(xb))) - float(tvmod.tv(jnp.asarray(x)))
    d_want = _np_tv(xb.astype(np.float64)) - _np_tv(x.astype(np.float64))
    assert np.isclose(d_got, d_want, rtol=1e-3)


def test_tv_grad_matches_numpy():
    x = _vol((6, 16, 16), 2)
    np.testing.assert_allclose(np.asarray(tvmod._tv_grad(jnp.asarray(x))),
                               _np_tv_grad(x.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ng", [1, 5])
def test_tv_gd_matches_numpy(ng):
    x = _vol((6, 16, 16), 2)
    got, tv0 = tvmod.tv_gd(jnp.asarray(x), ng, 0.3)
    np.testing.assert_allclose(np.asarray(got),
                               _np_tv_gd(x.astype(np.float64), ng, 0.3),
                               atol=1e-5)
    assert np.isclose(float(tv0), _np_tv(x.astype(np.float64)), rtol=1e-5)


def test_tv_gd_periodic_seam():
    """A field that jumps at the z wrap seam: plane 0 must see plane nz-1."""
    x = np.ones((16, 8, 8), np.float32)
    x[0], x[-1] = 4.0, -2.0
    got, _ = tvmod.tv_gd(jnp.asarray(x), 3, 0.1)
    np.testing.assert_allclose(np.asarray(got),
                               _np_tv_gd(x.astype(np.float64), 3, 0.1),
                               atol=1e-5)
