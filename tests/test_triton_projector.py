"""Triton projector kernels (projector/triton_joseph.py) vs the XLA forms.

The kernels run through the Pallas interpreter here (``interpret=True``,
passed explicitly). They compute the gather form's arithmetic in the same
order, so they must agree with ``mode="gather"`` to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tomojax import dist
from tomojax.geometry import Geometry
from tomojax.projector.joseph import bp, fp
from tomojax.projector.oracle import fp_oracle, ray_matrix
from tomojax.projector.triton_joseph import bp_triton, fp_triton, on_slabs

# (Nslice, N, angles in degrees): odd sizes, one angle, more slices than a
# slice block, exact 0/45/90/135 degrees, N not a power of two, and slice
# counts that are not a multiple of the block.
CASES = {
    "5x33x7": (5, 33, np.linspace(-76, 76, 7)),
    "8x32x12": (8, 32, np.linspace(-76, 76, 12)),
    "3x16x1": (3, 16, np.array([-76.0])),
    "130x24x9": (130, 24, np.linspace(-76, 76, 9)),
    "exact_angles": (4, 16, np.array([0.0, 45.0, 90.0, 135.0])),
    "n_not_pow2": (6, 20, np.linspace(-60, 80, 5)),
    "ns_not_block_multiple": (37, 16, np.linspace(-70, 70, 6)),
}


def _problem(name, seed=0):
    ns, n, ang = CASES[name]
    geom = Geometry.make(n, np.deg2rad(ang))
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(ns, n, n)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(ns, len(ang), n)).astype(np.float32))
    return geom, x, y


def _rel(a, b):
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


@pytest.mark.parametrize("name", CASES)
def test_fp_matches_gather(name):
    geom, x, _ = _problem(name)
    got = fp_triton(x, geom, True)
    assert got.shape == (x.shape[0], geom.nproj, geom.nray)
    assert _rel(got, fp(x, geom, "gather")) < 1e-6


@pytest.mark.parametrize("name", CASES)
def test_bp_matches_gather(name):
    geom, _, y = _problem(name)
    got = bp_triton(y, geom, True)
    assert got.shape == (y.shape[0], geom.n, geom.n)
    assert _rel(got, bp(y, geom, "gather")) < 1e-6


@pytest.mark.parametrize("name", CASES)
def test_mxu_matches_gather(name):
    """The dense-matrix form (the CPU default) is the same operator."""
    geom, x, y = _problem(name)
    assert _rel(fp(x, geom, "mxu"), fp(x, geom, "gather")) < 1e-5
    assert _rel(bp(y, geom, "mxu"), bp(y, geom, "gather")) < 1e-5


@pytest.mark.parametrize("name", ["5x33x7", "exact_angles", "n_not_pow2"])
def test_adjointness(name):
    geom, x, y = _problem(name, seed=1)
    ax = fp_triton(x, geom, True)
    aty = bp_triton(y, geom, True)
    lhs, rhs = float(jnp.vdot(ax, y)), float(jnp.vdot(x, aty))
    assert abs(lhs - rhs) <= 1e-5 * float(
        jnp.linalg.norm(ax) * jnp.linalg.norm(y))


def test_fp_matches_siddon_oracle():
    """Joseph (Triton) vs the exact Siddon matrix on a smooth phantom:
    different discretizations, sub-percent apart."""
    n, ang = 32, np.linspace(-70, 70, 25)
    geom = Geometry.make(n, np.deg2rad(ang))
    yy, xx = np.mgrid[0:n, 0:n]
    ph = np.exp(-(((xx - n / 2) / (n / 4)) ** 2
                  + ((yy - n / 2.5) / (n / 5)) ** 2)).astype(np.float32)[None]
    got = np.asarray(fp_triton(jnp.asarray(ph), geom, True))
    ref = fp_oracle(ray_matrix(n, ang), ph.astype(np.float64))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-2


@pytest.mark.parametrize("op", ["fp", "bp"])
def test_empty_angle_set(op):
    geom = Geometry.make(16, np.zeros((0,)))
    if op == "fp":
        out = fp_triton(jnp.ones((2, 16, 16)), geom, True)
        assert out.shape == (2, 0, 16)
    else:
        out = bp_triton(jnp.ones((2, 0, 16)), geom, True)
        assert out.shape == (2, 16, 16) and float(jnp.abs(out).max()) == 0.0


@pytest.mark.parametrize("op", ["fp", "bp"])
def test_custom_vjp_is_partner(op):
    """The VJP of each kernel is its matched partner: grad <A x, y> = A^T y
    and grad <A^T y, x> = A x."""
    geom, x, y = _problem("8x32x12", seed=2)
    if op == "fp":
        g = jax.grad(lambda v: jnp.vdot(fp_triton(v, geom, True), y))(x)
        want = bp(y, geom, "gather")
    else:
        g = jax.grad(lambda v: jnp.vdot(bp_triton(v, geom, True), x))(y)
        want = fp(x, geom, "gather")
    assert _rel(g, want) < 1e-6


@pytest.mark.parametrize("op", ["fp", "bp"])
def test_on_slabs_matches_unsharded(op):
    """Per-slab kernels under shard_map on the 8-device mesh == the whole
    array (the data term is slice-parallel); output keeps the slabs."""
    ns, n = 16, 16
    geom = Geometry.make(n, np.deg2rad(np.linspace(-60, 60, 7)))
    rng = np.random.default_rng(3)
    shape = (ns, n, n) if op == "fp" else (ns, 7, n)
    a = jnp.asarray(rng.random(shape, np.float32))
    kern = fp_triton if op == "fp" else bp_triton
    mesh = dist.make_mesh()
    got = jax.jit(lambda v: on_slabs(lambda s: kern(s, geom, True), v, mesh))(
        dist.shard_volume(a, mesh))
    assert len(got.sharding.device_set) == mesh.size
    np.testing.assert_allclose(np.asarray(got), np.asarray(kern(a, geom, True)),
                               rtol=1e-6, atol=1e-6)
