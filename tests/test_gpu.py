"""Compiled Triton kernels on a GPU (skipped elsewhere; see conftest.py).

The CPU suite runs the same kernels through the Pallas interpreter
(test_triton_projector.py); these compile them for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tomojax import TomoTPU
from tomojax import config as tjconfig
from tomojax.geometry import Geometry
from tomojax.projector.joseph import bp, fp

pytestmark = pytest.mark.gpu


def _rel(a, b):
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


@pytest.mark.parametrize("ns,n,na", [(37, 64, 33), (8, 96, 90), (1, 16, 5)])
def test_compiled_pair_matches_gather(gpu, ns, n, na):
    assert tjconfig.resolve_projector_mode() == "triton"
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((ns, n, n), np.float32))
    y = jnp.asarray(rng.random((ns, na, n), np.float32))
    assert _rel(jax.jit(lambda v: fp(v, geom))(x), fp(x, geom, "gather")) < 1e-5
    assert _rel(jax.jit(lambda v: bp(v, geom))(y), bp(y, geom, "gather")) < 1e-5


def test_fista_fused_matches_gather(gpu):
    from tomojax.sim import create_projections, nanocube_phantom

    ns, n, ang = 16, 64, np.linspace(-76, 76, 45)
    geom = Geometry.make(n, np.deg2rad(ang))
    b = np.asarray(create_projections(nanocube_phantom(ns, n), geom))
    ts = np.transpose(b, (0, 2, 1))
    got = TomoTPU(ang, ts).fista(Niter=5, fused=True).get_recon()
    try:
        tjconfig.set_projector_mode("gather")
        with jax.default_matmul_precision("highest"):
            want = TomoTPU(ang, ts).fista(Niter=5, fused=True).get_recon()
    finally:
        tjconfig.set_projector_mode("auto")
    assert _rel(jnp.asarray(got), jnp.asarray(want)) < 1e-4
