"""Which kernel family runs where (tomojax/config.py).

The platform is monkeypatched, so these run on the CPU: a GPU platform
must reach the Triton pair with interpret mode off (interpret is never
derived from the backend), the CPU the XLA 'mxu' form, and a mode the
platform cannot run must raise instead of falling back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tomojax import config as tjconfig
from tomojax import dist
from tomojax.geometry import Geometry
from tomojax.projector import joseph
from tomojax.projector import triton_joseph as tj


@pytest.fixture
def platform(monkeypatch):
    def set_to(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)

    return set_to


@pytest.mark.parametrize("plat,family", [("gpu", "triton"), ("cpu", "mxu")])
def test_auto_family_per_platform(platform, plat, family):
    platform(plat)
    assert tjconfig.platform() == plat
    assert tjconfig.resolve_projector_mode() == family
    assert tjconfig.resolve_projector_mode("gather") == "gather"


def test_unknown_platform_has_no_family(platform):
    platform("metal")
    with pytest.raises(RuntimeError, match="no projector family"):
        tjconfig.resolve_projector_mode()


def test_triton_on_cpu_raises(platform):
    platform("cpu")
    with pytest.raises(RuntimeError, match="cannot run"):
        tjconfig.resolve_projector_mode("triton")
    geom = Geometry.make(8, np.deg2rad([0.0, 30.0]))
    with pytest.raises(RuntimeError, match="cannot run"):
        joseph.fp(jnp.ones((1, 8, 8)), geom, "triton")


def test_unknown_mode_rejected():
    with pytest.raises(ValueError):
        tjconfig.set_projector_mode("banded")
    with pytest.raises(ValueError):
        tjconfig.resolve_projector_mode("banded")
    assert tjconfig.projector_mode == "auto"


def _spy(monkeypatch, name, calls):
    real = getattr(tj, name)

    def spy(a, geom, interpret=False):
        calls.append(interpret)
        return real(a, geom, True)  # run it through the interpreter here

    monkeypatch.setattr(tj, name, spy)


@pytest.mark.parametrize("op", ["fp", "bp"])
def test_gpu_dispatch_never_interprets(platform, monkeypatch, op):
    """On a GPU platform fp/bp call the Triton kernel with interpret off."""
    calls = []
    _spy(monkeypatch, f"{op}_triton", calls)
    platform("gpu")
    geom = Geometry.make(16, np.deg2rad(np.linspace(-60, 60, 5)))
    rng = np.random.default_rng(0)
    shape = (3, 16, 16) if op == "fp" else (3, 5, 16)
    a = jnp.asarray(rng.random(shape, np.float32))
    got = getattr(joseph, op)(a, geom)
    assert calls == [False]
    want = getattr(joseph, op)(a, geom, "gather")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["fp", "bp"])
def test_gpu_dispatch_under_mesh_runs_per_slab(platform, monkeypatch, op):
    """Under a multi-device mesh scope the Triton kernel runs per z-slab
    (shard_map) and matches the gather form; the result keeps the slabs."""
    calls = []
    _spy(monkeypatch, f"{op}_triton", calls)
    platform("gpu")
    ns, n, na = 16, 16, 5
    geom = Geometry.make(n, np.deg2rad(np.linspace(-60, 60, na)))
    rng = np.random.default_rng(1)
    shape = (ns, n, n) if op == "fp" else (ns, na, n)
    a = jnp.asarray(rng.random(shape, np.float32))
    mesh = dist.make_mesh()
    with tjconfig.mesh_scope(mesh):
        got = jax.jit(lambda v: getattr(joseph, op)(v, geom))(
            dist.shard_volume(a, mesh))
    assert calls == [False]
    assert len(got.sharding.device_set) == mesh.size
    want = getattr(joseph, op)(a, geom, "gather")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ndev,sharded", [(1, False), (8, True), (3, False)])
def test_on_slabs_partitions_only_divisible_meshes(ndev, sharded):
    """on_slabs wraps the kernel in shard_map only for a multi-device mesh
    whose size divides the slice count (16 slices)."""
    seen = []
    mesh = dist.make_mesh(ndev)

    def f(v):
        seen.append(v.shape[0])
        return v * 2.0

    out = jax.jit(lambda v: tj.on_slabs(f, v, mesh))(jnp.ones((16, 4, 4)))
    assert seen == [16 // ndev if sharded else 16]
    assert float(out.sum()) == 2.0 * 16 * 16
