"""API-surface tests: TomoTPU / Simulator / ChemicalTomo parity with the
reference quickstart (README.md:33-53) and data-layout conventions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tomojax
from tomojax import TomoTPU, ChemicalTomo
from tomojax.api import Simulator, _to_sinogram
from tomojax.sim import shepp_logan
from tomojax.geometry import Geometry
from tomojax.projector.joseph import fp

N = 32
ANGLES = np.linspace(-70, 70, 20)


def _series():
    """Reference-layout tilt series (Nslice, Nray, Nangles)."""
    geom = Geometry.make(N, np.deg2rad(ANGLES))
    ph = np.stack([shepp_logan(N)] * 3)
    b = np.asarray(fp(jnp.asarray(ph), geom))  # (Ns, Na, Nt)
    return np.transpose(b, (0, 2, 1)), ph


def test_layout_roundtrip():
    ts, _ = _series()
    b = _to_sinogram(ts)
    assert b.shape == (3, len(ANGLES), N)
    # matches the reference flattening tiltSeries[s].T.ravel()
    # (gpu/reconstructor.py:54-59)
    for s in range(3):
        np.testing.assert_array_equal(b[s].ravel(), ts[s].T.ravel())


def test_quickstart_fista():
    ts, ph = _series()
    tomo = TomoTPU(ANGLES, ts)
    tomo.fista(Niter=8, lambda_param=0.005, show_convergence=True)
    rec = tomo.get_recon()
    assert rec.shape == (3, N, N)
    assert np.isfinite(tomo.cost).all()
    assert tomo.cost[-1] < tomo.cost[0]


def test_sirt_sart_cgls_wbp_kl():
    ts, ph = _series()
    tomo = TomoTPU(ANGLES, ts)
    tomo.sirt(Niter=10)
    assert tomo.cost[-1] < tomo.cost[0]
    r_sirt = tomo.get_recon()
    tomo.sart(Niter=3, init="random")
    assert np.isfinite(tomo.cost).all()
    tomo.cgls(Niter=8)
    assert tomo.get_recon().min() >= 0
    tomo.wbp("hamming")
    assert tomo.get_recon().shape == (3, N, N)
    tomo.kl_divergence(Niter=10, lambda_param=0.3)
    assert tomo.cost[-1] < tomo.cost[0]
    # unknown wbp filter falls back instead of raising (reference
    # reconstructor.py:65-67 prints + defaults)
    tomo.wbp("definitely-not-a-filter")


def test_kl_does_not_corrupt_tilt_series():
    """kl_divergence must not mutate the stored sinogram (the reference
    C++ engine normalizes b in place, silently rescaling every later
    algorithm run — tomoengine.cpp:245; we keep b intact and rescale the
    reconstruction back to data units)."""
    ts, ph = _series()
    tomo = TomoTPU(ANGLES, ts * 50.0)  # data units >> 1
    b_before = np.asarray(tomo.b).copy()
    tomo.kl_divergence(Niter=20, lambda_param=0.3)
    np.testing.assert_array_equal(np.asarray(tomo.b), b_before)
    # reconstruction comes back in data units (amplitude ~50x phantom)
    kl_max = tomo.get_recon().max()
    assert kl_max > 1.0, kl_max
    # a subsequent SIRT run is unaffected
    tomo.sirt(Niter=30, show_convergence=False)
    rel = np.abs(tomo.get_recon() - 50 * ph).mean() / (50 * np.abs(ph).mean())
    assert rel < 0.5, rel


def test_asd_pocs_api():
    ts, _ = _series()
    tomo = TomoTPU(ANGLES, ts)
    tomo.asd_pocs(Niter=6, nTViter=3)
    assert tomo.dd_vec[-1] < tomo.dd_vec[0]
    assert (tomo.tv_vec > 0).all()


def test_simulator_with_noise():
    vol = np.stack([shepp_logan(N)] * 2)
    sim = Simulator(vol, ANGLES, snr=200)
    sim.sirt(Niter=15, show_convergence=False)
    assert sim.rmse() < 0.25
    # noise actually applied: projections differ from clean FP
    clean = Simulator(vol, ANGLES, snr=0)
    assert not np.allclose(sim.get_projections(), clean.get_projections())


def test_mesh_api_matches_single_device():
    ts, _ = _series()
    ref = TomoTPU(ANGLES, ts)
    ref.sirt(Niter=5, show_convergence=False)
    mesh = tomojax.dist.make_mesh(4) if hasattr(tomojax, "dist") else None
    from tomojax import dist

    tomo = TomoTPU(ANGLES, ts, mesh=dist.make_mesh(4))
    tomo.sirt(Niter=5, show_convergence=False)
    np.testing.assert_allclose(
        tomo.get_recon(), ref.get_recon(), atol=1e-5
    )


def test_angle_count_mismatch_raises():
    ts, _ = _series()
    with pytest.raises(AssertionError):
        TomoTPU(ANGLES[:-2], ts)


def test_chemical_tomo_api():
    yy, xx = np.mgrid[0:N, 0:N]
    e1 = ((xx - 10) ** 2 + (yy - 16) ** 2 < 36).astype(np.float32)
    e2 = ((xx - 22) ** 2 + (yy - 16) ** 2 < 25).astype(np.float32)
    gt = np.stack([np.stack([e1] * 2), np.stack([e2] * 2)])  # (2, 2, N, N)
    chem_ang = np.linspace(-60, 60, 9)
    haadf_ang = np.linspace(-70, 70, 30)

    from tomojax.fusion import make_fusion_system, weights_for_elements, fp4d, model_haadf

    w = weights_for_elements(["c", "au"], 1.6, 3)
    fsys = make_fusion_system(
        N, np.deg2rad(haadf_ang), np.deg2rad(chem_ang), w, 1.6
    )
    b_chem = np.asarray(fp4d(jnp.asarray(gt), fsys.chem))
    h = model_haadf(jnp.asarray(gt), fsys)
    b_haadf = np.asarray(fp(h, fsys.haadf.geom))

    # assemble reference-layout inputs: (Nslice, Nray, Nangles)
    haadf_in = np.transpose(b_haadf, (0, 2, 1))
    chem_in = {
        "C": np.transpose(b_chem[0], (0, 2, 1)),
        "Au": np.transpose(b_chem[1], (0, 2, 1)),
    }
    ct = ChemicalTomo(haadf_in, haadf_ang, chem_in, chem_ang)
    ct.chemical_tomography(Niter=15, lambdaCHEM=0.2, show_convergence=False)
    assert ct.costCHEM[-1] < ct.costCHEM[0]
    ct.data_fusion(Niter=5, show_convergence=False)
    rec = ct.get_recon()
    assert rec.shape == (2, 2, N, N)
    assert np.isfinite(rec).all()
    per = ct.rmse_per_element(np.zeros_like(rec))
    assert per.shape == (2,)


def test_update_projection_angles():
    """TomoTPU dynamic angle growth (tomoengine.cpp:130-149): re-binds
    geometry + data, keeps the reconstruction as a warm start, and the
    next solve runs on the grown angle set."""
    from tomojax.sim import shepp_logan, create_projections
    from tomojax.geometry import Geometry

    n, ns = 32, 2
    gt = np.stack([shepp_logan(n)] * ns).astype(np.float32)
    a1 = np.linspace(-60, 60, 8)
    g1 = Geometry.make(n, np.deg2rad(a1))
    b1 = np.asarray(create_projections(gt, g1))
    tomo = TomoTPU(a1, np.transpose(b1, (0, 2, 1)))
    tomo.sirt(5, show_convergence=False)
    x_warm = tomo.x

    a2 = np.linspace(-60, 60, 12)
    g2 = Geometry.make(n, np.deg2rad(a2))
    b2 = np.asarray(create_projections(gt, g2))
    tomo.update_projection_angles(a2, np.transpose(b2, (0, 2, 1)))
    assert tomo.Nangles == 12
    assert np.shares_memory(np.asarray(tomo.x), np.asarray(x_warm)) or bool(
        jnp.all(tomo.x == x_warm)
    )
    d0 = tomo.data_distance()
    tomo.x = tomo.x  # keep warm start; run more iterations manually
    from tomojax.solvers import sirt_sweep
    import jax

    step = jax.jit(lambda x, b: sirt_sweep(x, b, tomo.sys, 1))
    for _ in range(5):
        tomo.x = step(tomo.x, tomo.b)
    assert tomo.data_distance() < d0


def test_mesh_scope_is_per_object_not_global():
    """Regression for the set_mesh footgun: constructing a second
    (differently-meshed) reconstructor must not re-route the first
    object's kernel dispatch, and construction must not leak a
    process-global mesh registration (round-2 VERDICT: api.py set_mesh
    at ctor time was last-constructed-wins)."""
    from tomojax import config as tjconfig, dist

    ts, _ = _series()
    mesh4 = dist.make_mesh(4)
    a = TomoTPU(ANGLES, ts, mesh=mesh4)
    assert tjconfig.active_mesh is None  # no global registration leak

    # second object with a different (singleton) mesh
    b = TomoTPU(ANGLES, ts, mesh=dist.make_mesh(1))
    assert tjconfig.active_mesh is None

    # observe the mesh each object's solver actually traces under
    import tomojax.api as apimod

    seen = []
    real_sweep = apimod.sirt_sweep

    def spy(*args, **kwargs):
        seen.append(tjconfig.active_mesh)
        return real_sweep(*args, **kwargs)

    apimod.sirt_sweep = spy
    try:
        a.sirt(Niter=1, show_convergence=False)
        b.sirt(Niter=1, show_convergence=False)
        a.sirt(Niter=1, show_convergence=False)  # after b: still mesh4
    finally:
        apimod.sirt_sweep = real_sweep
    assert seen[0] is mesh4
    assert seen[1] is b.mesh
    assert seen[2] is mesh4
    assert tjconfig.active_mesh is None


def test_mesh_scope_nesting_restores():
    from tomojax import config as tjconfig, dist

    m1, m2 = dist.make_mesh(2), dist.make_mesh(4)
    assert tjconfig.active_mesh is None
    with tjconfig.mesh_scope(m1):
        assert tjconfig.active_mesh is m1
        with tjconfig.mesh_scope(m2):
            assert tjconfig.active_mesh is m2
        assert tjconfig.active_mesh is m1
    assert tjconfig.active_mesh is None


def test_fista_fused_matches_host_loop():
    """fista(fused=True) — the scanned one-program driver — matches the
    host-loop driver (pod-production shape through the public API)."""
    ts, _ = _series()
    a = TomoTPU(ANGLES, ts)
    a.fista(Niter=5, lambda_param=0.01)
    b = TomoTPU(ANGLES, ts)
    b.fista(Niter=5, lambda_param=0.01, fused=True)
    np.testing.assert_allclose(b.get_recon(), a.get_recon(),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.cost, a.cost, rtol=1e-4)


def test_asd_pocs_fused_matches_host_loop():
    ts, _ = _series()
    a = TomoTPU(ANGLES, ts)
    a.asd_pocs(Niter=4, nTViter=3)
    b = TomoTPU(ANGLES, ts)
    b.asd_pocs(Niter=4, nTViter=3, fused=True)
    np.testing.assert_allclose(b.get_recon(), a.get_recon(), atol=2e-3)
    np.testing.assert_allclose(b.dd_vec, a.dd_vec, rtol=1e-3)


def test_fista_fused_respects_strict_config(monkeypatch):
    """fista(fused=True) traces the projector the user configured: with
    projector mode 'gather' forced, the fused driver must run the gather
    form, not the platform's default family."""
    from tomojax import config as tjconfig
    from tomojax.projector import joseph

    ts, _ = _series()
    called = {"gather": 0, "mxu": 0}
    for name, key in (("_fp_branch", "gather"), ("_fp_branch_mxu", "mxu")):
        real = getattr(joseph, name)

        def spy(*a, _real=real, _key=key, **k):
            called[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(joseph, name, spy)
    try:
        tjconfig.set_projector_mode("gather")
        t = TomoTPU(ANGLES, ts, mesh=None)
        t.mesh = None  # force the meshless branch even on the 8-dev env
        t.fista(Niter=2, lambda_param=0.01, fused=True)
    finally:
        tjconfig.set_projector_mode("auto")
    assert called["gather"] > 0 and called["mxu"] == 0
    assert np.isfinite(t.cost).all()


def test_chemical_tomo_data_fusion_fused():
    """ChemicalTomo.data_fusion(fused=True) (the scanned outer loop incl.
    the adaptive lambda decay) matches the host-loop driver."""
    yy, xx = np.mgrid[0:N, 0:N]
    e1 = ((xx - 10) ** 2 + (yy - 16) ** 2 < 36).astype(np.float32)
    e2 = ((xx - 22) ** 2 + (yy - 16) ** 2 < 25).astype(np.float32)
    gt = np.stack([np.stack([e1] * 2), np.stack([e2] * 2)])
    chem_ang = np.linspace(-60, 60, 9)
    haadf_ang = np.linspace(-70, 70, 30)
    from tomojax.fusion import make_fusion_system, weights_for_elements, fp4d, model_haadf

    w = weights_for_elements(["c", "au"], 1.6, 3)
    fsys = make_fusion_system(
        N, np.deg2rad(haadf_ang), np.deg2rad(chem_ang), w, 1.6
    )
    b_chem = np.asarray(fp4d(jnp.asarray(gt), fsys.chem))
    b_haadf = np.asarray(fp(model_haadf(jnp.asarray(gt), fsys), fsys.haadf.geom))
    kwargs = dict(
        haadf=np.transpose(b_haadf, (0, 2, 1)),
        haadfTiltAngles=haadf_ang,
        chem={"C": np.transpose(b_chem[0], (0, 2, 1)),
              "Au": np.transpose(b_chem[1], (0, 2, 1))},
        chemTiltAngles=chem_ang,
    )
    a = ChemicalTomo(**kwargs)
    a.chemical_tomography(Niter=8, lambdaCHEM=0.2, show_convergence=False)
    a.data_fusion(Niter=4, lambdaCHEM=0.05, lambdaHAADF=0.02,
                  iterSIRT=2, tvIter=3, show_convergence=False)
    b = ChemicalTomo(**kwargs)
    b.chemical_tomography(Niter=8, lambdaCHEM=0.2, show_convergence=False)
    b.data_fusion(Niter=4, lambdaCHEM=0.05, lambdaHAADF=0.02,
                  iterSIRT=2, tvIter=3, show_convergence=False, fused=True)
    np.testing.assert_allclose(b.get_recon(), a.get_recon(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.costHAADF, a.costHAADF, rtol=1e-4)
