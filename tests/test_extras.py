"""Tests for auxiliary modules: TV extras (Chambolle / Split-Bregman),
pytvlib compat layer, profiling meters, viz smoke, streaming CS rounds."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tomojax import tv as tvmod
from tomojax.tv.extras import tv_chambolle, tv_split_bregman
from tomojax import pytvlib, profiling


def _noisy_blocks(seed=0):
    rng = np.random.default_rng(seed)
    clean = np.zeros((8, 16, 16), np.float32)
    clean[:, 4:12, 4:12] = 1.0
    noisy = clean + 0.2 * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy


@pytest.mark.parametrize("fn,kw", [
    (tv_chambolle, dict(n_iter=30, lam=0.15)),
    (tv_split_bregman, dict(n_iter=10, lam=0.15)),
])
def test_extra_denoisers(fn, kw):
    clean, noisy = _noisy_blocks()
    den, tv0 = fn(jnp.asarray(noisy), **kw)
    assert np.isclose(float(tv0), float(tvmod.tv(jnp.asarray(noisy))), rtol=1e-5)
    # reduces TV and moves toward the clean signal
    assert float(tvmod.tv(den)) < float(tv0)
    err_before = np.sqrt(np.mean((noisy - clean) ** 2))
    err_after = np.sqrt(np.mean((np.asarray(den) - clean) ** 2))
    assert err_after < err_before


def test_pytvlib_dispatch():
    from tomojax import TomoTPU
    from tomojax.sim import shepp_logan
    from tomojax.geometry import Geometry
    from tomojax.projector.joseph import fp

    n = 32
    angles = np.linspace(-60, 60, 15)
    geom = Geometry.make(n, np.deg2rad(angles))
    ph = np.stack([shepp_logan(n)] * 2)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    tomo = TomoTPU(angles, np.transpose(b, (0, 2, 1)))

    pytvlib.initialize_algorithm(tomo, "SIRT")
    pytvlib.run(tomo, "SIRT", niter=5)
    assert tomo.get_recon().shape == (2, n, n)

    pytvlib.initialize_algorithm(tomo, "FBP", "hamming")
    pytvlib.run(tomo, "FBP")

    # every alias the table accepts must be runnable
    pytvlib.initialize_algorithm(tomo, "cimminoSIRT")
    pytvlib.run(tomo, "cimminoSIRT", niter=2)
    pytvlib.initialize_algorithm(tomo, "ART")
    pytvlib.run(tomo, "ART", beta=0.5, niter=1)
    pytvlib.initialize_algorithm(tomo, "randART")
    pytvlib.run(tomo, "randART", beta=0.5, niter=1)
    pytvlib.initialize_algorithm(tomo, "asd-pocs")
    pytvlib.run(tomo, "asd-pocs", beta=0.25, niter=2)

    with pytest.raises(ValueError):
        pytvlib.initialize_algorithm(tomo, "quantum-annealing")

    assert "ram-lak" in pytvlib.wbp_filters()
    assert pytvlib.sart_orders() == ["sequential", "random"]
    assert len(pytvlib.check_devices()) >= 1


def test_iteration_meter():
    m = profiling.IterationMeter(voxels=1000, name="test").start()
    import time

    for _ in range(3):
        time.sleep(0.01)
        m.lap()
    assert len(m.times) == 3
    assert m.mean_s > 0.005
    assert "Mvoxel" in m.summary()


def test_live_monitor(tmp_path):
    from tomojax import viz

    mon = viz.LiveMonitor(str(tmp_path / "live.png"), eps=0.1)
    recon = np.random.default_rng(0).uniform(0, 1, (4, 16, 16))
    p = mon.update(recon, [3.0, 2.0, 1.0], sinogram=np.ones((5, 16)),
                   tv_history=[10.0, 9.0])
    assert (tmp_path / "live.png").exists()


def test_volume_viewer_interactive(tmp_path):
    """show_volume(interactive=True): slider-driven 3-plane viewer
    (Tk-viewer parity, round-3 VERDICT #9) — scrubbing a slider updates
    the displayed plane, set_volume live-swaps data, save writes."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from tomojax import viz

    vol = np.zeros((6, 16, 16), np.float32)
    vol[4] = 1.0  # marker slice
    v = viz.show_volume(vol, path=str(tmp_path / "v.png"), interactive=True)
    assert (tmp_path / "v.png").exists()
    assert v.ims[0].get_array().max() == 0.0  # central slice 3 is empty
    v.set_slices(xy=4)
    assert v.ims[0].get_array().max() == 1.0  # scrubbed to the marker
    assert v.idx[0] == 4
    v.set_slices(xz=2, yz=7)
    assert v.idx == [4, 2, 7]
    v.set_volume(vol * 2)
    assert v.ims[0].get_array().max() == 2.0
    v.save(str(tmp_path / "v2.png"))
    assert (tmp_path / "v2.png").exists()


def test_dynamic_cs_round(tmp_path):
    from tomojax.geometry import Geometry
    from tomojax.projector.joseph import fp
    from tomojax.sim import shepp_logan
    from tomojax.stream import DynamicReconstructor

    n = 32
    angles = np.linspace(-60, 60, 8)
    geom = Geometry.make(n, np.deg2rad(angles))
    ph = np.stack([shepp_logan(n)] * 2)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    rec = DynamicReconstructor(nray=n, max_angles=8, angle_bucket=4)
    rec.add_projections([(a, b[:, i, :]) for i, a in enumerate(angles)])
    dd1 = rec.iterate_cs(8, ng=3)
    dd2 = rec.iterate_cs(8, ng=3)
    assert dd2 < dd1
    assert float(jnp.min(rec.x)) >= 0.0
