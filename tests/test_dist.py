"""Distributed correctness on the 8-device virtual CPU mesh (SURVEY.md §4):
sharded-vs-unsharded equality of solver steps, TV halo exchange across
slab boundaries, psum'd metrics, and sharded FISTA."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from tomojax.geometry import Geometry
from tomojax import dist, ops
from tomojax import tv as tvmod
from tomojax.solvers import make_system, sirt_sweep, fista_init, fista_step
from tomojax.sim import shepp_logan, create_projections

NS, N = 16, 32  # 16 slices over 8 devices = 2-slice slabs


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    return dist.make_mesh(8)


@pytest.fixture(scope="module")
def problem():
    angles = np.deg2rad(np.linspace(-70, 70, 20))
    geom = Geometry.make(N, angles)
    sysd = make_system(geom)
    ph = np.stack([shepp_logan(N) * (0.5 + i / NS) for i in range(NS)])
    b = create_projections(ph, geom)
    return geom, sysd, jnp.asarray(ph), b


def test_mesh_shape(mesh):
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("z",)


def test_sharded_sirt_matches_unsharded(mesh, problem):
    geom, sysd, ph, b = problem
    x0 = jnp.zeros((NS, N, N))
    ref = sirt_sweep(x0, b, sysd, 3)

    xs = dist.shard_volume(x0, mesh)
    bs = dist.shard_volume(b, mesh)
    step = jax.jit(lambda x, b: sirt_sweep(x, b, sysd, 3))
    got = step(xs, bs)
    # output keeps the slab sharding (batch axis)
    assert got.sharding.is_equivalent_to(
        NamedSharding(mesh, P("z", None, None)), 3
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)


def test_sharded_tv_halo(mesh, problem):
    """TV stencils cross slab boundaries: jnp.roll over the sharded axis
    must produce the identical result (XLA inserts the halo permute)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (NS, N, N)).astype(np.float32)
    ref_val = float(tvmod.tv(jnp.asarray(x)))
    ref_gd, _ = tvmod.tv_gd(jnp.asarray(x), 5, 0.3)
    ref_fgp, _ = tvmod.tv_fgp(jnp.asarray(x), 5, 0.1)

    xs = dist.shard_volume(jnp.asarray(x), mesh)
    got_val = float(jax.jit(tvmod.tv)(xs))
    got_gd, _ = jax.jit(lambda v: tvmod.tv_gd(v, 5, 0.3))(xs)
    got_fgp, _ = jax.jit(lambda v: tvmod.tv_fgp(v, 5, 0.1))(xs)

    assert np.isclose(got_val, ref_val, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got_gd), np.asarray(ref_gd), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_fgp), np.asarray(ref_fgp), atol=1e-5)


def test_sharded_metrics(mesh, problem):
    geom, sysd, ph, b = problem
    xs = dist.shard_volume(ph, mesh)
    ps = dist.shard_volume(b, mesh)
    got = float(jax.jit(ops.rmse)(xs, dist.shard_volume(ph * 0.5, mesh)))
    ref = float(ops.rmse(ph, ph * 0.5))
    assert np.isclose(got, ref, rtol=1e-5)
    got_dd = float(jax.jit(ops.data_distance)(ps, ps * 0.9))
    ref_dd = float(ops.data_distance(b, b * 0.9))
    assert np.isclose(got_dd, ref_dd, rtol=1e-5)


def test_sharded_fista_step(mesh, problem):
    geom, sysd, ph, b = problem
    st_ref = fista_init(jnp.zeros((NS, N, N)), sysd)
    st_ref, m_ref = fista_step(st_ref, b, sysd, 0.01, 5, True)

    st = fista_init(dist.shard_volume(jnp.zeros((NS, N, N)), mesh), sysd)
    bs = dist.shard_volume(b, mesh)
    step = jax.jit(lambda st, b: fista_step(st, b, sysd, 0.01, 5, True))
    st, m = step(st, bs)
    np.testing.assert_allclose(np.asarray(st.x), np.asarray(st_ref.x), atol=1e-5)
    assert np.isclose(float(m[0]), float(m_ref[0]), rtol=1e-4)


def test_sharded_fusion_4d(mesh):
    """Chemistry 4D state sharded on the slice axis (axis 1): fused step
    and 4D TV match the unsharded run (the reference's multigpufusion
    OpenMP path, multigpufusion.cpp:162-226, subsumed by the mesh)."""
    from jax.sharding import NamedSharding
    from tomojax.fusion import (
        make_fusion_system, weights_for_elements, fp4d, model_haadf,
        data_fusion_step, poisson_ml_step_4d,
    )
    from tomojax.projector.joseph import fp as _fp
    from tomojax import tv as tvmod

    n = 24
    rng = np.random.default_rng(3)
    gt = jnp.asarray(rng.uniform(0, 1, (2, NS, n, n)), jnp.float32)
    w = weights_for_elements(["c", "zn"], 1.6, 3)
    fsys = make_fusion_system(
        n, np.deg2rad(np.linspace(-70, 70, 10)),
        np.deg2rad(np.linspace(-60, 60, 5)), w, 1.6,
    )
    b_chem = fp4d(gt, fsys.chem)
    b_h = _fp(model_haadf(gt, fsys), fsys.haadf.geom)

    x0 = jnp.zeros_like(gt)
    ref, ch_ref, cc_ref = data_fusion_step(x0, b_h, b_chem, fsys, 0.5, 0.05, 2)
    ref_p, cost_ref = poisson_ml_step_4d(x0, b_chem, fsys, 0.2)
    ref_tv, _ = tvmod.tv_fgp_4d(gt, 3, 0.1)

    sh4 = NamedSharding(mesh, P(None, "z", None, None))
    xs = jax.device_put(x0, sh4)
    bcs = jax.device_put(b_chem, sh4)
    bhs = dist.shard_volume(b_h, mesh)
    got, ch, cc = jax.jit(
        lambda x, bh, bc: data_fusion_step(x, bh, bc, fsys, 0.5, 0.05, 2)
    )(xs, bhs, bcs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)
    assert np.isclose(float(ch), float(ch_ref), rtol=1e-4)
    got_p, cost = jax.jit(
        lambda x, bc: poisson_ml_step_4d(x, bc, fsys, 0.2)
    )(xs, bcs)
    np.testing.assert_allclose(np.asarray(got_p), np.asarray(ref_p), atol=1e-5)
    got_tv, _ = jax.jit(lambda v: tvmod.tv_fgp_4d(v, 3, 0.1))(
        jax.device_put(gt, sh4)
    )
    np.testing.assert_allclose(np.asarray(got_tv), np.asarray(ref_tv), atol=1e-5)


def test_chemical_tomo_mesh_uneven(mesh):
    """ChemicalTomo on a mesh with a slice count NOT divisible by the mesh
    (regression: the mesh path lacked the pad_slices step)."""
    from tomojax import ChemicalTomo
    from tomojax.fusion import (
        make_fusion_system, weights_for_elements, fp4d, model_haadf,
    )
    from tomojax.projector.joseph import fp as _fp

    n, ns = 24, 6  # 6 slices over 8 devices -> padding required
    rng = np.random.default_rng(5)
    gt = jnp.asarray(rng.uniform(0, 1, (2, ns, n, n)), jnp.float32)
    w = weights_for_elements(["c", "zn"], 1.6, 3)
    fsys = make_fusion_system(
        n, np.deg2rad(np.linspace(-70, 70, 10)),
        np.deg2rad(np.linspace(-60, 60, 5)), w, 1.6,
    )
    b_chem = np.asarray(fp4d(gt, fsys.chem))
    b_h = np.asarray(_fp(model_haadf(gt, fsys), fsys.haadf.geom))
    ct = ChemicalTomo(
        np.transpose(b_h, (0, 2, 1)), np.linspace(-70, 70, 10),
        {"C": np.transpose(b_chem[0], (0, 2, 1)),
         "Zn": np.transpose(b_chem[1], (0, 2, 1))},
        np.linspace(-60, 60, 5), mesh=mesh,
    )
    ct.chemical_tomography(Niter=5, lambdaCHEM=0.2, show_convergence=False)
    rec = ct.get_recon()
    assert rec.shape == (2, ns, n, n)  # unpadded on the way out
    assert np.isfinite(rec).all()
    per = ct.rmse_per_element(np.zeros((2, ns, n, n), np.float32))
    assert per.shape == (2,)


def test_uneven_slab_split(mesh):
    """Ns not divisible by n_devices: pad_slices makes it shardable and
    results match the unsharded run on the same padded volume (the
    reference instead spreads the remainder, mpi_astra_ctvlib.cpp:53-58)."""
    ns = 11
    x = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (ns, N, N)), jnp.float32)
    xp, orig = dist.pad_slices(x, mesh)
    assert orig == ns and xp.shape[0] == 16
    xs = dist.shard_volume(xp, mesh)
    got = float(jax.jit(tvmod.tv)(xs))
    assert np.isclose(got, float(tvmod.tv(xp)), rtol=1e-5)
    back = dist.unpad_slices(xs, orig)
    np.testing.assert_allclose(np.asarray(back), np.asarray(x))


def test_sharded_fusion_4d_sart(mesh):
    """SART-method fusion step sharded on the slice axis matches the
    unsharded run (mirrors test_sharded_fusion_4d for the
    call_sart_data_fusion path, multimodal.hpp:149). The ordered
    per-angle SART sweep is a lax.scan of per-angle contractions —
    must lower cleanly under slab sharding too."""
    from jax.sharding import NamedSharding
    from tomojax.fusion import (
        make_fusion_system, weights_for_elements, fp4d, model_haadf,
        data_fusion_step,
    )
    from tomojax.solvers import make_sart_weights
    from tomojax.projector.joseph import fp as _fp

    n = 24
    rng = np.random.default_rng(4)
    gt = jnp.asarray(rng.uniform(0, 1, (2, NS, n, n)), jnp.float32)
    w = weights_for_elements(["c", "zn"], 1.6, 3)
    fsys = make_fusion_system(
        n, np.deg2rad(np.linspace(-70, 70, 10)),
        np.deg2rad(np.linspace(-60, 60, 5)), w, 1.6,
    )
    b_chem = fp4d(gt, fsys.chem)
    b_h = _fp(model_haadf(gt, fsys), fsys.haadf.geom)
    sart_w = make_sart_weights(fsys.haadf)

    x0 = jnp.zeros_like(gt)
    ref, ch_ref, cc_ref = data_fusion_step(
        x0, b_h, b_chem, fsys, 0.5, 0.05, 2, method="sart",
        sart_weights=sart_w,
    )

    sh4 = NamedSharding(mesh, P(None, "z", None, None))
    got, ch, cc = jax.jit(
        lambda x, bh, bc: data_fusion_step(
            x, bh, bc, fsys, 0.5, 0.05, 2, method="sart",
            sart_weights=sart_w,
        )
    )(jax.device_put(x0, sh4), dist.shard_volume(b_h, mesh),
      jax.device_put(b_chem, sh4))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-5)
    assert np.isclose(float(ch), float(ch_ref), rtol=1e-4)
    assert np.isclose(float(cc), float(cc_ref), rtol=1e-4)


@pytest.mark.parametrize("iters", [1, 4, 7])
def test_sharded_fgp_matches_unsharded(mesh, iters):
    """FGP on a slab-sharded volume: the slice/concat stencils partition
    into halo collective-permutes (the reference's MPI halo ring,
    mpi_astra_ctvlib.cpp:360-386) and reproduce the unsharded result."""
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.normal(size=(16, 16, 16)).astype(np.float32)) + 0.5
    ref, tv_ref = tvmod.tv_fgp(x, iters, 0.2)
    got, tv_got = jax.jit(lambda v: tvmod.tv_fgp(v, iters, 0.2))(
        dist.shard_volume(x, mesh))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    assert np.isclose(float(tv_got), float(tv_ref), rtol=1e-5)


@pytest.mark.parametrize("field", ["random", "wrap_seam"])
def test_sharded_tv_gd_matches_unsharded(mesh, field):
    """TV-GD on a slab-sharded volume: periodic halo ring across the slabs
    and a global norm (the documented deviation, SURVEY.md §3.3). The
    wrap-seam field jumps between planes nz-1 and 0, so a wrong halo
    would show."""
    if field == "random":
        rng = np.random.default_rng(11)
        x = rng.normal(size=(16, 16, 16)).astype(np.float32) + 0.5
    else:
        x = np.ones((16, 8, 8), np.float32)
        x[0], x[-1] = 4.0, -2.0
    x = jnp.asarray(x)
    ref, tv_ref = tvmod.tv_gd(x, 5, 0.07)
    got, tv_got = jax.jit(lambda v: tvmod.tv_gd(v, 5, 0.07))(
        dist.shard_volume(x, mesh))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    assert np.isclose(float(tv_got), float(tv_ref), rtol=1e-5)


def test_sharded_4d_tv_matches_unsharded(mesh):
    """4D chemistry TV (FGP + GD) sharded on the slice axis (axis 1)
    matches the unsharded run (reference multi-GPU per-element 4D TV,
    chemistry tv_fgp.cu:192-287 / multigpufusion.cpp)."""
    rng = np.random.default_rng(14)
    x = jnp.asarray(rng.normal(size=(3, 16, 16, 16)).astype(np.float32)) + 0.5
    ref_f, tvf = tvmod.tv_fgp_4d(x, 4, 0.15)
    ref_g, tvg = tvmod.tv_gd_4d(x, 4, 0.05)
    xs = jax.device_put(x, NamedSharding(mesh, P(None, "z", None, None)))
    got_f, tvf2 = jax.jit(lambda v: tvmod.tv_fgp_4d(v, 4, 0.15))(xs)
    got_g, tvg2 = jax.jit(lambda v: tvmod.tv_gd_4d(v, 4, 0.05))(xs)
    np.testing.assert_allclose(np.asarray(got_f), np.asarray(ref_f),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got_g), np.asarray(ref_g),
                               rtol=1e-5, atol=1e-6)
    assert np.isclose(float(tvf2), float(tvf), rtol=1e-5)
    assert np.isclose(float(tvg2), float(tvg), rtol=1e-5)


def test_sharded_fista_run_matches_unsharded(mesh, problem):
    """`fista_run` (the one scanned FISTA driver) under a mesh scope on
    slab-sharded data == the unsharded host-loop steps; the state keeps
    the slab sharding."""
    from tomojax import config as tjconfig
    from tomojax.solvers import fista_run

    geom, sysd, gt, b = problem
    ref_st = fista_init(jnp.zeros_like(gt), sysd)
    step_ref = jax.jit(lambda s, bb: fista_step(s, bb, sysd, 0.1, 4, True))
    ref_metrics = []
    for _ in range(3):
        ref_st, m = step_ref(ref_st, b)
        ref_metrics.append([float(v) for v in m])
    with tjconfig.mesh_scope(mesh):
        bs = dist.shard_volume(b, mesh)
        st = fista_init(dist.shard_volume(jnp.zeros_like(gt), mesh), sysd)
        st, metrics = jax.jit(
            lambda s, bb: fista_run(s, bb, sysd, 0.1, 3, 4, True))(st, bs)
    assert st.x.sharding.is_equivalent_to(
        NamedSharding(mesh, P("z", None, None)), 3)
    np.testing.assert_allclose(np.asarray(st.x), np.asarray(ref_st.x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(metrics), np.asarray(ref_metrics),
                               rtol=1e-4)


def test_sharded_asd_pocs_matches_unsharded(mesh, problem):
    """Sharded ASD-POCS (SART sweep + TV-GD halo ring + psum'd metrics,
    the reference's flagship MPI workload, mpi_ctvlib.cpp:495-558)
    matches the unsharded run."""
    from tomojax import config as tjconfig
    from tomojax.solvers import make_asd_pocs_iteration, make_sart_weights

    geom, sysd, gt, b = problem
    sart_w = make_sart_weights(sysd)
    order = jnp.arange(geom.nproj, dtype=jnp.int32)

    def drive(run, x, bb):
        beta, dpocs = 0.25, 0.0
        dds = []
        for i in range(3):
            x, dp, dd, dg, tv0, dpocs_eff = run(
                x, bb, beta, dpocs, order, i == 0, 0.2
            )
            beta *= 0.9985
            dpocs = float(dpocs_eff)
            dds.append(float(dd))
            if float(dg) > 0.95 * float(dp) and float(dd) > 0.025:
                dpocs *= 0.95
        return x, dds

    x_ref, dd_ref = drive(make_asd_pocs_iteration(sysd, sart_w, ng=4),
                          jnp.zeros_like(gt), b)
    with tjconfig.mesh_scope(mesh):
        x, dd = drive(make_asd_pocs_iteration(sysd, sart_w, ng=4),
                      dist.shard_volume(jnp.zeros_like(gt), mesh),
                      dist.shard_volume(b, mesh))
    # the normalized TV subgradient divides by ~sqrt(EPS_TV) in flat
    # regions, so reduction-order differences grow through the descent
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref), atol=2e-3)
    np.testing.assert_allclose(dd, dd_ref, rtol=1e-3)


def test_tv_gd_reference_mpi_compat(mesh):
    """Round-4 VERDICT #5: tv_gd(compat='reference-mpi') reproduces the
    reference's multi-rank semantics — every shard descends its slab as
    an independent local-periodic volume normalized by its LOCAL
    gradient norm (tv_gd.cu:56-79,194-197 with nx=Nslice_loc,
    mpi_astra_ctvlib.cpp:411) — so the result is shard-count-DEPENDENT,
    unlike the default global-psum mode (the documented deviation,
    SURVEY.md §3.3)."""
    from tomojax import config as tjconfig

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.random((16, 32, 32), dtype=np.float32))
    ng, dpocs = 5, 0.05
    out_g, tv_g = tvmod.tv_gd(x, ng, dpocs)

    with tjconfig.mesh_scope(mesh):
        xs = dist.shard_volume(x, mesh)
        out_c, tv_c = jax.jit(
            lambda v: tvmod.tv_gd(v, ng, dpocs, compat="reference-mpi")
        )(xs)

    # shard-count dependence: 8 independent slabs differ from the
    # globally-normalized (and globally-periodic) descent
    assert not np.allclose(np.asarray(out_c), np.asarray(out_g), atol=1e-5)

    # exact model: per-slab independent tv_gd (slab-local periodic wrap
    # and slab-local norm == the unsharded call on each slab alone)
    nsh = mesh.size
    sl = 16 // nsh
    slabs, tvs = [], []
    for i in range(nsh):
        o, t = tvmod.tv_gd(x[i * sl:(i + 1) * sl], ng, dpocs)
        slabs.append(np.asarray(o))
        tvs.append(float(t))
    np.testing.assert_allclose(
        np.asarray(out_c), np.concatenate(slabs), rtol=1e-5, atol=1e-6
    )
    # returned TV value: allreduced sum of the local-periodic slab TVs
    assert float(tv_c) == pytest.approx(sum(tvs), rel=1e-5)

    # no mesh in scope: compat mode degenerates to the default
    out_1, tv_1 = tvmod.tv_gd(x, ng, dpocs, compat="reference-mpi")
    np.testing.assert_allclose(np.asarray(out_1), np.asarray(out_g),
                               atol=1e-6)
