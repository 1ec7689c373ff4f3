"""Dynamic/streaming reconstruction tests: the watcher picks up files as
they appear, the operator grows, dd decreases, checkpoint/resume works
(reference cpu/dynamicTomo.py:66-104 + logger.py behavior)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from tomojax.geometry import Geometry
from tomojax.projector.joseph import fp
from tomojax.sim import shepp_logan
from tomojax.stream import (
    TiltWatcher,
    DynamicReconstructor,
    parse_angle_from_name,
    background_subtract,
    center_of_mass_align,
)

N, NS = 32, 2


def test_parse_angle():
    assert parse_angle_from_name("proj_-42.5.npy") == -42.5
    assert parse_angle_from_name("a/b/tilt_10.0deg.h5") == 10.0
    with pytest.raises(ValueError):
        parse_angle_from_name("nonsense.npy")


def test_preprocess():
    img = np.full((20, 20), 2.0, np.float32)
    img[10:, 10:] += 5
    out = background_subtract(img)
    assert out[:5, :5].max() == 0.0
    com = center_of_mass_align(out)
    assert com.shape == img.shape
    ys, xs = np.nonzero(com > 1)
    assert abs(ys.mean() - 9.5) < 3 and abs(xs.mean() - 9.5) < 3


def _write_projs(tmp_path, angles_deg, b):
    """b: (Ns, Na, Nt) -> per-angle files (Ns, Nt)."""
    paths = []
    for i, a in enumerate(angles_deg):
        p = str(tmp_path / f"proj_{a:.1f}.npy")
        np.save(p, np.asarray(b[:, i, :]))
        paths.append(p)
    return paths


def test_watcher_and_dynamic_recon(tmp_path):
    angles = np.linspace(-60, 60, 16)
    geom = Geometry.make(N, np.deg2rad(angles))
    ph = np.stack([shepp_logan(N)] * NS)
    b = np.asarray(fp(jnp.asarray(ph), geom))

    datadir = tmp_path / "stream"
    datadir.mkdir()
    watcher = TiltWatcher(str(datadir), preprocess=False)
    rec = DynamicReconstructor(
        nray=N, max_angles=16, angle_bucket=8,
        checkpoint_path=str(tmp_path / "ckpt.h5"),
    )

    # first half of the angles arrive
    _write_projs(datadir, angles[:8], b[:, :8, :])
    new = watcher.poll()
    assert len(new) == 8
    rec.add_projections(new)
    dd1 = rec.iterate(10)
    assert np.isfinite(dd1)
    rec.checkpoint()

    # rest arrive -> operator grows (bucket 8 -> 16)
    _write_projs(datadir, angles[8:], b[:, 8:, :])
    new = watcher.poll()
    assert len(new) == 8
    rec.add_projections(new)
    dd2 = rec.iterate(10)
    dd3 = rec.iterate(10)
    assert dd3 < dd2  # keeps converging on the full set

    # final recon approximates the phantom
    x = np.asarray(rec.x)
    rm = np.sqrt(np.mean((x - np.asarray(ph)) ** 2))
    assert rm < 0.15, rm

    # resume path
    rec2 = DynamicReconstructor(
        nray=N, max_angles=16, checkpoint_path=str(tmp_path / "ckpt.h5")
    )
    assert rec2.resume()
    assert rec2.x.shape == (NS, N, N)
    assert len(rec2.dd_history) > 0


def test_dynamic_recon_sharded_matches_unsharded(tmp_path):
    """The composed distributed dynamic driver (round-3 VERDICT #1): the
    same 2-acquisition-round streaming reconstruction run z-slab-sharded
    over the 8-device virtual mesh produces the same dd history and
    volume as the unsharded run, and the sharded checkpoint (orbax
    shards + history sidecar) resumes in place."""
    from tomojax import dist

    angles = np.linspace(-60, 60, 16)
    geom = Geometry.make(N, np.deg2rad(angles))
    ns = 4  # pads to the 8-device mesh (zero-measurement slices)
    ph = np.stack([shepp_logan(N)] * ns)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    mesh = dist.make_mesh()

    recs = []
    for mesh_arg, tag in ((None, "plain"), (mesh, "sharded")):
        rec = DynamicReconstructor(
            nray=N, max_angles=16, angle_bucket=8, mesh=mesh_arg,
            checkpoint_path=str(tmp_path / f"ck_{tag}.h5"),
        )
        # acquisition round 1: first half of the angles
        rec.add_projections(
            [(a, b[:, i, :]) for i, a in enumerate(angles[:8])]
        )
        rec.iterate(5)
        rec.checkpoint()
        # round 2: operator grows (bucket 8 -> 16) while sharded
        rec.add_projections(
            [(a, b[:, 8 + i, :]) for i, a in enumerate(angles[8:])]
        )
        rec.iterate(5)
        rec.checkpoint()
        recs.append(rec)
    plain, sharded = recs
    assert sharded.x.shape[0] == 8  # slice axis padded to the mesh
    np.testing.assert_allclose(
        sharded.dd_history, plain.dd_history, rtol=2e-4
    )
    np.testing.assert_allclose(
        sharded.get_recon(), plain.get_recon(), rtol=2e-4, atol=2e-5
    )
    assert sharded.get_recon().shape == (ns, N, N)

    # sharded resume: volume comes back from the orbax shards
    rec2 = DynamicReconstructor(
        nray=N, max_angles=16, mesh=mesh,
        checkpoint_path=str(tmp_path / "ck_sharded.h5"),
    )
    assert rec2.resume()
    assert rec2.x.shape == sharded.x.shape
    np.testing.assert_allclose(
        rec2.get_recon(), sharded.get_recon(), atol=1e-6
    )
    np.testing.assert_allclose(rec2.dd_history, sharded.dd_history)


def test_dynamic_recon_sharded_cs(tmp_path):
    """The CS (ASD-POCS-style) streaming rounds also run sharded; with
    the slice count divisible by the mesh (no pad slices in the periodic
    TV wrap) they match the unsharded run."""
    from tomojax import dist

    angles = np.linspace(-50, 50, 8)
    geom = Geometry.make(N, np.deg2rad(angles))
    ns = 8
    ph = np.stack([shepp_logan(N)] * ns)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    mesh = dist.make_mesh()
    dds = []
    for mesh_arg in (None, mesh):
        rec = DynamicReconstructor(
            nray=N, max_angles=8, angle_bucket=4, alg="cs", mesh=mesh_arg
        )
        rec.add_projections([(a, b[:, i, :]) for i, a in enumerate(angles)])
        rec.iterate_cs(4)
        dds.append(rec.dd_history[-1])
    assert dds[1] == pytest.approx(dds[0], rel=2e-4)


def test_dynamic_cs_pad_slices_stay_zero():
    """Round-4 advisor finding: with a slice count not divisible by the
    mesh, the CS rounds' TV step leaked into the zero-pad slices and the
    masked dd then summed their residuals. The step now re-zeros the
    pads after TV, so they stay identically zero and every dp/dd/dg
    reduction is pad-free."""
    from tomojax import dist

    angles = np.linspace(-50, 50, 8)
    geom = Geometry.make(N, np.deg2rad(angles))
    ns = 4  # pads to 8 on the virtual mesh
    ph = np.stack([shepp_logan(N)] * ns)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    rec = DynamicReconstructor(
        nray=N, max_angles=8, angle_bucket=4, alg="cs",
        mesh=dist.make_mesh(),
    )
    rec.add_projections([(a, b[:, i, :]) for i, a in enumerate(angles)])
    rec.iterate_cs(3)
    x = np.asarray(rec.x)
    assert x.shape[0] == 8
    assert np.all(x[ns:] == 0.0)
    assert np.any(x[:ns] != 0.0)


def test_stream_builds_under_mesh_scope(tmp_path):
    """The streaming driver must enter config.mesh_scope(self.mesh) when
    building its jitted steps — on a multi-device GPU mesh that is what
    runs the Triton projector per z-slab under shard_map
    (projector/triton_joseph.py on_slabs). The probe records the active
    mesh at build time, the condition that dispatch keys off."""
    from tomojax import dist

    angles = np.linspace(-50, 50, 8)
    geom = Geometry.make(N, np.deg2rad(angles))
    ph = np.stack([shepp_logan(N)] * 8)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    mesh = dist.make_mesh()
    for mesh_arg in (None, mesh):
        rec = DynamicReconstructor(
            nray=N, max_angles=8, angle_bucket=4, mesh=mesh_arg
        )
        rec.add_projections([(a, b[:, i, :]) for i, a in enumerate(angles)])
        rec.iterate(2)
        assert rec._last_build_mesh is mesh_arg
        rec.iterate_cs(1)
        assert rec._last_build_mesh is mesh_arg


def test_resume_sharded_checkpoint_without_mesh_raises(tmp_path):
    """Round-4 advisor finding: resuming a mesh-written checkpoint
    (history-only h5, volume in the orbax shards) without mesh= must
    fail loudly instead of silently restarting the volume from zeros."""
    from tomojax import dist

    angles = np.linspace(-50, 50, 8)
    geom = Geometry.make(N, np.deg2rad(angles))
    ph = np.stack([shepp_logan(N)] * 8)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    path = str(tmp_path / "ck_mesh.h5")
    rec = DynamicReconstructor(
        nray=N, max_angles=8, angle_bucket=4, mesh=dist.make_mesh(),
        checkpoint_path=path,
    )
    rec.add_projections([(a, b[:, i, :]) for i, a in enumerate(angles)])
    rec.iterate(2)
    rec.checkpoint()

    rec2 = DynamicReconstructor(
        nray=N, max_angles=8, angle_bucket=4, checkpoint_path=path
    )
    with pytest.raises(ValueError, match="mesh"):
        rec2.resume()


def test_overshoot_max_angles(tmp_path):
    """More projections than max_angles must grow the operator, not crash
    (acquisitions can overshoot the estimate)."""
    angles = np.linspace(-50, 50, 12)
    geom = Geometry.make(N, np.deg2rad(angles))
    ph = np.stack([shepp_logan(N)] * NS)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    rec = DynamicReconstructor(nray=N, max_angles=8, angle_bucket=4)
    rec.add_projections([(a, b[:, i, :]) for i, a in enumerate(angles)])
    dd = rec.iterate(5)
    assert np.isfinite(dd)
    assert rec.x.shape == (NS, N, N)


def test_run_loop_cs_alg(tmp_path):
    """run() dispatches to the CS (TV-regularized) rounds when alg='cs'."""
    angles = np.linspace(-50, 50, 8)
    geom = Geometry.make(N, np.deg2rad(angles))
    ph = np.stack([shepp_logan(N)] * NS)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    datadir = tmp_path / "cs"
    datadir.mkdir()
    for i, a in enumerate(angles):
        np.save(str(datadir / f"proj_{a:.1f}.npy"), b[:, i, :])
    watcher = TiltWatcher(str(datadir), preprocess=False)
    rec = DynamicReconstructor(nray=N, max_angles=8, angle_bucket=4, alg="cs")
    x = rec.run(watcher, iters_per_round=5, expected_angles=8)
    assert rec._dpocs > 0  # CS path ran (dPOCS was adapted)
    assert rec.dd_history[-1] < rec.dd_history[0] * 2


def test_watcher_log_appends(tmp_path):
    import h5py

    datadir = tmp_path / "log"
    datadir.mkdir()
    log = tmp_path / "log.h5"
    w = TiltWatcher(str(datadir), preprocess=False, log_path=str(log))
    np.save(str(datadir / "proj_1.0.npy"), np.ones((2, N), np.float32))
    w.poll()
    np.save(str(datadir / "proj_2.0.npy"), 2 * np.ones((2, N), np.float32))
    w.poll()
    with h5py.File(log, "r") as f:
        np.testing.assert_allclose(f["tiltAngles"][:], [1.0, 2.0])
        assert f["projections"].shape == (2, 2, N)
        assert f["projections"][1].max() == 2.0


def test_run_loop(tmp_path):
    angles = np.linspace(-50, 50, 8)
    geom = Geometry.make(N, np.deg2rad(angles))
    ph = np.stack([shepp_logan(N)] * NS)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    datadir = tmp_path / "s2"
    datadir.mkdir()
    _write_projs(datadir, angles, b)
    watcher = TiltWatcher(str(datadir), preprocess=False)
    rec = DynamicReconstructor(nray=N, max_angles=8, angle_bucket=4)
    x = rec.run(watcher, iters_per_round=5, expected_angles=8)
    assert x.shape == (NS, N, N)
    assert rec.dd_history[-1] < rec.dd_history[0]
