"""Example-script smoke tests: every driver recipe runs end-to-end as a
CLI at small scale (the reference's driver scripts are its only 'apps';
several shipped broken — SURVEY.md §2.5 — so ours are executed in CI)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=300):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable] + args, cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )
    assert r.returncode == 0, f"{args}\nSTDOUT:{r.stdout[-800:]}\nSTDERR:{r.stderr[-800:]}"
    return r.stdout


def test_sim_tomo(tmp_path):
    out = _run(
        [f"{REPO}/examples/sim_tomo.py", "--nslice", "2", "--n", "32",
         "--nproj", "15", "--alg", "sirt", "--niter", "10", "--save"],
        cwd=str(tmp_path),
    )
    assert "RMSE" in out
    assert (tmp_path / "results/sim_tomo/sirt.h5").exists()


def test_sim_asd(tmp_path):
    out = _run(
        [f"{REPO}/examples/sim_ASD.py", "--nslice", "2", "--n", "32",
         "--nproj", "11", "--niter", "5", "--snr", "0"],
        cwd=str(tmp_path),
    )
    assert "ASD-POCS" in out


def test_exp_tomo_roundtrip(tmp_path):
    # build a tiny reference-layout tilt-series h5, then reconstruct
    import h5py
    import jax.numpy as jnp

    sys.path.insert(0, REPO)
    from tomojax.geometry import Geometry
    from tomojax.projector.joseph import fp
    from tomojax.sim import shepp_logan

    n = 32
    angles = np.linspace(-60, 60, 13)
    geom = Geometry.make(n, np.deg2rad(angles))
    ph = np.stack([shepp_logan(n)] * 2)
    b = np.asarray(fp(jnp.asarray(ph), geom))
    with h5py.File(tmp_path / "ts.h5", "w") as f:
        f["tiltSeries"] = np.transpose(b, (0, 2, 1))
        f["tiltAngles"] = angles
    out = _run(
        [f"{REPO}/examples/exp_tomo.py", str(tmp_path / "ts.h5"),
         "--alg", "sirt", "--niter", "8",
         "--out", str(tmp_path / "recon.h5")],
        cwd=str(tmp_path),
    )
    assert (tmp_path / "recon.h5").exists()
    from tomojax import io

    recon, results, params = io.load_results(str(tmp_path / "recon.h5"))
    assert recon.shape == (2, n, n)
    assert params["alg"] == "sirt"


def test_dynamic_tomo(tmp_path):
    out = _run(
        [f"{REPO}/examples/dynamic_tomo.py", "--dir", str(tmp_path / "s"),
         "--nslice", "2", "--n", "32", "--nproj", "8", "--batch", "4",
         "--iters-per-round", "5", "--ckpt", str(tmp_path / "c.h5")],
        cwd=str(tmp_path),
    )
    assert "final RMSE" in out
    assert (tmp_path / "c.h5").exists()


def test_dynamic_tomo_mesh(tmp_path):
    """--mesh runs the streaming recipe z-slab-sharded over the virtual
    8-device mesh (conftest XLA flags propagate through _run's env) and
    writes the sharded checkpoint layout (orbax shards + h5 sidecar)."""
    env_flags = os.environ.get("XLA_FLAGS", "")
    assert "host_platform_device_count" in env_flags  # conftest set it
    out = _run(
        [f"{REPO}/examples/dynamic_tomo.py", "--dir", str(tmp_path / "s"),
         "--nslice", "8", "--n", "32", "--nproj", "8", "--batch", "4",
         "--iters-per-round", "5", "--ckpt", str(tmp_path / "c.h5"),
         "--mesh"],
        cwd=str(tmp_path),
    )
    assert "mesh: 8 devices" in out
    assert "final RMSE" in out
    assert (tmp_path / "c.h5").exists()
    assert (tmp_path / "c.h5.shards").is_dir()


def test_fusion_demo(tmp_path):
    out = _run(
        [f"{REPO}/examples/fusion_demo.py", "--nslice", "2", "--n", "32",
         "--niter", "5", "--normalize-haadf"],
        cwd=str(tmp_path), timeout=420,
    )
    assert "fused NRMSE" in out


def test_plot_results(tmp_path):
    sys.path.insert(0, REPO)
    from tomojax import io

    p = tmp_path / "r.h5"
    io.save_results(
        str(p), {"alg": "x"}, {"dd": np.arange(5, dtype=np.float32)},
        np.ones((2, 8, 8), np.float32),
    )
    _run([f"{REPO}/examples/plot_results.py", str(p)], cwd=str(tmp_path))
    assert (tmp_path / "r_dd.png").exists()
    assert (tmp_path / "r_slices.png").exists()


def test_zenodo_adf_selfcheck(tmp_path):
    """The Zenodo parity recipe runs end-to-end in selfcheck mode and
    emits the per-iteration JSON trace + reference-layout results h5."""
    import json as _json

    out = _run(
        [f"{REPO}/examples/zenodo_adf.py", "--niter", "8",
         "--selfcheck-size", "32", "--out", "zen/out"],
        cwd=str(tmp_path),
    )
    rows = [_json.loads(l) for l in out.strip().splitlines()]
    assert len(rows) == 8
    assert rows[-1]["dd"] < rows[0]["dd"]
    assert {"iter", "dd", "tv", "cost"} <= set(rows[0])
    assert (tmp_path / "zen/out.h5").exists()


def test_bench_flags_smoke(tmp_path):
    """bench.py --cpu --asd / --fusion run end-to-end at toy size and emit
    well-formed JSON rows naming the device; no artifact files."""
    import json as _json

    out = _run(
        [f"{REPO}/bench.py", "--cpu", "--asd", "8", "32", "9"],
        cwd=str(tmp_path),
    )
    rows = [_json.loads(l) for l in out.strip().splitlines() if l.startswith("{")]
    assert {r["metric"].split("_voxel")[0] for r in rows} == {
        "sart_sweep", "asd_pocs_iter"
    }
    assert all(r["value"] > 0 and r["ms"] > 0 for r in rows)
    assert all(r["platform"] == "cpu" and r["device_count"] >= 1
               and r["device_kind"] for r in rows)
    out = _run(
        [f"{REPO}/bench.py", "--cpu", "--fusion", "2", "8", "32", "9"],
        cwd=str(tmp_path),
    )
    rows = [_json.loads(l) for l in out.strip().splitlines() if l.startswith("{")]
    assert len(rows) == 1 and rows[0]["metric"].startswith("fusion_outer")
    assert not (tmp_path / "results").exists()


def test_bench_without_accelerator_fails(tmp_path):
    """Off an accelerator bench.py refuses to measure unless --cpu asks."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, f"{REPO}/bench.py", "--asd", "8", "32", "9"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert "no accelerator" in r.stderr
    assert "{" not in r.stdout


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_off_gpu(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no result line without a
    GPU, both from the checkout and copied into an empty directory."""
    import shutil

    script = f"{REPO}/chip_smoke.py"
    if where == "alone":
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, script], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_docs_numbers_match_artifacts():
    """Docs-truth gate: every bolded throughput claim in
    README/ARCHITECTURE must match a row of the benchmark ledger (docs
    that claim nothing pass). Also self-checks that the gate FAILS on a
    fabricated claim."""
    sys.path.insert(0, f"{REPO}/scripts")
    import check_docs

    assert check_docs.main() == 0
    # the detector actually detects: a made-up bolded number must fail
    fake = "prose **9999.9M voxel-iters/s** more prose"
    claims = check_docs.bolded_throughput_claims(fake)
    assert claims and claims[0][0] == "9999.9"
    assert "9999.9" not in check_docs.allowed_numbers()


def test_zenodo_adf_compare_gate(tmp_path):
    """The --compare parity gate (round-3 VERDICT #7): a recorded
    reference-format trace passes when the normalized curves agree (here:
    a trace recorded from an identical run, plus an operator-scale factor
    the normalization must cancel) and FAILS the run when they diverge
    beyond --compare-rtol."""
    import json as _json

    out = _run(
        [f"{REPO}/examples/zenodo_adf.py", "--niter", "8",
         "--selfcheck-size", "32", "--out", "zen/a"],
        cwd=str(tmp_path),
    )
    rows = [_json.loads(l) for l in out.strip().splitlines()]
    # reference-build stand-in trace: same convergence curve, different
    # absolute operator scale (ASTRA vs Joseph norms differ ~1e-3; use a
    # gross 1.7x to prove the normalization cancels scale entirely)
    ref = tmp_path / "ref_trace.jsonl"
    with open(ref, "w") as f:
        for r in rows:
            f.write(_json.dumps(
                {"iter": r["iter"], "dd": 1.7 * r["dd"], "tv": 1.7 * r["tv"]}
            ) + "\n")
    _run(
        [f"{REPO}/examples/zenodo_adf.py", "--niter", "8",
         "--selfcheck-size", "32", "--out", "zen/b",
         "--compare", str(ref), "--compare-rtol", "0.02"],
        cwd=str(tmp_path),
    )
    # diverged trace (convergence curve drifts 5%/iter — a genuinely
    # different trajectory, not a scale change): the gate must fail
    bad = tmp_path / "bad_trace.jsonl"
    with open(bad, "w") as f:
        for r in rows:
            f.write(_json.dumps(
                {"iter": r["iter"], "dd": r["dd"] * 1.05 ** r["iter"],
                 "tv": r["tv"]}
            ) + "\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, f"{REPO}/examples/zenodo_adf.py", "--niter", "8",
         "--selfcheck-size", "32", "--out", "zen/c",
         "--compare", str(bad), "--compare-rtol", "0.02"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode != 0
    assert "parity FAILED" in (r.stderr + r.stdout)
