"""Time the projector candidates against each other on one GPU.

For each shape (Nslice, N, Nangles) it compiles forward (FP) and back
(BP) projection in each form -- the Triton kernels
(projector/triton_joseph.py), the XLA gather form and the XLA dense
interpolation-matrix form ('mxu') at several matmul precisions --
checks each against the gather form, and prints one JSON row per form
with the median wall time of a call. ``--fista`` also times one FISTA-TV
iteration (nTViter=10) with each projector, through ``fista_run``, and
one FGP iteration's bytes/s.

    python scripts/compare_projectors.py [--fista] [--shapes 256,256,90 ...]

Needs a GPU; exits 1 without one, or when a form fails. Every row names
the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_SHAPES = ["256,256,90", "128,512,90"]
FAILED = []


def _median_ms(f, *args, reps=7):
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts), max(ts)


def _rel(a, b):
    import jax.numpy as jnp

    return float(jnp.linalg.norm((a - b).ravel()) / jnp.linalg.norm(b.ravel()))


def _dot_precision_line(compiled_text):
    """First GEMM line of an optimized HLO module, trimmed: shows what a
    requested matmul precision became (operand precision / algorithm)."""
    for line in compiled_text.splitlines():
        if "gemm" in line and "custom-call" in line:
            i = line.find("precision_config")
            return line[i:i + 160] if i >= 0 else line[:200]
        if " dot(" in line:
            return line.strip()[:200]
    return "no dot found"


def kernels(shape, device):
    import jax
    import jax.numpy as jnp
    from tomojax import config as tjconfig
    from tomojax.geometry import Geometry
    from tomojax.projector import joseph
    from tomojax.projector.triton_joseph import bp_triton, fp_triton

    ns, n, na = shape
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((ns, n, n), np.float32))
    y = jnp.asarray(rng.random((ns, na, n), np.float32))
    with jax.default_matmul_precision("highest"):
        ref_fp = jax.jit(lambda v: joseph.fp(v, geom, "gather"))(x)
        ref_bp = jax.jit(lambda v: joseph.bp(v, geom, "gather"))(y)
    P = jax.lax.Precision
    forms = {
        "triton": (lambda v: fp_triton(v, geom), lambda v: bp_triton(v, geom),
                   None),
        "gather": (lambda v: joseph.fp(v, geom, "gather"),
                   lambda v: joseph.bp(v, geom, "gather"), None),
    }
    for pname in ("DEFAULT", "HIGH", "HIGHEST"):
        forms[f"mxu_{pname}"] = (
            lambda v: joseph.fp(v, geom, "mxu"),
            lambda v: joseph.bp(v, geom, "mxu"),
            getattr(P, pname),
        )
    rows = []
    for name, (f_fp, f_bp, prec) in forms.items():
        old = tjconfig.mxu_precision
        if prec is not None:
            tjconfig.mxu_precision = prec
        try:
            t0 = time.perf_counter()
            jfp = jax.jit(f_fp).lower(x).compile()
            jbp = jax.jit(f_bp).lower(y).compile()
            compile_s = time.perf_counter() - t0
            got_fp, got_bp = jfp(x), jbp(y)
            fp_ms = _median_ms(jfp, x)
            bp_ms = _median_ms(jbp, y)
            adj = abs(float(jnp.vdot(got_fp, y)) - float(jnp.vdot(x, got_bp)))
            adj /= float(jnp.linalg.norm(got_fp) * jnp.linalg.norm(y))
            row = {
                "shape": list(shape), "form": name,
                "fp_ms": fp_ms[0], "fp_ms_min": fp_ms[1], "fp_ms_max": fp_ms[2],
                "bp_ms": bp_ms[0], "bp_ms_min": bp_ms[1], "bp_ms_max": bp_ms[2],
                "fp_rel_err_vs_gather_highest": _rel(got_fp, ref_fp),
                "bp_rel_err_vs_gather_highest": _rel(got_bp, ref_bp),
                "adjointness": adj,
                "compile_s": compile_s,
                **device,
            }
            if name.startswith("mxu"):
                row["fp_gemm"] = _dot_precision_line(jfp.as_text())
            if name == "triton":
                row["fp_memory"] = str(jfp.memory_analysis())
                row["bp_memory"] = str(jbp.memory_analysis())
        except Exception as e:  # report, go on with the next form, exit 1
            row = {"shape": list(shape), "form": name,
                   "error": f"{type(e).__name__}: {str(e)[:600]}", **device}
            FAILED.append(name)
        finally:
            tjconfig.mxu_precision = old
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def fista(shape, device, forms, iters=5):
    import jax
    import jax.numpy as jnp
    from tomojax import config as tjconfig
    from tomojax.geometry import Geometry
    from tomojax.projector.joseph import fp
    from tomojax.sim import nanocube_phantom
    from tomojax.solvers import fista_init, fista_run, make_system

    ns, n, na = shape
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    sysd = make_system(geom)
    vol = jnp.asarray(nanocube_phantom(ns, n))
    b = jax.jit(lambda v: fp(v, geom, "gather"))(vol)
    for name in forms:
        mode, _, prec = name.partition("_")
        old = (tjconfig.projector_mode, tjconfig.mxu_precision)
        tjconfig.projector_mode = mode
        if prec:
            tjconfig.mxu_precision = getattr(jax.lax.Precision, prec)
        try:
            st0 = fista_init(jnp.zeros((ns, n, n), jnp.float32), sysd)
            run = jax.jit(lambda st, bb: fista_run(st, bb, sysd, 0.1, iters, 10))
            t0 = time.perf_counter()
            run_c = run.lower(st0, b).compile()
            compile_s = time.perf_counter() - t0
            med, lo, hi = _median_ms(lambda s, bb: run_c(s, bb)[0].x, st0, b,
                                     reps=3)
            _, m = run_c(st0, b)
            row = {"shape": list(shape), "form": name, "fista_iters": iters,
                   "ms_per_iter": med / iters, "ms_per_iter_min": lo / iters,
                   "ms_per_iter_max": hi / iters, "compile_s": compile_s,
                   "final_cost": float(m[-1, 0]), **device}
        except Exception as e:  # report, go on with the next form, exit 1
            row = {"shape": list(shape), "form": name,
                   "error": f"{type(e).__name__}: {str(e)[:600]}", **device}
            FAILED.append(name)
        finally:
            tjconfig.projector_mode, tjconfig.mxu_precision = old
        print(json.dumps(row), flush=True)


def fgp(shape, device, iters=10):
    """One FGP TV-prox iteration's time and its bytes/s, counting the
    least traffic an iteration needs: read x and the three duals, write
    the three duals (7 volumes)."""
    import jax
    import jax.numpy as jnp
    from tomojax import tv

    ns, n, _ = shape
    x = jnp.asarray(np.random.default_rng(0).random((ns, n, n), np.float32))
    f1 = jax.jit(lambda v: tv.tv_fgp(v, 1, 0.1)[0])
    fk = jax.jit(lambda v: tv.tv_fgp(v, 1 + iters, 0.1)[0])
    t1, tk = _median_ms(f1, x)[0], _median_ms(fk, x)[0]
    ms = (tk - t1) / iters
    gbs = 7 * x.size * 4 / (ms / 1e3) / 1e9
    print(json.dumps({"shape": list(shape), "form": "fgp_iteration",
                      "ms": ms, "min_traffic_GB_per_s": gbs,
                      "share_of_3350_GB_per_s": gbs / 3350, **device}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="*", default=DEFAULT_SHAPES)
    ap.add_argument("--fista", action="store_true")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--fista-forms", nargs="*",
                    default=["triton", "gather", "mxu_HIGH", "mxu_DEFAULT"])
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print("nvidia-smi:", smi.stdout.strip() or smi.stderr.strip(), flush=True)
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (platform {dev.platform!r})", file=sys.stderr)
        sys.exit(1)
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": jax.device_count()}
    shapes = [tuple(int(v) for v in s.split(",")) for s in args.shapes]
    for shape in shapes:
        if not args.no_kernels:
            kernels(shape, device)
        if args.fista:
            fgp(shape, device)
            fista(shape, device, args.fista_forms)
    if FAILED:
        sys.exit(f"forms that failed: {FAILED}")


if __name__ == "__main__":
    main()
