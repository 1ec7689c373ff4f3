"""Benchmark: FISTA-TV reconstruction throughput on the BASELINE 256-class
problem (256^3 volume, 90-angle tilt series — BASELINE.md configs), plus
the SART / ASD-POCS / fusion flagship rows.

Prints JSON lines; every row names the platform, device kind and device
count it ran on. Runs on the accelerator JAX finds and exits non-zero
without one; a CPU run needs an explicit ``--cpu``.

    python bench.py [NS N NA ITERS]        headline + flagship rows
    python bench.py --asd [NS N NA]        SART sweep / ASD-POCS iteration
    python bench.py --fusion [NEL NS N NA] fusion outer iteration
    python bench.py --scaling [NDEV ...]   slab-mesh strong scaling
"""

import json
import sys
import time

import numpy as np


def _device():
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": jax.device_count()}


def _row(metric, ms, voxels, **extra):
    return {
        "metric": metric,
        "value": round(voxels / (ms / 1e3), 1),
        "unit": "voxel-iters/s",
        "ms": round(ms, 3),
        **extra,
        **_device(),
    }


def main(ns=256, n=256, na=90, iters=10):
    import jax
    import jax.numpy as jnp
    from tomojax.geometry import Geometry
    from tomojax.projector.joseph import fp
    from tomojax.sim import nanocube_phantom
    from tomojax.solvers import fista_init, fista_run, make_system

    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    sysd = make_system(geom)
    vol = jnp.asarray(nanocube_phantom(ns, n))
    b = jax.jit(lambda v: fp(v, geom))(vol)
    state = fista_init(jnp.zeros((ns, n, n), jnp.float32), sysd)
    # all `iters` iterations in one scanned program (solvers.fista_run)
    run = jax.jit(lambda st, bb: fista_run(st, bb, sysd, 0.1, iters, 10))

    state, _ = run(state, b)  # compile + warm up
    jax.block_until_ready(state.x)
    reps = 4
    t0 = time.perf_counter()
    for _ in range(reps):
        state, _ = run(state, b)
    jax.block_until_ready(state.x)
    ms = (time.perf_counter() - t0) / (iters * reps) * 1e3
    rec = _row(f"fista_tv_voxel_iters_per_s_{ns}x{n}x{n}_{na}ang", ms,
               ns * n * n, vs_baseline=1.0)
    print(json.dumps(rec), flush=True)
    asd(ns, n, na)
    fusion_bench(3, ns // 2, n, na, na // 2)


def _slope(f, x, iters=6, reps=3):
    """Per-call ms by slope timing: the difference between a 1-call and a
    (1 + iters)-call jitted chain, so dispatch and the final reduction
    cancel. Chaining v = f(v) keeps every call's input fresh."""
    import jax
    import jax.numpy as jnp

    def chain(v, k):
        for _ in range(k):
            v = f(v)
        return jnp.sum(v)

    c1 = jax.jit(lambda v: chain(v, 1))
    ck = jax.jit(lambda v: chain(v, 1 + iters))
    float(c1(x)), float(ck(x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(c1(x))
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(ck(x))
        tk = time.perf_counter() - t0
        best = min(best, (tk - t1) / iters * 1e3)
    return best


def asd(ns=256, n=256, na=90):
    """ASD-POCS workload rows: the SART sweep (the reference's canonical
    distributed workload, examples/sim_ASD.py:67-94) and the full ASD-POCS
    iteration (SART + ng=10 TV-GD + metrics). One JSON line per row."""
    import jax.numpy as jnp
    from tomojax.geometry import Geometry
    from tomojax.solvers import make_system, make_sart_weights
    from tomojax.solvers.iterative import sart_sweep
    from tomojax.solvers.asd_pocs import make_asd_pocs_iteration

    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    sysd = make_system(geom)
    w = make_sart_weights(sysd)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((ns, n, n)).astype(np.float32))
    b = jnp.asarray(rng.random((ns, na, n)).astype(np.float32))

    sweep_ms = _slope(lambda v: sart_sweep(v, b, sysd, w, 0.8), x)
    it = make_asd_pocs_iteration(sysd, w, 10)
    order = jnp.arange(na, dtype=jnp.int32)
    iter_ms = _slope(lambda v: it(v, b, 0.25, 0.1, order, False, 0.2)[0], x)
    for name, ms in (("sart_sweep", sweep_ms), ("asd_pocs_iter", iter_ms)):
        rec = _row(f"{name}_voxel_iters_per_s_{ns}x{n}x{n}_{na}ang", ms,
                   ns * n * n, vs_baseline=1.0)
        print(json.dumps(rec), flush=True)


def fusion_bench(nel=3, ns=128, n=256, na=90, nac=45):
    """Fusion outer-iteration row: one data_fusion_step (HAADF SIRT-fused
    update + chem Poisson grad) + tvIter=5 4D FGP — the reference
    chemistry flagship loop (chemistry/reconstructor.py:182-225)."""
    import jax.numpy as jnp
    from tomojax.fusion import make_fusion_system, data_fusion_step
    from tomojax.fusion.multimodal import tv_fgp_4d

    w = np.ones(nel, np.float32)
    fsys = make_fusion_system(
        n, np.deg2rad(np.linspace(-76, 76, na)),
        np.deg2rad(np.linspace(-76, 76, nac)), w, 1.6,
    )
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.random((nel, ns, n, n)).astype(np.float32))
    bh = jnp.asarray(rng.random((ns, na, n)).astype(np.float32))
    bc = jnp.asarray(rng.random((nel, ns, nac, n)).astype(np.float32))

    def outer(v):
        v, _, _ = data_fusion_step(v, bh, bc, fsys, 10.0, 0.05, 5)
        v, _ = tv_fgp_4d(v, 5, 1e-4)
        return v

    ms = _slope(outer, x, iters=4)
    rec = _row(f"fusion_outer_iter_voxel_iters_per_s_{nel}el_{ns}x{n}x{n}",
               ms, nel * ns * n * n, vs_baseline=1.0)
    print(json.dumps(rec), flush=True)


def scaling(max_devices=None, ns=64, n=128, na=45, iters=10):
    """Strong-scaling study (BASELINE.md target: voxels/s at 1 device ->
    N devices, >=80% linear). Shards the FISTA-TV step as z-slabs over
    1, 2, 4, ... device meshes and reports parallel efficiency. On a CPU
    run the mesh is virtual (XLA_FLAGS=--xla_force_host_platform_device_count=8
    python bench.py --cpu --scaling)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tomojax import config as tjconfig
    from tomojax import dist
    from tomojax.geometry import Geometry
    from tomojax.solvers import make_system, fista_init, fista_step
    from tomojax.sim import shepp_logan
    from tomojax.projector.joseph import fp

    ndev_all = jax.device_count() if max_devices is None else max_devices
    geom = Geometry.make(n, np.deg2rad(np.linspace(-76, 76, na)))
    sysd = make_system(geom)
    ph = jnp.asarray(np.stack([shepp_logan(n)] * ns))
    results = []
    sizes = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= ndev_all]
    for ndev in sizes:
        mesh = dist.make_mesh(ndev)
        slab3 = NamedSharding(mesh, P(dist.SLAB_AXIS, None, None))
        with tjconfig.mesh_scope(mesh):
            b = jax.jit(lambda v: fp(v, geom), out_shardings=slab3)(
                jax.device_put(ph, slab3)
            )
            st = fista_init(
                jax.device_put(jnp.zeros((ns, n, n), jnp.float32), slab3),
                sysd,
            )
            step = jax.jit(lambda s, bb: fista_step(s, bb, sysd, 0.1, 10))
            st, _ = step(st, b)
        jax.block_until_ready(st.x)
        t0 = time.perf_counter()
        for _ in range(iters):
            st, _ = step(st, b)
        jax.block_until_ready(st.x)
        dt = time.perf_counter() - t0
        v = ns * n * n * iters / dt
        results.append((ndev, v))
        eff = v / (results[0][1] * ndev)
        print(json.dumps({
            "metric": f"fista_tv_scaling_{ns}x{n}x{n}_{na}ang",
            "devices": ndev,
            "value": round(v, 1),
            "unit": "voxel-iters/s",
            "parallel_efficiency": round(eff, 3),
            **_device(),
        }), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    import jax

    if "--cpu" in args:
        args.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform == "cpu":
        sys.exit("bench.py: no accelerator found (pass --cpu for a CPU run)")
    mode = args.pop(0) if args and args[0].startswith("--") else None
    nums = [int(a) for a in args]
    {"--scaling": scaling, "--asd": asd, "--fusion": fusion_bench,
     None: main}[mode](*nums)
