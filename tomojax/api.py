"""User-facing reconstructor classes mirroring the reference API surface.

`TomoTPU` mirrors `TomoGPU` (reference tomofusion/gpu/reconstructor.py) and
`ChemicalTomo` mirrors its namesake (chemistry/reconstructor.py); the
reference README quickstart translates 1:1:

    from tomojax import TomoTPU
    tomo = TomoTPU(tiltAngles, tiltSeries)     # angles in degrees
    tomo.fista(Niter=50, lambda_param=0.1)
    recon = tomo.get_recon()                   # (Nslice, Nray, Nray)

Differences by design: there is no engine-object zoo
(tomoengine vs multigpuengine vs mpi engine — reference
reconstructor.py:23-29); one class runs on any `jax.sharding.Mesh`. Pass
``mesh=`` (or let it default to all local devices) and the volume is
sharded as z-slabs; single-device behavior is identical.

Sharded-run caveat: when Nslice is not a multiple of the mesh size, the
slice axis is zero-padded up to it (dist.pad_slices — jit needs the
sharded dimension to divide evenly, where the reference instead spreads
remainder slices over MPI ranks, mpi_astra_ctvlib.cpp:53-58). The
padding is invisible to the data term (padded slices carry zero
measurements and reconstruct to ~zero), but the *periodic* TV wrap then
couples slice Ns-1 to a zero pad slice instead of slice 0 — a
boundary-plane-sized deviation from the unsharded result in
TV-regularized algorithms (fista/asd_pocs). Exact across-mesh parity:
choose Nslice divisible by the mesh size.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tomojax import config as _tjconfig

from tomojax.geometry import Geometry
from tomojax import dist, ops
from tomojax import tv as tvmod
from tomojax.projector.joseph import fp
from tomojax.projector.filters import FILTERS
from tomojax.solvers import (
    make_system,
    make_sart_weights,
    sirt_sweep,
    sart_sweep,
    cgls_run,
    poisson_ml_step,
    fbp,
    fista_init,
    fista_step,
    make_asd_pocs_iteration,
)
from tomojax.fusion import (
    make_fusion_system,
    weights_for_elements,
    poisson_ml_step_4d,
    data_fusion_step,
    rescale_tomograms,
    rescale_projections,
)


def _to_sinogram(tilt_series: np.ndarray) -> np.ndarray:
    """(Nslice, Nray, Nangles) -> (Nslice, Nangles, Nray), the angle-major
    per-slice layout (reference reconstructor.py:54-59 transpose/ravel)."""
    return np.ascontiguousarray(np.transpose(tilt_series, (0, 2, 1)))


def _scoped(method):
    """Run the method under this reconstructor's mesh scope
    (config.mesh_scope) so sharded-kernel dispatch is per-object: every
    jit inside the method traces while `self.mesh` is active, and two
    live reconstructors with different meshes cannot re-route each
    other's kernels (the reference binds device placement per engine
    object the same way — tomoengine.cpp:87-89 set_gpu_id)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with _tjconfig.mesh_scope(self.mesh):
            return method(self, *args, **kwargs)

    return wrapper


class TomoTPU:
    """Batched tilt-series reconstructor (reference TomoGPU parity)."""

    def __init__(
        self,
        tilt_angles: np.ndarray,
        tilt_series: Optional[np.ndarray] = None,
        mesh=None,
        use_mesh: bool = False,
    ):
        self.mesh = mesh if mesh is not None else (
            dist.make_mesh() if use_mesh or jax.device_count() > 1 else None
        )
        self.tilt_angles = np.asarray(tilt_angles, np.float64)
        self.recon = None
        self.cost = None
        self._sart_w = None
        self._order_key = jax.random.PRNGKey(0)
        if tilt_series is not None:
            self.set_tilt_series(tilt_series)

    # ------------------------------------------------------------- data --

    @_scoped
    def set_tilt_series(self, tilt_series: np.ndarray):
        """(Nslice, Nray, Nangles), tilt axis on dim 0 (README.md:36)."""
        self.Nslice, self.Nray, self.Nangles = tilt_series.shape
        assert self.Nangles == len(self.tilt_angles), (
            f"tilt series has {self.Nangles} angles, "
            f"angle array has {len(self.tilt_angles)}"
        )
        self.geom = Geometry.make(self.Nray, np.deg2rad(self.tilt_angles))
        self.sys = make_system(self.geom)
        b = jnp.asarray(_to_sinogram(tilt_series), jnp.float32)
        self._ns_orig = self.Nslice
        if self.mesh is not None:
            b, self._ns_orig = dist.pad_slices(b, self.mesh)
            b = dist.shard_volume(b, self.mesh)
        self.b = b
        self.x = self._zeros_volume()
        self.recon = None
        self._sart_w = None

    def _zeros_volume(self):
        ns = self.b.shape[0]
        x = jnp.zeros((ns, self.Nray, self.Nray), jnp.float32)
        if self.mesh is not None:
            x = dist.shard_volume(x, self.mesh)
        return x

    def restart_recon(self):
        self.x = self._zeros_volume()
        self.recon = None

    @_scoped
    def update_projection_angles(self, tilt_angles, tilt_series):
        """Dynamic-acquisition operator growth (reference
        tomoengine.cpp:130-149 rebuilds ASTRA geometry objects; here the
        angle set is just static metadata on a fresh Geometry, so this
        re-binds geometry + data and the next solver call jit-compiles
        for the new angle count — use stream.DynamicReconstructor's
        bucketing to bound recompiles in tight acquisition loops).
        The current reconstruction is kept as the warm start."""
        x_prev, ns_prev = self.x, getattr(self, "Nslice", None)
        self.tilt_angles = np.asarray(tilt_angles, np.float64)
        self.set_tilt_series(tilt_series)
        if x_prev is not None and ns_prev == self.Nslice:
            self.x = x_prev  # same volume extent: warm start
        return self

    # -------------------------------------------------------- algorithms --

    @_scoped
    def wbp(self, filter: str = "ram-lak", apply_positivity: bool = True):
        """Filtered backprojection (reference reconstructor.py:61-73)."""
        if filter not in FILTERS:
            print(f"{filter} filter not supported. Defaulting to ram-lak.")
            filter = "ram-lak"
        self.x = jax.jit(
            lambda b: fbp(b, self.geom, filter, apply_positivity)
        )(self.b)
        self.recon = None
        return self

    @_scoped
    def sirt(self, Niter: int = 150, show_convergence: bool = True,
             variant: str = "astra"):
        """SIRT; variant selects the weighting style ('astra' default,
        'landweber', 'cimmino' — see solvers.iterative.sirt_sweep)."""
        self.restart_recon()
        kw = {}
        if variant == "cimmino":
            from tomojax.solvers.base import row_norms_sq

            kw["row_nsq"] = row_norms_sq(self.geom)
        step = jax.jit(
            lambda x, b: sirt_sweep(x, b, self.sys, 1, variant=variant, **kw)
        )
        self._run_iterative(step, Niter, show_convergence)
        return self

    @_scoped
    def art(self, Niter: int = 1, beta: float = 1.0,
            random_order: bool = False, show_convergence: bool = True):
        """Row-action Kaczmarz ART / randART sweeps (reference CPU engine
        feature, ctvlib.cpp:137-191; slow by construction — sequential
        over rays)."""
        from tomojax.solvers import art_sweep

        self.restart_recon()
        na, nt = self.geom.nproj, self.geom.nray
        self.cost = np.zeros(Niter, np.float32)
        ddj = jax.jit(lambda x, b: ops.data_distance(fp(x, self.geom), b))
        step = jax.jit(
            lambda x, b, order: art_sweep(x, b, self.sys, beta, order)
        )
        for i in range(Niter):
            order = jnp.arange(na * nt, dtype=jnp.int32)
            if random_order:
                self._order_key, sub = jax.random.split(self._order_key)
                order = jax.random.permutation(sub, na * nt).astype(jnp.int32)
            self.x = step(self.x, self.b, order)
            if show_convergence:
                self.cost[i] = float(ddj(self.x, self.b))
        self.recon = None
        return self

    @_scoped
    def sart(
        self, Niter: int = 150, init: str = "sequential",
        beta: float = 1.0, show_convergence: bool = True,
    ):
        if init not in ("sequential", "random"):
            print(f"{init} order not supported. Defaulting to sequential.")
            init = "sequential"
        self.restart_recon()
        if self._sart_w is None:
            self._sart_w = make_sart_weights(self.sys)
        step = jax.jit(
            lambda x, b, order: sart_sweep(
                x, b, self.sys, self._sart_w, beta, order
            )
        )
        seq = jnp.arange(self.geom.nproj, dtype=jnp.int32)
        self.cost = np.zeros(Niter, np.float32)
        ddj = jax.jit(lambda x, b: ops.data_distance(fp(x, self.geom), b))
        for i in range(Niter):
            order = seq
            if init == "random":
                self._order_key, sub = jax.random.split(self._order_key)
                order = jax.random.permutation(sub, self.geom.nproj).astype(jnp.int32)
            self.x = step(self.x, self.b, order)
            if show_convergence:
                self.cost[i] = float(ddj(self.x, self.b))
        self.recon = None
        return self

    @_scoped
    def cgls(self, Niter: int = 100, show_convergence: bool = True):
        """CGLS; positivity applied after the run (tomoengine.cpp:228)."""
        self.restart_recon()
        x = jax.jit(lambda x, b: cgls_run(x, b, self.sys, Niter))(self.x, self.b)
        self.x = jnp.maximum(x, 0.0)
        if show_convergence:
            self.cost = np.asarray(
                [float(ops.data_distance(fp(self.x, self.geom), self.b))]
            )
        self.recon = None
        return self

    @_scoped
    def kl_divergence(self, Niter: int = 100, lambda_param: float = 0.1):
        """Poisson-ML (reference reconstructor.py:113-119); a *copy* of b
        is normalized to max 1 — unconditionally, matching the reference
        (tomoengine.cpp:245 divides by the max whatever its value, so
        data with max < 1 is scaled *up*; the effective step size is the
        same either way). The reference normalizes the stored tilt series
        in place, which silently rescales every later algorithm run on
        the same engine — a footgun we don't replicate: the stored b is
        untouched and the reconstruction is rescaled back to data units
        afterwards."""
        self.restart_recon()
        bmax = float(jnp.max(self.b))
        b_kl = self.b / bmax if bmax > 0 else self.b
        step = jax.jit(
            lambda x, b: poisson_ml_step(x, b, self.sys, lambda_param)
        )
        self.cost = np.zeros(Niter, np.float32)
        for i in range(Niter):
            self.x, c = step(self.x, b_kl)
            self.cost[i] = float(c)
        if bmax > 0:
            self.x = self.x * bmax
        self.recon = None
        return self

    @_scoped
    def fista(
        self,
        Niter: int = 100,
        momentum: bool = True,
        lambda_param: float = 0.1,
        nTViter: int = 10,
        show_convergence: bool = True,
        compat: str = "correct",
        fused: bool = False,
    ):
        """FISTA-TV (reference reconstructor.py:121-155). See
        solvers/fista.py for the documented reference-compat deviation.

        fused=True scans all Niter iterations into ONE traced program
        (solvers.fista_run). The host loop stays the default for
        interactive use."""
        self.restart_recon()
        self.cost = np.zeros(Niter, np.float32)
        if fused:
            from tomojax.solvers import fista_run

            st = fista_init(self.x, self.sys)
            run = jax.jit(
                lambda st, b: fista_run(
                    st, b, self.sys, lambda_param, Niter, nTViter,
                    momentum, compat, compute_metrics=show_convergence,
                )
            )
            st, metrics = run(st, self.b)
            if show_convergence:
                self.cost[:] = np.asarray(metrics)[:, 0]
        else:
            st = fista_init(self.x, self.sys)
            step = jax.jit(
                lambda st, b: fista_step(
                    st, b, self.sys, lambda_param, nTViter, momentum, compat,
                    compute_metrics=show_convergence,
                )
            )
            for k in range(Niter):
                st, (cost, dd, tvv) = step(st, self.b)
                if show_convergence:
                    self.cost[k] = float(cost)
        self.x = st.x
        self.recon = None
        return self

    @_scoped
    def asd_pocs(
        self,
        Niter: int = 100,
        eps: float = 0.025,
        beta0: float = 0.25,
        beta_reduce: float = 0.9985,
        r_max: float = 0.95,
        nTViter: int = 10,
        alpha: float = 0.2,
        alpha_reduce: float = 0.95,
        init: str = "sequential",
        show_convergence: bool = True,
        fused: bool = False,
    ):
        """ASD-POCS with the reference's *working* adaptation logic
        (cpu/sim_ASD.py:65-96 — TomoGPU.asd_pocs itself has undefined-name
        bugs, SURVEY.md §2.5).

        fused=True runs the whole adaptive loop as one scanned program
        (solvers.make_asd_pocs_run; identical math, adaptation scalars
        carried through the scan) — the pod-production shape. NOTE the
        nested scan(iterations)/scan(angles) program can take minutes to
        compile on slow compile services; host-loop stays the default."""
        self.restart_recon()
        if self._sart_w is None:
            self._sart_w = make_sart_weights(self.sys)
        if fused:
            from tomojax.solvers import AsdPocsParams, make_asd_pocs_run

            params = AsdPocsParams(
                niter=Niter, eps=eps, beta0=beta0, beta_red=beta_reduce,
                r_max=r_max, ng=nTViter, alpha=alpha,
                alpha_red=alpha_reduce,
            )
            run = make_asd_pocs_run(
                self.sys, self._sart_w, params,
                random_order=(init == "random"),
            )
            if init == "random":
                self._order_key, sub = jax.random.split(self._order_key)
            else:
                # don't consume the stream when the order is sequential —
                # the host-loop driver doesn't either, so mixed fused/host
                # call sequences stay reproducibility-equivalent
                sub = jax.random.PRNGKey(0)
            self.x, dd_vec, tv_vec = run(self.x, self.b, sub)
            self.dd_vec = np.asarray(dd_vec)
            self.tv_vec = np.asarray(tv_vec)
            self.cost = self.dd_vec
            self.recon = None
            return self
        # Host-side adaptation loop (like the reference driver). The fully
        # fused scan variant (solvers.make_asd_pocs_run) is numerically
        # equivalent; the host loop reads three scalars per iteration.
        run = make_asd_pocs_iteration(self.sys, self._sart_w, nTViter)
        seq = jnp.arange(self.geom.nproj, dtype=jnp.int32)
        beta, dpocs = beta0, 0.0
        self.dd_vec = np.zeros(Niter, np.float32)
        self.tv_vec = np.zeros(Niter, np.float32)
        for i in range(Niter):
            order = seq
            if init == "random":
                self._order_key, sub = jax.random.split(self._order_key)
                order = jax.random.permutation(sub, self.geom.nproj).astype(jnp.int32)
            self.x, dp, dd, dg, tv0, dpocs_eff = run(
                self.x, self.b, beta, dpocs, order, i == 0, alpha
            )
            beta *= beta_reduce
            dp, dd, dg = float(dp), float(dd), float(dg)
            dpocs = float(dpocs_eff)
            self.dd_vec[i], self.tv_vec[i] = dd, float(tv0)
            if dg > r_max * dp and dd > eps:
                dpocs *= alpha_reduce
        self.cost = self.dd_vec
        self.recon = None
        return self

    # ----------------------------------------------------------- metrics --

    def _run_iterative(self, step, Niter, show_convergence):
        self.cost = np.zeros(Niter, np.float32)
        ddj = jax.jit(lambda x, b: ops.data_distance(fp(x, self.geom), b))
        for i in range(Niter):
            self.x = step(self.x, self.b)
            if show_convergence:
                self.cost[i] = float(ddj(self.x, self.b))

    @_scoped
    def data_distance(self) -> float:
        return float(ops.data_distance(fp(self.x, self.geom), self.b))

    @_scoped
    def tv(self) -> float:
        return float(tvmod.tv(self.x))

    def lipschitz(self) -> float:
        return float(self.sys.lipschitz)

    # ------------------------------------------------------------ output --

    def get_recon(self) -> np.ndarray:
        if self.recon is None:
            x = self.x
            if self.mesh is not None:
                x = dist.unpad_slices(x, self._ns_orig)
            self.recon = np.asarray(x)
        return self.recon

    def get_projections(self) -> np.ndarray:
        b = self.b
        if self.mesh is not None:
            b = dist.unpad_slices(b, self._ns_orig)
        return np.asarray(b)

    @_scoped
    def get_model_projections(self) -> np.ndarray:
        g = fp(self.x, self.geom)
        if self.mesh is not None:
            g = dist.unpad_slices(g, self._ns_orig)
        return np.asarray(g)

    def plot_convergence(self, path: Optional[str] = None):
        from tomojax import viz

        return viz.plot_convergence(self.cost, path=path)

    def show_recon(self, path: Optional[str] = None):
        from tomojax import viz

        return viz.show_volume(self.get_recon(), path=path)


class Simulator(TomoTPU):
    """Simulation-study driver (reference gpu/simulator.py, repaired:
    the original has a syntax error and broken imports — SURVEY.md §2.5)."""

    def __init__(self, volume: np.ndarray, tilt_angles: np.ndarray,
                 snr: int = 0, mesh=None):
        self.original = np.asarray(volume, np.float32)
        ns, n, _ = self.original.shape
        from tomojax.sim import create_projections

        geom = Geometry.make(n, np.deg2rad(np.asarray(tilt_angles)))
        if snr:
            self.original = np.where(self.original == 0, 1.0, self.original)
        b = np.asarray(create_projections(self.original, geom, snr=snr))
        # back to (Nslice, Nray, Nangles) for the parent ctor
        series = np.transpose(b, (0, 2, 1))
        super().__init__(np.asarray(tilt_angles), series, mesh=mesh)

    @_scoped
    def rmse(self) -> float:
        gt = jnp.asarray(self.original)
        x = self.x
        if self.mesh is not None:
            x = dist.unpad_slices(x, self._ns_orig)
        return float(ops.rmse(x, gt))


class ChemicalTomo:
    """Fused multi-modal reconstructor (reference chemistry/reconstructor.py)."""

    def __init__(
        self,
        haadf: np.ndarray,
        haadfTiltAngles: np.ndarray,
        chem: Dict[str, np.ndarray],
        chemTiltAngles: np.ndarray,
        gamma: float = 1.6,
        sigmaMethod: int = 3,
        mesh=None,
    ):
        self.nx, self.ny, _ = haadf.shape  # (Nslice, Nray, NaH)
        self.elements = list(chem)
        self.nel = len(self.elements)
        self.gamma, self.sigmaMethod = gamma, sigmaMethod
        self.reduceLambda = True
        self.mesh = mesh
        with _tjconfig.mesh_scope(mesh):
            self._init_data(haadf, haadfTiltAngles, chem, chemTiltAngles,
                            gamma, sigmaMethod, mesh)

    def _init_data(self, haadf, haadfTiltAngles, chem, chemTiltAngles,
                   gamma, sigmaMethod, mesh):
        # normalize + reshape (reconstructor.py:94-137)
        h = np.maximum(np.asarray(haadf, np.float32), 0)
        h /= max(h.max(), 1e-30)
        self.b_haadf = jnp.asarray(_to_sinogram(h))
        stack = []
        for el in self.elements:
            c = np.maximum(np.asarray(chem[el], np.float32), 0)
            c /= max(c.max(), 1e-30)
            stack.append(_to_sinogram(c))
        self.b_chem = jnp.asarray(np.stack(stack))  # (Nel, Ns, NaC, Nt)

        w = weights_for_elements(self.elements, gamma, sigmaMethod)
        self.fsys = make_fusion_system(
            self.ny,
            np.deg2rad(np.asarray(haadfTiltAngles)),
            np.deg2rad(np.asarray(chemTiltAngles)),
            w,
            gamma,
        )
        self._ns_orig = self.nx
        if mesh is not None:
            # pad the slice axis to the mesh size like TomoTPU does (jit
            # requires the sharded dimension to divide evenly)
            self.b_haadf, self._ns_orig = dist.pad_slices(self.b_haadf, mesh)
            self.b_chem, _ = dist.pad_slices(self.b_chem, mesh, axis=1)
            self.nx_padded = self.b_haadf.shape[0]
        else:
            self.nx_padded = self.nx
        self.x = jnp.zeros(
            (self.nel, self.nx_padded, self.ny, self.ny), jnp.float32
        )
        if mesh is not None:
            self.x = dist.shard_volume_4d(self.x, mesh)
            self.b_chem = jax.device_put(
                self.b_chem,
                jax.sharding.NamedSharding(mesh, dist.slab_spec(4, 1)),
            )
            self.b_haadf = dist.shard_volume(self.b_haadf, mesh)
        self.reconTotal = None
        self.chemistry_reconstructed = False

    def restart_recon(self):
        self.x = jnp.zeros_like(self.x)
        self.reconTotal = None

    @_scoped
    def chemical_tomography(
        self, Niter: int = 100, lambdaCHEM: float = 0.05,
        show_convergence: bool = True,
    ):
        """Chemistry-only Poisson-ML (reconstructor.py:157-180)."""
        self.restart_recon()
        step = jax.jit(
            lambda x: poisson_ml_step_4d(x, self.b_chem, self.fsys, lambdaCHEM)
        )
        self.costCHEM = np.zeros(Niter, np.float32)
        for i in range(Niter):
            self.x, c = step(self.x)
            self.costCHEM[i] = float(c)
        self.chemistry_reconstructed = True
        self.reconTotal = None
        return self

    @_scoped
    def _rescale_data(self, scale: float = 10.0):
        """reconstructor.py:227-236."""
        self.x = rescale_tomograms(self.x, scale)
        self.b_haadf = jax.jit(
            lambda x, bh: rescale_projections(x, bh, self.fsys)
        )(self.x, self.b_haadf)

    @_scoped
    def data_fusion(
        self,
        Niter: int = 50,
        lambdaCHEM: float = 5e-2,
        lambdaHAADF: float = 10.0,
        lambdaTV: float = 1e-4,
        iterSIRT: int = 5,
        tvIter: int = 5,
        show_convergence: bool = True,
        normalize_haadf: bool = False,
        method: str = "sirt",
        fused: bool = False,
    ):
        """Fused reconstruction loop (reconstructor.py:182-225), including
        the adaptive lambdaCHEM *= 0.95 decay on HAADF-cost increase.

        fused=True scans all Niter outer iterations (fusion step + 4D FGP
        + the adaptive decay, carried through the scan) into ONE program
        (fusion.data_fusion_run) — the pod-production shape.

        method: 'sirt' or 'sart' selects the inner HAADF solver
        (reference call_sirt_data_fusion / call_sart_data_fusion,
        multimodal.hpp:148-150; for 'sart' iterSIRT counts ordered
        full-angle passes and the reference recipe uses 1).

        Defaults mirror the reference recipe (tuned on its experimental
        datasets); on differently-scaled data the raw lambdaHAADF step can
        oscillate — set normalize_haadf=True to scale it by the HAADF-path
        Lipschitz constant (see fusion/multimodal.py)."""
        if not self.chemistry_reconstructed:
            self.chemical_tomography(
                lambdaCHEM=lambdaCHEM, show_convergence=show_convergence
            )
        self._rescale_data()

        if fused:
            from tomojax.fusion import data_fusion_run

            run = jax.jit(
                lambda x, bh, bc: data_fusion_run(
                    x, bh, bc, self.fsys, lambdaHAADF, lambdaCHEM, Niter,
                    iterSIRT, tvIter, lambdaTV,
                    reduce_lambda=self.reduceLambda,
                    normalize_haadf=normalize_haadf, method=method,
                )
            )
            self.x, metrics = run(self.x, self.b_haadf, self.b_chem)
            m = np.asarray(metrics)
            self.costHAADF, self.costCHEM, self.costTV = m[:, 0], m[:, 1], m[:, 2]
            self.reconTotal = None
            return self

        from tomojax.fusion.multimodal import tv_fgp_4d

        sart_w = None
        if method == "sart":
            from tomojax.solvers import make_sart_weights

            sart_w = make_sart_weights(self.fsys.haadf)
        fuse = jax.jit(
            lambda x, lc: data_fusion_step(
                x, self.b_haadf, self.b_chem, self.fsys,
                lambdaHAADF, lc, iterSIRT, normalize_haadf,
                method=method, sart_weights=sart_w,
            )
        )
        tvstep = jax.jit(lambda x: tv_fgp_4d(x, tvIter, lambdaTV))
        self.costHAADF = np.zeros(Niter, np.float32)
        self.costCHEM = np.zeros(Niter, np.float32)
        self.costTV = np.zeros(Niter, np.float32)
        lam_chem = lambdaCHEM
        for i in range(Niter):
            self.x, ch, cc = fuse(self.x, lam_chem)
            self.x, tv0 = tvstep(self.x)
            self.costHAADF[i], self.costCHEM[i] = float(ch), float(cc)
            self.costTV[i] = float(tv0)
            if (
                self.reduceLambda
                and i > 0
                and self.costHAADF[i] > self.costHAADF[i - 1]
            ):
                lam_chem *= 0.95
        self.reconTotal = None
        return self

    @_scoped
    def rmse_per_element(self, ground_truth) -> np.ndarray:
        x = self.x
        if self.mesh is not None:
            x = dist.unpad_slices(x, self._ns_orig, axis=1)
        return np.asarray(ops.rmse_per_element(x, jnp.asarray(ground_truth)))

    def get_recon(self) -> np.ndarray:
        """(Nel, Nslice, Nray, Nray) (reconstructor.py:238-249)."""
        if self.reconTotal is None:
            x = self.x
            if self.mesh is not None:
                x = dist.unpad_slices(x, self._ns_orig, axis=1)
            self.reconTotal = np.asarray(x)
        return self.reconTotal

    def display_recon(self, path=None):
        from tomojax import viz

        return viz.show_elements(self.get_recon(), self.elements, path=path)
