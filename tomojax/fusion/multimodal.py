"""Fused multi-modal (HAADF + chemical) tomography engine.

Batched re-design of the reference `multimodal` C++ engine
(chemistry/utils/multimodal.cpp, SURVEY.md N4/N5): the 4D reconstruction
``(Nel, Ns, N, N)`` is one sharded array; every per-slice host loop
(poisson_ml :277-304, data_fusion :452-491, per-slice Eigen sigma matvecs)
becomes a single jitted step over all slices and elements at once. The
element axis folds into the projector's batch axis, so `forward_projection4D`
(:195-210, a host loop of Nel ASTRA calls) is just FP on a reshaped batch.

Math preserved (SURVEY.md §2.4 "data fusion" row):
  per slice:   h        = sigma(x^gamma)
               g        = A_h h                       (HAADF model)
               u        = SIRT_h(h -> bh, iterSIRT)   (HAADF-consistent h)
               d_HAADF  = gamma x^(gamma-1) * sigma^T (u - h)
               Ax       = A_c x ;  d_CHEM = A_c^T((Ax - b_c)/(Ax + eps))
               x       <- clamp0( x - lamCHEM/L_Aps d_CHEM + lamHAADF d_HAADF )
  costs: ||g - bh||_F  and  sum(Ax - b_c log(Ax + eps)).
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from tomojax.geometry import Geometry
from tomojax.projector.joseph import fp, bp
from tomojax.solvers.base import System, make_system
from tomojax.solvers.iterative import (
    POISSON_EPS,
    make_sart_weights,
    sart_sweep,
    sirt_sweep,
)
from tomojax.fusion.sigma import sigma_apply, sigma_t_apply
from tomojax import tv as tvmod


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class FusionSystem:
    """Static-geometry pair + element weights + Lipschitz constants
    (multimodal.cpp:259-265 estimate_lipschitz)."""

    haadf: System
    chem: System
    weights: jnp.ndarray  # (Nel,)
    gamma: float  # static
    l_aps: jnp.ndarray  # chem-path Lipschitz
    l_asig: jnp.ndarray  # HAADF-path Lipschitz

    def tree_flatten(self):
        return (
            (self.haadf, self.chem, self.weights, self.l_aps, self.l_asig),
            self.gamma,
        )

    @classmethod
    def tree_unflatten(cls, gamma, leaves):
        h, c, w, la, ls = leaves
        return cls(h, c, w, gamma, la, ls)

    @property
    def nel(self) -> int:
        return self.weights.shape[0]


def make_fusion_system(
    n: int, haadf_angles_rad, chem_angles_rad, weights, gamma: float = 1.6
) -> FusionSystem:
    gh = Geometry.make(n, haadf_angles_rad)
    gc = Geometry.make(n, chem_angles_rad)
    sh, sc = make_system(gh), make_system(gc)
    w = jnp.asarray(weights, jnp.float32)
    # L_Aps: chem projector pair on a ones volume (multimodal.cpp:261) —
    # identical per element, so the 3D value suffices.
    l_aps = sc.lipschitz
    # L_ASig = max(sigma^T A^T A (sigma 1)) (multimodal.cpp:263-264).
    ones = jnp.ones((1, n, n), jnp.float32)
    sig1 = jnp.sum(w) * ones
    back = bp(fp(sig1, gh), gh)
    l_asig = jnp.max(w) * jnp.max(back)
    return FusionSystem(sh, sc, w, float(gamma), l_aps, l_asig)


# --------------------------------------------------------- projections ----


def fp4d(x, sys: System):
    """(Nel, Ns, N, N) -> (Nel, Ns, Na, Nt): element axis folded into the
    projector batch (replaces multimodal.cpp:195-210)."""
    nel, ns, n, _ = x.shape
    p = fp(x.reshape(nel * ns, n, n), sys.geom)
    return p.reshape(nel, ns, sys.geom.nproj, sys.geom.nray)


def bp4d(y, sys: System, n: int):
    nel, ns, na, nt = y.shape
    v = bp(y.reshape(nel * ns, na, nt), sys.geom)
    return v.reshape(nel, ns, n, n)


def model_haadf(x, fsys: FusionSystem):
    """h = sigma(x^gamma): (Nel, Ns, N, N) -> (Ns, N, N)
    (multimodal.cpp:427-428)."""
    xg = x if fsys.gamma == 1.0 else jnp.power(jnp.maximum(x, 0.0), fsys.gamma)
    return sigma_apply(fsys.weights, xg)


# ------------------------------------------------------------- solvers ----


def poisson_ml_step_4d(x, b_chem, fsys: FusionSystem, lam):
    """Chemistry-only Poisson-ML step + positivity (multimodal.cpp:277-304).

    x: (Nel, Ns, N, N); b_chem: (Nel, Ns, NaC, Nt). Returns (x, kl_cost)."""
    n = x.shape[-1]
    ax = fp4d(x, fsys.chem)
    upd = bp4d((ax - b_chem) / (ax + POISSON_EPS), fsys.chem, n)
    x = jnp.maximum(x - (lam / fsys.l_aps) * upd, 0.0)
    cost = jnp.sum(ax - b_chem * jnp.log(ax + POISSON_EPS))
    return x, cost


def chemical_sirt_sweep(x, b_chem, fsys: FusionSystem, n_iter: int = 1):
    """Per-(element, slice) SIRT on the chem geometry
    (multimodal.cpp:365-372 chemical_SIRT)."""
    nel, ns, n, _ = x.shape
    xx = x.reshape(nel * ns, n, n)
    bb = b_chem.reshape(nel * ns, fsys.chem.geom.nproj, fsys.chem.geom.nray)
    return sirt_sweep(xx, bb, fsys.chem, n_iter).reshape(x.shape)


def chemical_sart_sweep(
    x, b_chem, fsys: FusionSystem, n_iter: int = 1, sart_weights=None
):
    """Per-(element, slice) ordered SART on the chem geometry
    (multimodal.cpp:416-423 chemical_SART: ASTRA SART run(Nproj*nIter),
    sequential order, min-constraint 0). `sart_weights` = the per-angle
    inverse column sums (make_sart_weights(fsys.chem)); computed on the
    fly when omitted — precompute for repeated calls."""
    if sart_weights is None:
        sart_weights = make_sart_weights(fsys.chem)
    nel, ns, n, _ = x.shape
    xx = x.reshape(nel * ns, n, n)
    bb = b_chem.reshape(nel * ns, fsys.chem.geom.nproj, fsys.chem.geom.nray)
    for _ in range(n_iter):
        xx = sart_sweep(xx, bb, fsys.chem, sart_weights)
    return xx.reshape(x.shape)


def data_fusion_step(
    x, b_haadf, b_chem, fsys: FusionSystem, lam_haadf, lam_chem,
    iter_sirt: int = 5, normalize_haadf: bool = False,
    method: str = "sirt", sart_weights=None,
):
    """One fused HAADF+chemistry update (multimodal.cpp:452-491 with the
    SIRT/SART inner solver of :425-441 `fuse`). Returns
    (x, cost_haadf, cost_chem).

    method: 'sirt' (call_sirt_data_fusion, multimodal.hpp:148) runs
    `iter_sirt` SIRT iterations from the HAADF model h toward bh;
    'sart' (call_sart_data_fusion, :149 → multimodal.cpp:392-400) runs
    `iter_sirt` ordered sequential per-angle SART passes (ASTRA
    run(Nproj*nIter)). For 'sart' pass `sart_weights` =
    make_sart_weights(fsys.haadf) to avoid recomputing per call.

    normalize_haadf: the reference estimates the HAADF-path Lipschitz
    constant L_ASig (multimodal.cpp:263-264) but never applies it — the
    raw `lambdaHAADF * update` step (:474) can oscillate when data scales
    differ from the datasets the default lambdaHAADF=10 was tuned on.
    True divides the HAADF step by L_ASig (documented deviation; default
    False = reference-faithful)."""
    n = x.shape[-1]
    xg_pos = jnp.maximum(x, 0.0)
    h = model_haadf(x, fsys)  # (Ns, N, N)
    g = fp(h, fsys.haadf.geom)  # HAADF model projections (pre-update)
    # HAADF-consistent volume: iter_sirt inner iterations from h toward bh
    if method == "sart":
        if sart_weights is None:
            sart_weights = make_sart_weights(fsys.haadf)
        u = h
        for _ in range(iter_sirt):
            u = sart_sweep(u, b_haadf, fsys.haadf, sart_weights)
    elif method == "sirt":
        u = sirt_sweep(h, b_haadf, fsys.haadf, iter_sirt)
    else:
        raise ValueError(f"unknown fusion method {method!r}")
    diff = sigma_t_apply(fsys.weights, u - h, fsys.nel)
    if fsys.gamma == 1.0:
        d_haadf = diff
    else:
        chain = fsys.gamma * jnp.power(xg_pos, fsys.gamma - 1.0)
        d_haadf = chain * diff
    # chemistry Poisson gradient
    ax = fp4d(x, fsys.chem)
    d_chem = bp4d((ax - b_chem) / (ax + POISSON_EPS), fsys.chem, n)
    h_scale = (lam_haadf / fsys.l_asig) if normalize_haadf else lam_haadf
    x = x - (lam_chem / fsys.l_aps) * d_chem + h_scale * d_haadf
    x = jnp.maximum(x, 0.0)
    cost_haadf = jnp.sqrt(jnp.sum((g - b_haadf) ** 2))
    cost_chem = jnp.sum(ax - b_chem * jnp.log(ax + POISSON_EPS))
    return x, cost_haadf, cost_chem


def data_fusion_run(
    x, b_haadf, b_chem, fsys: FusionSystem, lam_haadf, lam_chem0,
    n_iter: int, iter_sirt: int = 5, tv_iter: int = 5, lam_tv: float = 1e-4,
    reduce_lambda: bool = True, normalize_haadf: bool = False,
    method: str = "sirt", sart_weights=None,
):
    """`n_iter` fused data-fusion outer iterations (fused step + 4D FGP +
    the adaptive lambdaCHEM *= 0.95 decay, chemistry reconstructor.py:
    206-209) as ONE scanned program — the pod-production shape of the
    fusion loop (the adaptive scalar is carried through the scan like
    make_asd_pocs_run's dPOCS). Returns (x, metrics) with metrics a
    (n_iter, 3) array of per-iteration (costHAADF, costCHEM, tv)."""
    if method == "sart" and sart_weights is None:
        sart_weights = make_sart_weights(fsys.haadf)

    def body(carry, it):
        x, lam_chem, prev_ch = carry
        x, ch, cc = data_fusion_step(
            x, b_haadf, b_chem, fsys, lam_haadf, lam_chem, iter_sirt,
            normalize_haadf, method=method, sart_weights=sart_weights,
        )
        x, tv0 = tv_fgp_4d(x, tv_iter, lam_tv)
        if reduce_lambda:
            lam_chem = jnp.where(
                (it > 0) & (ch > prev_ch), lam_chem * 0.95, lam_chem
            )
        return (x, lam_chem, ch), jnp.stack([ch, cc, tv0])

    (x, _, _), metrics = jax.lax.scan(
        body, (x, jnp.float32(lam_chem0), jnp.float32(0.0)),
        jnp.arange(n_iter),
    )
    return x, metrics


def rescale_tomograms(x, scale):
    """multimodal.cpp:307-309."""
    return x * scale


def rescale_projections(x, b_haadf, fsys: FusionSystem):
    """Per-HAADF-projection max-matching of measurements to the model
    (multimodal.cpp:312-328): bh_a <- bh_a / max(bh_a) * max(g_a)."""
    g = fp(model_haadf(x, fsys), fsys.haadf.geom)  # (Ns, NaH, Nt)
    bmax = jnp.max(b_haadf, axis=(0, 2), keepdims=True)
    gmax = jnp.max(g, axis=(0, 2), keepdims=True)
    return b_haadf / jnp.maximum(bmax, 1e-30) * gmax


def data_distance_chem(x, b_chem, fsys: FusionSystem):
    """||A_c x - b_c||_F over all elements (multimodal.cpp:213-223)."""
    return jnp.sqrt(jnp.sum((fp4d(x, fsys.chem) - b_chem) ** 2))


def tv_fgp_4d(x, n_iter: int, lam):
    return tvmod.tv_fgp_4d(x, n_iter, lam)


def tv_gd_4d(x, ng: int, dpocs):
    return tvmod.tv_gd_4d(x, ng, dpocs)
