"""FISTA(-TV) with Nesterov momentum.

Re-derivation of the reference's FISTA driver
(tomofusion/gpu/reconstructor.py:121-155 + tomoengine.cpp:350-384):
gradient step = one SIRT sweep on the momentum variable y_k (the reference
maps 'fista' to SIRT, tomofusion/pytvlib.py:27), proximal step = FGP TV
denoise, momentum t_{k+1} = (1 + sqrt(1 + 4 t_k^2))/2,
y_{k+1} = x_k + ((t_k - 1)/t_{k+1})(x_k - x_{k-1}).

Projection reuse (absent in the reference): the state
carries A yk. Because A is linear,
    A y_{k+1} = A x_k + beta (A x_k - A x_{k-1}),
so the forward projection computed for the cost metric (data distance of
x_k, reconstructor.py:152) doubles as the next gradient step's A yk — one
FP + one BP per iteration total, where the reference runs FP twice (once
inside SIRT, once in data_distance, tomoengine.cpp:189-205,410-427).
Differences vs projecting y directly are f32-rounding-level.

IMPORTANT documented deviation: in the reference, `tv_fgp` operates on the
stale `recon` buffer while the gradient step writes `yk`, and the momentum
step then overwrites `recon` with `yk` (tomoengine.cpp:381-384) — so with
momentum enabled the TV prox result is *discarded* and reference "FISTA-TV"
degenerates to momentum-accelerated SIRT. We implement the mathematically
correct algorithm by default (prox applied to the gradient-stepped
iterate); pass ``compat='reference'`` to reproduce the reference's
momentum-SIRT behavior for trace-matching.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tomojax.solvers.base import System
from tomojax import tv as tvmod
from tomojax.projector.joseph import bp, fp


class FistaState(NamedTuple):
    x: jnp.ndarray
    x_old: jnp.ndarray
    yk: jnp.ndarray
    t: jnp.ndarray  # momentum scalar
    ax: jnp.ndarray  # A x_old (the previous iterate's projections)
    ay: jnp.ndarray  # A yk


import functools


@functools.lru_cache(maxsize=16)
def _seed_fp(geom, mode, mesh, knobs):
    """Jitted seeding FP, cached per (geometry, resolved dispatch mode,
    mesh-in-scope, trace-time perf knobs) so repeated reconstructions
    don't re-trace/re-compile it (a fresh lambda per call guaranteed a
    jit cache miss). mode/mesh/knobs are cache keys only — fp reads the
    config at trace time; every config value fp's trace depends on MUST
    appear in `knobs`, else a knob change after the first call would
    silently reuse a stale-precision seed (review finding, round 3)."""
    del mesh, knobs
    return jax.jit(lambda v: fp(v, geom, mode))


def _seed_knobs(tjconfig):
    """The trace-time config values the projector dispatch reads."""
    return (tjconfig.mxu_precision,)


def _seed_projection(x0, sys: System):
    from tomojax import config as tjconfig

    return _seed_fp(
        sys.geom, tjconfig.resolve_projector_mode(), tjconfig.active_mesh,
        _seed_knobs(tjconfig),
    )(x0)


def fista_init(x0, sys: System) -> FistaState:
    """Mirror of initialize_fista (tomoengine.cpp:350-372): yk = x_old = x.

    Also projects x0 once to seed the carried A-images (see module
    docstring "Projection reuse")."""
    ax = _seed_projection(x0, sys)
    return FistaState(x=x0, x_old=x0, yk=x0, t=jnp.float32(1.0),
                      ax=ax, ay=ax)


def fista_step(
    state: FistaState,
    b,
    sys: System,
    lam,
    n_tv_iter: int = 10,
    momentum: bool = True,
    compat: str = "correct",
    compute_metrics: bool = True,
):
    """One FISTA-TV iteration. Returns (state, cost_terms).

    cost = 0.5 * dd^2 + lam * tv  (reconstructor.py:152). One FP + one BP
    per call (see module docstring); compute_metrics=False only skips the
    TV evaluation and scalar reductions."""
    geom = sys.geom
    # gradient step = 1 ASTRA-semantics SIRT iteration on yk, with the
    # carried A yk instead of a fresh forward projection. yk is ALWAYS
    # the stepped iterate (momentum=False keeps yk == x below), so the
    # carried state.ay == A yk stays valid even if `momentum` is toggled
    # between calls on the same state.
    y = state.yk
    resid = (b - state.ay) * sys.inv_row
    z = jnp.maximum(y + sys.inv_col * bp(resid, geom), 0.0)

    if compat == "reference" and momentum:
        # Reference behavior: prox discarded (see module docstring).
        x_new = z
    else:
        x_new, _ = tvmod.tv_fgp(z, n_tv_iter, lam)

    ax_new = fp(x_new, geom)
    if momentum:
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * state.t**2))
        beta = (state.t - 1.0) / t_new
        y_new = x_new + beta * (x_new - state.x_old)
        ay_new = ax_new + beta * (ax_new - state.ax)
        state = FistaState(x=x_new, x_old=x_new, yk=y_new, t=t_new,
                           ax=ax_new, ay=ay_new)
    else:
        # x_old = x_new keeps the invariant ax == A x_old, so a later
        # momentum=True call restarts momentum cleanly (beta term = 0
        # on its first step) instead of extrapolating against a stale
        # iterate whose projections were never carried.
        state = FistaState(x=x_new, x_old=x_new, yk=x_new, t=state.t,
                           ax=ax_new, ay=ax_new)

    if not compute_metrics:
        z0 = jnp.float32(0.0)
        return state, (z0, z0, z0)
    r = ax_new - b
    dd = jnp.sqrt(jnp.sum(r * r))
    tv_val = tvmod.tv(state.x)
    cost = 0.5 * dd**2 + lam * tv_val
    return state, (cost, dd, tv_val)


def fista_run(
    state: FistaState,
    b,
    sys: System,
    lam,
    n_iter: int,
    n_tv_iter: int = 10,
    momentum: bool = True,
    compat: str = "correct",
    compute_metrics: bool = True,
):
    """``n_iter`` FISTA-TV iterations as ONE traced program (lax.scan).

    Identical math to calling :func:`fista_step` ``n_iter`` times (the
    adaptive momentum scalar lives in the state, so the scan body is
    iteration-independent); returns ``(state, metrics)`` where metrics is
    a ``(n_iter, 3)`` array of per-iteration (cost, dd, tv).

    Why it exists: per-call dispatch cannot overlap the tail of one
    iteration with the head of the next, and a host loop pays one
    dispatch per iteration. This is the driver of
    ``TomoTPU.fista(fused=True)`` and of bench.py; the host loop
    (``fista_step`` per call) stays the default for interactive use.
    """

    def body(st, _):
        st, m = fista_step(
            st, b, sys, lam, n_tv_iter, momentum, compat, compute_metrics
        )
        return st, jnp.stack(m)

    return jax.lax.scan(body, state, None, length=n_iter)
