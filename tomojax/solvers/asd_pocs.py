"""ASD-POCS (adaptive steepest descent — projection onto convex sets).

Follows the reference's *working* driver loop
(tomofusion/cpu/sim_ASD.py:65-96 and examples/sim_ASD.py:67-94 — the
TomoGPU.asd_pocs method has undefined-name bugs, SURVEY.md §2.5):

  per iteration i:
    x0 = x;  x = SART(x, beta);  beta *= beta_red
    dp = ||x - x0||          (dPOCS = alpha * dp on the first iteration)
    dd = ||A x - b||
    x1 = x;  x = TV-GD(x, ng, dPOCS);  dg = ||x - x1||
    if dg > r_max * dp and dd > eps:  dPOCS *= alpha_red

The device-side iteration is a single jitted function returning the
metrics; the scalar adaptation (dPOCS, beta) stays on the host exactly
like the reference — scalars enter as traced arguments so no recompiles.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tomojax.solvers.base import System
from tomojax.solvers.iterative import sart_sweep
from tomojax.projector.joseph import fp
from tomojax import tv as tvmod


class AsdPocsParams(NamedTuple):
    """Default recipe = reference defaults (reconstructor.py:157-162)."""

    niter: int = 100
    eps: float = 0.025
    beta0: float = 0.25
    beta_red: float = 0.9985
    r_max: float = 0.95
    ng: int = 10
    alpha: float = 0.2
    alpha_red: float = 0.95


def make_asd_pocs_iteration(sys: System, inv_col_a, ng: int):
    """Build the jitted per-iteration function with ng baked in.

    Host-side adaptation variant (mirrors the reference's driver loop
    structure); used by the streaming mode. For batch reconstruction use
    `make_asd_pocs_run`, which fuses the whole adaptive loop into one
    jitted scan (no per-iteration host round trips)."""

    @jax.jit
    def run(x, b, beta, dpocs, order, first=False, alpha=0.2):
        x0 = x
        x = sart_sweep(x, b, sys, inv_col_a, beta, order)
        dp = jnp.sqrt(jnp.sum((x - x0) ** 2))
        # The reference sets dPOCS = alpha * ||dx_SART|| on the first
        # iteration BEFORE its TV step (cpu/sim_ASD.py:72-76), so the
        # first TV descent is not a no-op.
        dpocs = jnp.where(first, alpha * dp, dpocs)
        resid = fp(x, sys.geom) - b
        dd = jnp.sqrt(jnp.sum(resid * resid))
        x1 = x
        x, tv0 = tvmod.tv_gd(x, ng, dpocs)
        dg = jnp.sqrt(jnp.sum((x - x1) ** 2))
        return x, dp, dd, dg, tv0, dpocs

    return run


def make_asd_pocs_run(sys: System, inv_col_a, params: "AsdPocsParams",
                      random_order: bool = False):
    """Fully-jitted ASD-POCS: the dPOCS/beta adaptation scalars are carried
    through a lax.scan, so N iterations execute as one device program.

    The adaptation math is identical to the reference driver
    (cpu/sim_ASD.py:65-96); only its placement (device vs host) differs.
    Returns run(x, b, key) -> (x, dd_vec, tv_vec).

    NOTE: the resulting program nests scan(iterations) over scan(angles)
    over chunked matmuls and can take minutes to compile on backends with
    slow compilation services; `make_asd_pocs_iteration` + a host loop is
    numerically equivalent (tests/test_solvers.py) and compiles fast."""
    p = params
    na = sys.geom.nproj

    @jax.jit
    def run(x, b, key):
        seq = jnp.arange(na, dtype=jnp.int32)

        def body(carry, it):
            x, beta, dpocs, key = carry
            if random_order:
                key, sub = jax.random.split(key)
                order = jax.random.permutation(sub, na).astype(jnp.int32)
            else:
                order = seq
            x0 = x
            x = sart_sweep(x, b, sys, inv_col_a, beta, order)
            dp = jnp.sqrt(jnp.sum((x - x0) ** 2))
            # dPOCS initialized from the first SART step magnitude,
            # before the TV descent (cpu/sim_ASD.py:72-76).
            dpocs = jnp.where(it == 0, p.alpha * dp, dpocs)
            resid = fp(x, sys.geom) - b
            dd = jnp.sqrt(jnp.sum(resid * resid))
            x1 = x
            x, tv0 = tvmod.tv_gd(x, p.ng, dpocs)
            dg = jnp.sqrt(jnp.sum((x - x1) ** 2))
            beta = beta * p.beta_red
            dpocs = jnp.where(
                (dg > p.r_max * dp) & (dd > p.eps), dpocs * p.alpha_red, dpocs
            )
            return (x, beta, dpocs, key), (dd, tv0)

        (x, _, _, _), (dd_vec, tv_vec) = jax.lax.scan(
            body,
            (x, jnp.float32(p.beta0), jnp.float32(0.0), key),
            jnp.arange(p.niter),
        )
        return x, dd_vec, tv_vec

    return run
