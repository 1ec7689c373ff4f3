"""3D/4D total-variation value, subgradient descent, and FGP prox.

Batched equivalents of the reference CUDA regularizer kernels
(tomofusion/gpu/utils/regularizers/tv_gd.cu, tv_fgp.cu and the 4D
per-element wrappers in chemistry/utils/regularizers/ — SURVEY.md N9/N11).
Everything is expressed with `jnp.roll`/slicing stencils that XLA fuses;
on a z-slab-sharded volume the axis-0 shifts lower to
collective-permutes, which *is* the halo exchange the reference does by
hand with MPI_Isend/MPI_Recv (mpi_astra_ctvlib.cpp:360-386).

Semantics preserved exactly (SURVEY.md §2.5 "numerical quirks to match"):
  * TV value: isotropic, forward differences with **periodic** wrap,
    eps = 1e-6 (tv_gd.cu:27-47).
  * tv_gd: `ng` steps of  x -= dPOCS * grad / ||grad||_2  with the 4-term
    divided-difference subgradient, then positivity; returns the TV value
    of the *input* (tv_gd.cu:141-218).
  * tv_fgp: Beck-Teboulle gradient projection on the dual with the
    reference's non-standard constants: dual step 1/(26*lambda) (the paper
    uses 1/(12*lambda)), *no* dual momentum (plain GP despite the name),
    zero-gradient boundary conditions, nonnegativity clamp on the primal
    each iteration, isotropic dual-ball projection; returns the TV value
    of the *input* (tv_fgp.cu:192-281).

Known reference defects NOT replicated (documented deviation): the CUDA
gradient kernel's `ip_jm` index reduces to the center voxel because of
`(i+nx)%nx` (tv_gd.cu:73) and `jp_km`/`ip_km` read out of bounds at k=0
via `(k-1-nz)%nz` (tv_gd.cu:76-79). We implement the intended math.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

EPS_TV = 1e-6


def _roll3(x, shift, axis):
    """Periodic shift over the last three axes of x."""
    return jnp.roll(x, shift, axis=axis)


def tv(x):
    """Isotropic TV value with periodic BCs (tv_gd.cu:27-47).

    x: (..., nx, ny, nz) — reduces over the last three axes and any batch.
    """
    a = x.ndim
    ip = _roll3(x, -1, a - 3)
    jp = _roll3(x, -1, a - 2)
    kp = _roll3(x, -1, a - 1)
    t = jnp.sqrt(
        EPS_TV + (x - ip) ** 2 + (x - jp) ** 2 + (x - kp) ** 2
    )
    return jnp.sum(t)


def _tv_grad(x):
    """4-term normalized isotropic TV subgradient (tv_gd.cu:52-106).

    Uses the identity that the three "neighbor" denominators are the
    center denominator D evaluated at the shifted voxel, so the whole
    kernel is one D computation plus three rolls of it.
    """
    a = x.ndim
    ax_i, ax_j, ax_k = a - 3, a - 2, a - 1
    ip = _roll3(x, -1, ax_i)
    jp = _roll3(x, -1, ax_j)
    kp = _roll3(x, -1, ax_k)
    d = jnp.sqrt(EPS_TV + (x - ip) ** 2 + (x - jp) ** 2 + (x - kp) ** 2)
    im = _roll3(x, 1, ax_i)
    jm = _roll3(x, 1, ax_j)
    km = _roll3(x, 1, ax_k)
    g = (3.0 * x - ip - jp - kp) / d
    g = g + (x - im) / _roll3(d, 1, ax_i)
    g = g + (x - jm) / _roll3(d, 1, ax_j)
    g = g + (x - km) / _roll3(d, 1, ax_k)
    return g


def tv_gd(x, ng: int, dpocs, axis_norm=None, compat: str = "global"):
    """`ng` normalized TV-subgradient steps + positivity (tv_gd.cu:141-218).

    Returns (x_new, tv_of_input). `axis_norm` selects the axes over which
    the gradient norm is reduced; None = all axes (matches single-process
    reference; per-element 4D passes the last three).

    On a slab-sharded volume the rolls lower to halo collectives and the
    norm to a global psum (the documented deviation from the reference's
    local-norm behavior, SURVEY.md §3.3).

    compat='reference-mpi' (3D, axis_norm=None, multi-device mesh in
    scope): reproduce the reference's multi-rank semantics instead of
    the documented deviation, for trace-matching against MPI runs. In
    the reference, every slice-axis index of the TV-GD CUDA kernels is
    `(i±1+nx)%nx` with nx = the rank's LOCAL slab depth
    (tv_gd.cu:56-79 via cuda_tv_gd_3D's nx=Nslice_loc argument,
    mpi_astra_ctvlib.cpp:411), so each rank descends its slab as an
    independent periodic volume — the ghost slices exchanged once per
    call (mpi_astra_ctvlib.cpp:407-408) are never read by these
    kernels — and the per-step normalization uses the LOCAL gradient
    norm (tv_gd.cu:194-197; the MPI_Allreduce at
    mpi_astra_ctvlib.cpp:417 only sums the *returned* TV value). The
    result therefore depends on the shard count; with one shard it
    equals the default global mode.
    """
    from tomojax import config as tjconfig

    if compat == "reference-mpi":
        assert x.ndim == 3 and axis_norm is None, (
            "reference-mpi compat models the 3D multi-rank path"
        )
        mesh = tjconfig.active_mesh
        if mesh is not None and mesh.size > 1:
            assert x.shape[0] % mesh.size == 0, (x.shape, mesh.size)
            return _tv_gd_reference_mpi(x, ng, dpocs, mesh)
        # single shard: the reference's nproc==1 path is plain periodic
        # GD with the (now-global) local norm — identical to the default
    tv0 = tv(x)

    def body(_, xx):
        g = _tv_grad(xx)
        if axis_norm is None:
            nrm = jnp.sqrt(jnp.sum(g * g))
            return xx - dpocs * g / nrm
        nrm = jnp.sqrt(jnp.sum(g * g, axis=axis_norm, keepdims=True))
        return xx - dpocs * g / nrm

    x = jax.lax.fori_loop(0, ng, body, x)
    return jnp.maximum(x, 0.0), tv0


def _tv_gd_reference_mpi(x, ng: int, dpocs, mesh):
    """Reference multi-rank TV-GD (see tv_gd docstring): each z-slab
    shard runs `ng` periodic-wrap subgradient steps normalized by its
    LOCAL gradient norm, with zero cross-shard communication inside the
    descent (matching the reference, whose halo exchange is dead code
    for this kernel). Inside shard_map every jnp.roll is shard-local, so
    the body is literally the single-device stencil math on the slab.
    Returned TV value: psum of the per-slab local-periodic TVs (the
    reference allreduces the returned scalar, mpi_astra_ctvlib.cpp:417).
    """
    from jax.sharding import PartitionSpec as P

    from tomojax.dist import SLAB_AXIS

    def local(xs, dp):
        ip = _roll3(xs, -1, 0)
        jp = _roll3(xs, -1, 1)
        kp = _roll3(xs, -1, 2)
        tv0_loc = jnp.sum(
            jnp.sqrt(EPS_TV + (xs - ip) ** 2 + (xs - jp) ** 2
                     + (xs - kp) ** 2)
        )

        def body(_, xx):
            g = _tv_grad(xx)
            nrm = jnp.sqrt(jnp.sum(g * g))  # LOCAL slab norm
            return xx - dp * g / nrm

        xs = jax.lax.fori_loop(0, ng, body, xs)
        return jnp.maximum(xs, 0.0), jax.lax.psum(tv0_loc, SLAB_AXIS)

    x_new, tv0 = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(SLAB_AXIS, None, None), P()),
        out_specs=(P(SLAB_AXIS, None, None), P()),
    )(x, jnp.float32(dpocs))
    return x_new, tv0


def _fdiff(d, axis):
    """Forward difference with zero at the far boundary (tv_fgp.cu:79-88).

    Slice+concat form (no roll / scatter), which XLA fuses into the
    surrounding elementwise chain."""
    nd = d.ndim
    sl_main = [slice(None)] * nd
    sl_main[axis] = slice(0, -1)
    sl_next = [slice(None)] * nd
    sl_next[axis] = slice(1, None)
    zshape = list(d.shape)
    zshape[axis] = 1
    return jnp.concatenate(
        [d[tuple(sl_main)] - d[tuple(sl_next)], jnp.zeros(zshape, d.dtype)],
        axis=axis,
    )


def _bdiff_accum(p, axis):
    """p[i] - p[i-1] with zero below the low boundary (tv_fgp.cu:56-62)."""
    nd = p.ndim
    sl_lo = [slice(None)] * nd
    sl_lo[axis] = slice(0, 1)
    sl_main = [slice(None)] * nd
    sl_main[axis] = slice(1, None)
    sl_prev = [slice(None)] * nd
    sl_prev[axis] = slice(0, -1)
    return jnp.concatenate(
        [p[tuple(sl_lo)], p[tuple(sl_main)] - p[tuple(sl_prev)]], axis=axis
    )


def tv_fgp(x, n_iter: int, lam):
    """Reference-faithful FGP TV denoise (tv_fgp.cu:192-281).

    Returns (denoised, tv_of_input). See module docstring for the
    deliberate quirks (1/(26 lam) dual step, no momentum, nonneg clamp).

    3D or 4D (element axis first: the stencils never cross it, as in the
    reference's per-element chemistry tv_fgp.cu:192-287). Duals are f32.
    """
    a = x.ndim
    ax = (a - 3, a - 2, a - 1)
    tv0 = tv(x)
    multip = 1.0 / (26.0 * lam)

    def body(_, carry):
        d, p1, p2, p3 = carry
        # Obj: D = input - lam * div(P)   (backward-difference divergence)
        div = (
            _bdiff_accum(p1, ax[0])
            + _bdiff_accum(p2, ax[1])
            + _bdiff_accum(p3, ax[2])
        )
        d = x - lam * div
        # nonneg clamp (nonneg=1 hardcoded, tv_fgp.cu:204)
        d = jnp.maximum(d, 0.0)
        # Grad: P += multip * forward-diff(D)
        p1 = p1 + multip * _fdiff(d, ax[0])
        p2 = p2 + multip * _fdiff(d, ax[1])
        p3 = p3 + multip * _fdiff(d, ax[2])
        # isotropic dual-ball projection (tv_fgp.cu:93-115)
        denom = p1 * p1 + p2 * p2 + p3 * p3
        scale = jnp.where(denom > 1.0, jax.lax.rsqrt(denom), 1.0)
        return d, p1 * scale, p2 * scale, p3 * scale

    z = jnp.zeros_like(x)
    d, _, _, _ = jax.lax.fori_loop(0, n_iter, body, (z, z, z, z))
    return d, tv0


# ---------------------------------------------------------------------------
# 4D (multi-element chemistry) wrappers: per-element, uncoupled
# (chemistry/utils/regularizers/tv_gd.cu:208-288, tv_fgp.cu:192-287).
# ---------------------------------------------------------------------------


def tv_4d(x):
    """Summed per-element TV of (Nel, nx, ny, nz)."""
    return tv(x)  # reduction includes the element batch axis


def tv_gd_4d(x, ng: int, dpocs):
    """Per-element TV-GD: gradient norm computed per element."""
    x_new, tv0 = tv_gd(x, ng, dpocs, axis_norm=(1, 2, 3))
    return x_new, tv0


def tv_fgp_4d(x, n_iter: int, lam):
    """Per-element FGP (stencils never cross the element axis)."""
    return tv_fgp(x, n_iter, lam)
